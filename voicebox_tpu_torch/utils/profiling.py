"""Device-trace attribution: turn a `torch.profiler` trace into device time
by category and per-kernel tables.

Counterpart of `voicebox_tpu/utils/profiling.py`, which reads a
`jax.profiler` trace by HLO category. Here the trace is the chrome trace
that `torch.profiler` exports (`VoiceBoxTrainer(profile_dir=...)` writes one
for its `profile_steps` window, `prof.export_chrome_trace` any other), and
the device's events are its kernel, memcpy and memset events. The ranges
`record_function` puts on the device's timeline (`gpu_user_annotation`) and
every host event are left out: they would count device time twice, or
host time as the device's.

Categories: the port's own kernels by their entry names (K1 `flash_fwd`,
K2 `flash_bwd_dq`, K3 `flash_bwd_dkv`, K4 `w8a16`), then by the library
kernel's name: convolution, GEMM (cuBLAS, CUTLASS), FFT, reduction,
copy (memcpy, memset, copy kernels), elementwise, and other.

    from voicebox_tpu_torch.utils.profiling import parse_device_trace, format_attribution
    cats, ops = parse_device_trace("results/trace")
    print(format_attribution(cats, ops, steps=5))

`kernel_summary` is the interval union of device events that gives a
window's busy time and idle share, shared with `chip_smoke.py`'s profiles.
"""

from __future__ import annotations

import gzip
import json
import math
import re
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

__all__ = ["CATEGORIES", "OpStats", "category", "format_attribution", "interval_union",
           "kernel_summary", "parse_device_trace"]

# (category, pattern of the kernel's name), first match wins: the port's
# kernels, then the libraries' kernels by the words their names carry
_RULES = (
    ("K1", re.compile(r"flash_fwd")),
    ("K2", re.compile(r"flash_bwd_dq")),
    ("K3", re.compile(r"flash_bwd_dkv")),
    ("K4", re.compile(r"w8a16")),
    ("convolution", re.compile(r"conv|fprop|dgrad|wgrad|winograd", re.I)),
    ("GEMM", re.compile(r"gemm|gemv|xmma|cutlass|dot_kernel|splitk|matmul", re.I)),
    ("FFT", re.compile(r"fft", re.I)),
    ("reduction", re.compile(r"reduce|softmax|layer_norm|group_norm|batch_norm|scan|argm|"
                             r"topk|sort|cumsum", re.I)),
    ("copy", re.compile(r"copy|memcpy|memset|cat_array|catarray", re.I)),
    ("elementwise", re.compile(r"elementwise|foreach|fill|index|scatter|gather|where", re.I)),
)
CATEGORIES = tuple(c for c, _ in _RULES) + ("other",)
# the chrome trace's device events: kernels, copies and memsets
_DEVICE_CATS = {"kernel": None, "gpu_memcpy": "copy", "gpu_memset": "copy"}


@dataclass
class OpStats:
    """Device time of one kernel (by name) over the trace."""

    duration_ms: float = 0.0
    calls: int = 0
    category: str = "other"
    bytes_moved: Optional[float] = None  # per call, where the trace gives it (copies)

    @property
    def gbytes_per_s(self) -> Optional[float]:
        if not self.bytes_moved or not self.duration_ms:
            return None
        return self.bytes_moved * self.calls / (self.duration_ms / 1e3) / 1e9


def category(name: str) -> str:
    """The category of a device kernel, from its name."""
    for cat, pattern in _RULES:
        if pattern.search(name):
            return cat
    return "other"


def interval_union(spans: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by (start, end) intervals: device busy time,
    where kernels on several streams overlap."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def kernel_summary(kernels, wall_us: float, top: int = 8) -> dict:
    """A window's device activity from its device events `kernels`, each
    (name, start_us, end_us), and the window's host wall time: wall and busy
    ms (the union of the events' intervals), the idle share 1 - busy / wall
    (None without events), the number of events, the device ms of K1 + K2 +
    K3 and of K4 and K4's launches, and the `top` kernels by device time as
    (name[:60], ms, calls)."""
    kernels = list(kernels)
    busy = interval_union((a, b) for _, a, b in kernels)
    by_name: Dict[str, Tuple[float, int]] = {}
    for name, a, b in kernels:
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + b - a, n + 1)
    cats = defaultdict(lambda: [0.0, 0])
    for name, (t, n) in by_name.items():
        c = cats[category(name)]
        c[0] += t
        c[1] += n
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3, "kernels": len(kernels),
            "attention_ms": sum(cats[k][0] for k in ("K1", "K2", "K3")) / 1e3,
            "k4_ms": cats["K4"][0] / 1e3, "k4_kernels": cats["K4"][1],
            "idle": 1.0 - busy / wall_us if kernels else None,
            "top": [(name[:60], t / 1e3, n) for name, (t, n) in ranked]}


def _newest_trace(trace_dir) -> Path:
    root = Path(trace_dir)
    paths = [p for pattern in ("*.json", "*.json.gz") for p in root.rglob(pattern)]
    if not paths:
        raise FileNotFoundError(f"no *.json or *.json.gz trace under {trace_dir}")
    return max(paths, key=lambda p: (p.stat().st_mtime, str(p)))


def parse_device_trace(trace_dir) -> Tuple[Dict[str, float], Dict[str, OpStats]]:
    """Parse the newest chrome trace (`*.json` or `*.json.gz`) under
    `trace_dir`. Returns (category -> total device ms, kernel name ->
    OpStats). Raises ValueError when the trace holds no device event."""
    path = _newest_trace(trace_dir)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        data = json.load(f)
    events = data.get("traceEvents", []) if isinstance(data, dict) else data

    cats: Dict[str, float] = defaultdict(float)
    ops: Dict[str, OpStats] = defaultdict(OpStats)
    for e in events:
        kind = str(e.get("cat", "")).lower()
        if e.get("ph") != "X" or kind not in _DEVICE_CATS:
            continue
        name = str(e.get("name", "?"))
        cat = _DEVICE_CATS[kind] or category(name)
        dur_ms = float(e.get("dur", 0)) / 1e3
        cats[cat] += dur_ms
        st = ops[name]
        st.duration_ms += dur_ms
        st.calls += 1
        st.category = cat
        moved = e.get("args", {}).get("bytes")
        if st.bytes_moved is None and isinstance(moved, (int, float)):
            st.bytes_moved = float(moved)
    if not ops:
        raise ValueError(
            f"{path} has no device kernel, memcpy or memset events: a trace records them "
            "only when it was captured with CUDA activity on a card (a CPU run records host "
            "events only); capture with the trainer's profile_dir on the card"
        )
    return dict(cats), dict(ops)


def format_attribution(
    cats: Dict[str, float],
    ops: Dict[str, OpStats],
    steps: int = 1,
    top: int = 20,
) -> str:
    """Render device time by category and the top kernels; `steps` divides
    totals into per-step numbers (pass the steps the trace window
    covered)."""
    total = sum(cats.values()) or 1.0
    lines = [f"device time by category ({total / steps:.3f} ms/step):"]
    for c, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        if ms / total < 0.001:
            continue
        lines.append(f"  {c:32s} {ms / steps:8.3f} ms/step  {100 * ms / total:5.1f}%")
    lines.append(f"top {top} kernels by device time:")
    for name, st in sorted(ops.items(), key=lambda kv: -kv[1].duration_ms)[:top]:
        extra = f"  {st.gbytes_per_s:5.0f} GB/s" if st.gbytes_per_s else ""
        lines.append(
            f"  {st.duration_ms / steps:8.3f} ms/step x{st.calls:4d}  [{st.category}]"
            f"  {name[:60]:60s}{extra}"
        )
    return "\n".join(lines)
