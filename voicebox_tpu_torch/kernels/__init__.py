"""Build and load the port's hand-written CUDA kernels.

Each kernel is one `.cu` file under `voicebox_tpu_torch/csrc/` with a plain C
entry point. At first use it is compiled with nvcc for `sm_90a` into a shared
library under `build/kernels/` at the root of the checkout (`set_build_dir`
moves it for the process) and loaded with ctypes. The library's file name
carries a hash of the source, of the headers it includes (`#include "..."`,
found beside it) and of the flags, so an edited source or header never
loads a stale library. Nothing is built or loaded
when this module is imported: the CPU tests import every module, and a
machine without nvcc never reaches a build.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "load", "set_build_dir", "source_digest"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in the .log
)


def set_build_dir(path) -> Path:
    """Build and look up the kernel libraries under `path` (created at the
    first build) for the rest of the process, so that they persist where
    the caller keeps them: `TTSEngine(compilation_cache_dir=...)`. A library
    this process already loaded stays loaded."""
    global BUILD_DIR
    BUILD_DIR = Path(path).expanduser().resolve()
    return BUILD_DIR


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found on PATH, in $CUDA_HOME or $CUDA_PATH: the CUDA "
            "kernels are built from source at first use"
        )
    return str(path)


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.MULTILINE)


def source_digest(src: Path) -> str:
    """The key of a kernel library: a hash of the source, of every header it
    includes with quotes (resolved beside the including file, recursively,
    each once) and of the nvcc flags."""
    h = hashlib.sha256()
    seen = set()

    def add(path: Path) -> None:
        if path in seen:
            return
        seen.add(path)
        data = path.read_bytes()
        h.update(path.name.encode() + b"\0" + data + b"\0")
        for inc in _INCLUDE.findall(data):
            add((path.parent / inc.decode()).resolve())

    add(Path(src).resolve())
    h.update("\0".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless a library of the same source, headers
    and flags exists; returns the library's path. The compiler's report
    (ptxas -v) is written beside it as `<library>.log`."""
    src = _CSRC / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}_{source_digest(src)}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    Path(f"{lib}.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, once per process."""
    return ctypes.CDLL(str(build(name)))
