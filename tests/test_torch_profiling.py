"""`utils/profiling.py` on chrome traces written to tmp_path in the format
`torch.profiler`'s `export_chrome_trace` writes (device events: kernel,
gpu_memcpy and gpu_memset complete events; the rest host events,
record_function ranges on either timeline, flows and metadata):

* categories: K1-K4 by the port's kernel entry names, the libraries'
  kernels by name, copies; host events and annotation ranges left out;
* per-kernel calls and totals, bytes of copies, the newest of several
  traces, a gzipped trace;
* `format_attribution`'s rendering per step;
* `kernel_summary`'s interval union, idle share and K1-K4 sums;
* a missing trace raises FileNotFoundError, a trace without device events
  (a torch.profiler run on the CPU) ValueError.
"""

import gzip
import json
import os

import pytest
import torch

from voicebox_tpu_torch.utils.profiling import (
    CATEGORIES,
    category,
    format_attribution,
    interval_union,
    kernel_summary,
    parse_device_trace,
)

# (name, chrome category, duration us, expected category)
DEVICE = [
    ("void (anonymous namespace)::flash_fwd_f32<32>(float const*, float const*)", "kernel",
     10.0, "K1"),
    ("void (anonymous namespace)::flash_fwd_bf16<128, 2>(CUtensorMap_st)", "kernel", 20.0, "K1"),
    ("void (anonymous namespace)::flash_bwd_dq_f32<16>(float const*)", "kernel", 30.0, "K2"),
    ("void (anonymous namespace)::flash_bwd_dkv_bf16<64>(CUtensorMap_st)", "kernel", 40.0, "K3"),
    ("void (anonymous namespace)::w8a16_f32_gemv<4>(float const*, signed char const*)",
     "kernel", 5.0, "K4"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32", "kernel", 50.0, "GEMM"),
    ("void gemv2T_kernel_val<int, int, float, float, float>", "kernel", 6.0, "GEMM"),
    ("void cudnn::cnn::implicit_convolve_sgemm<float, float, 1024>", "kernel", 7.0,
     "convolution"),
    ("void regular_fft<512u, EPT_8, 64u, 8u>(unsigned int)", "kernel", 8.0, "FFT"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>", "kernel", 9.0,
     "reduction"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float>>",
     "kernel", 11.0, "elementwise"),
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda>",
     "kernel", 12.0, "copy"),
    ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 13.0, "copy"),
    ("Memset (Device)", "gpu_memset", 1.0, "copy"),
    ("void some_custom_kernel<1>()", "kernel", 2.0, "other"),
]
# host events and ranges: none of them is device time
HOST = [
    ("aten::mm", "cpu_op"), ("cudaLaunchKernel", "cuda_runtime"),
    ("Optimizer.step#Adam.step", "user_annotation"),
    ("Optimizer.step#Adam.step", "gpu_user_annotation"),
    ("forward", "python_function"),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trace(device=DEVICE, host=HOST, repeat=2):
    events = [{"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}}]
    ts = 1000.0
    for _ in range(repeat):
        for name, cat, dur, _ in device:
            e = {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": dur,
                 "args": {"device": 0, "stream": 7}}
            if cat == "gpu_memcpy":
                e["args"]["bytes"] = 4096
            events.append(e)
            ts += dur + 1.0
        for name, cat in host:
            events.append({"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 1, "ts": ts,
                           "dur": 500.0, "args": {}})
    events.append({"ph": "f", "cat": "ac2g", "name": "flow", "pid": 0, "tid": 7, "ts": ts,
                   "id": 1})
    return {"schemaVersion": 1, "traceEvents": events}


def _write(path, trace, gz=False):
    path.parent.mkdir(parents=True, exist_ok=True)
    if gz:
        with gzip.open(path, "wt") as f:
            json.dump(trace, f)
    else:
        path.write_text(json.dumps(trace))
    return path


def test_categories_and_exclusions(tmp_path):
    _write(tmp_path / "trace_10_15.json", _trace())
    cats, ops = parse_device_trace(tmp_path)
    assert set(cats) <= set(CATEGORIES)
    want = {}
    for name, _, dur, cat in DEVICE:
        assert category(name) == cat or cat == "copy", name
        want[cat] = want.get(cat, 0.0) + 2 * dur / 1e3
    assert cats.keys() == want.keys()
    for cat, ms in want.items():
        assert cats[cat] == pytest.approx(ms), cat
    # host events and annotation ranges are not device ops
    assert not any(name in ops for name, _ in HOST)
    assert len(ops) == len(DEVICE)


def test_per_kernel_calls_totals_and_bytes(tmp_path):
    _write(tmp_path / "run" / "trace.json", _trace(repeat=3))
    _, ops = parse_device_trace(tmp_path)
    for name, _, dur, cat in DEVICE:
        st = ops[name]
        assert st.calls == 3 and st.duration_ms == pytest.approx(3 * dur / 1e3)
        assert st.category == cat
    copy = ops["Memcpy HtoD (Pageable -> Device)"]
    assert copy.bytes_moved == 4096
    assert copy.gbytes_per_s == pytest.approx(3 * 4096 / (3 * 13e-6) / 1e9)
    assert ops["void some_custom_kernel<1>()"].gbytes_per_s is None


def test_newest_trace_and_gzip(tmp_path):
    old = _write(tmp_path / "a" / "trace_old.json", _trace(device=DEVICE[:1]))
    new = _write(tmp_path / "b" / "trace_new.json.gz", _trace(device=DEVICE[4:5]), gz=True)
    os.utime(old, (1_000_000, 1_000_000))
    os.utime(new, (2_000_000, 2_000_000))
    cats, ops = parse_device_trace(tmp_path)
    assert list(cats) == ["K4"] and list(ops) == [DEVICE[4][0]]


def test_format_attribution_per_step(tmp_path):
    _write(tmp_path / "t.json", _trace(repeat=4))
    cats, ops = parse_device_trace(tmp_path)
    text = format_attribution(cats, ops, steps=4, top=3)
    lines = text.splitlines()
    total = sum(d for _, _, d, _ in DEVICE) / 1e3
    assert lines[0] == f"device time by category ({total:.3f} ms/step):"
    shown = [line.split()[0] for line in lines[1:lines.index("top 3 kernels by device time:")]]
    assert shown == [c for c, _ in sorted(cats.items(), key=lambda kv: -kv[1])]
    assert "GEMM" in lines[1]  # the largest category first: 56 us a step
    top = lines[lines.index("top 3 kernels by device time:") + 1:]
    assert len(top) == 3 and "x   4" in top[0] and "[GEMM]" in top[0]
    assert "0.050 ms/step" in top[0]


def test_kernel_summary_interval_union():
    assert interval_union([(0.0, 10.0), (5.0, 12.0), (20.0, 25.0), (21.0, 22.0)]) == 17.0
    assert interval_union([]) == 0.0
    kernels = [("void flash_fwd_f32<16>", 0.0, 10.0), ("void flash_bwd_dq_f32<16>", 5.0, 12.0),
               ("w8a16_f32_gemv<4>", 20.0, 25.0), ("w8a16_f32_gemv<4>", 30.0, 31.0),
               ("gemm_kernel", 30.0, 40.0)]
    s = kernel_summary(kernels, wall_us=100.0, top=2)
    assert s["busy_ms"] == pytest.approx(0.027) and s["wall_ms"] == pytest.approx(0.1)
    assert s["idle"] == pytest.approx(0.73) and s["kernels"] == 5
    assert s["attention_ms"] == pytest.approx(0.017)
    assert s["k4_ms"] == pytest.approx(0.006) and s["k4_kernels"] == 2
    assert s["top"] == [("void flash_fwd_f32<16>", pytest.approx(0.01), 1),
                        ("gemm_kernel", pytest.approx(0.01), 1)]
    assert kernel_summary([], wall_us=50.0)["idle"] is None


def test_missing_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no \\*.json"):
        parse_device_trace(tmp_path)


def test_trace_without_device_events_raises(tmp_path):
    _write(tmp_path / "host_only.json", _trace(device=[]))
    with pytest.raises(ValueError, match="no device kernel"):
        parse_device_trace(tmp_path)


def test_cpu_profiler_trace_raises(tmp_path):
    """A real torch.profiler trace of a CPU run holds host events only."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    prof.export_chrome_trace(str(tmp_path / "cpu.json"))
    with pytest.raises(ValueError, match="no device kernel"):
        parse_device_trace(tmp_path)
