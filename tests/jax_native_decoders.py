"""The JAX package's native WAV and FLAC decoders, made to load in this
test process whatever its own loader did.

`voicebox_tpu.native` builds `libvbwavio.so` and `libvbflac.so` with g++
into the package itself at first use, straight to their final names, and
remembers a failed load for the life of the process. When several pytest
workers start that build at once, a worker that opens a half-written
library gives up for good, and every comparison of the port's decoders
against the JAX package's then compares against None.

`jax_native_decoders(build_dir)` is a context manager for the port's tests
that compare against those decoders: where the JAX loader gave up in this
process, it builds the JAX package's own C++ source with the loader's own
g++ flags into `build_dir` (a private directory), under a temporary name
renamed into place, points the loader at that library, and restores the
loader's state on exit. If even that gives no library it fails the test;
it never skips. The JAX package itself is not touched.
"""

import contextlib
import os
import subprocess
from pathlib import Path

import pytest

from voicebox_tpu import native as jnative

# (check, source, library name, extra g++ flags, the loader's state: library
# path, tried flag, library handle); the flags are the JAX loader's own
# (`voicebox_tpu/native/__init__.py::_build` and `_load_flac`)
_DECODERS = (
    ("native_available", "_SRC", "libvbwavio.so", ["-lpthread"], "_LIB_PATH", "_tried", "_lib"),
    ("flac_available", "_FLAC_SRC", "libvbflac.so", [], "_FLAC_LIB_PATH", "_flac_tried",
     "_flac_lib"),
)


def build_library(src: Path, out: Path, extra=(), cxx: str = "g++") -> Path:
    """`src` compiled as the JAX loader compiles it, written to a temporary
    name beside `out` and renamed to `out`, so that no reader ever opens a
    half-written file. Fails the test (never skips) when the build does."""
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, "-O3", "-shared", "-fPIC", "-std=c++17", str(src), "-o", str(tmp), *extra]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as exc:
        detail = getattr(exc, "stderr", b"") or b""
        pytest.fail(f"building the JAX package's {src.name} failed: {exc}\n"
                    f"{detail.decode(errors='replace')[-2000:]}")
    os.replace(tmp, out)
    return out


@contextlib.contextmanager
def jax_native_decoders(build_dir: Path, cxx: str = "g++", sources=None):
    """Inside the block, `voicebox_tpu.native` decodes WAV and FLAC with the
    JAX package's own C++ source. `sources` maps a source attribute name
    (`_SRC`, `_FLAC_SRC`) to another file to build in its place (the tests
    of this fixture plant a broken one)."""
    sources = sources or {}
    build_dir = Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    with pytest.MonkeyPatch.context() as mp:
        for check, src_attr, name, extra, path_attr, tried_attr, lib_attr in _DECODERS:
            if src_attr not in sources and getattr(jnative, check)():
                continue  # the JAX loader has its library in this process
            src = Path(sources.get(src_attr, getattr(jnative, src_attr)))
            lib = build_library(src, build_dir / name, extra, cxx)
            mp.setattr(jnative, path_attr, lib)
            mp.setattr(jnative, tried_attr, False)
            mp.setattr(jnative, lib_attr, None)
            if not getattr(jnative, check)():
                pytest.fail(f"the JAX package's {name}, built at {lib}, does not load")
        yield
