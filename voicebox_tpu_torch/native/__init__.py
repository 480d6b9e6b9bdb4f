"""ctypes bindings for the native WAV and FLAC decoders (`wavio.cpp`,
`flacio.cpp`).

Counterpart of `voicebox_tpu/native/__init__.py`, with the same functions
and return values: `None` where a file cannot be read or the library cannot
be built, so callers fall back to a pure-Python decoder. The C++ sources
are the port's own copies. Each library is built with g++ at its first use,
never at import, into `native/` under the kernels' build directory
(`kernels.BUILD_DIR`, `build/kernels/` at the root of the checkout, moved by
`kernels.set_build_dir`), its file name keyed by `kernels.source_digest` of
the source and by the g++ flags, so an edited source rebuilds and nothing
is written into the package. The ctypes calls release the GIL, so a
prefetch thread's decode overlaps the device's work.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from .. import kernels

__all__ = [
    "native_available", "wav_read", "wav_read_batch", "wav_info",
    "flac_available", "flac_read", "flac_info",
]

_HERE = Path(__file__).resolve().parent
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
# source stem -> (library stem, extra link flags)
_LIBS = {"wavio": ("vbwavio", ("-lpthread",)), "flacio": ("vbflac", ())}
_loaded: dict = {}  # (source stem, build directory) -> CDLL or None


def library_path(name: str) -> Path:
    """Where the library of `<name>.cpp` is (or will be) built: under the
    current build directory, keyed by its source and flags."""
    stem, link = _LIBS[name]
    key = hashlib.sha256(
        (kernels.source_digest(_HERE / f"{name}.cpp") + "\0" + "\0".join(GXX_FLAGS + link))
        .encode()).hexdigest()[:16]
    return Path(kernels.BUILD_DIR) / "native" / f"lib{stem}_{key}.so"


def _build(name: str) -> Path:
    lib = library_path(name)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(_HERE / f"{name}.cpp"), "-o", str(tmp),
                        *_LIBS[name][1]], check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    finally:
        tmp.unlink(missing_ok=True)
    return lib


def _load(name: str):
    """The library of `<name>.cpp`, built if needed, once per process and
    build directory; None if it cannot be built or loaded."""
    slot = (name, str(kernels.BUILD_DIR))
    if slot in _loaded:
        return _loaded[slot]
    try:
        lib = ctypes.CDLL(str(_build(name)))
        if name == "wavio":
            lib.vb_wav_info.restype = ctypes.c_longlong
            lib.vb_wav_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
            lib.vb_wav_read.restype = ctypes.c_longlong
            lib.vb_wav_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                        ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)]
            lib.vb_wav_read_batch.restype = ctypes.c_int
            lib.vb_wav_read_batch.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
        else:
            lib.vb_flac_info.restype = ctypes.c_longlong
            lib.vb_flac_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                         ctypes.POINTER(ctypes.c_int)]
            lib.vb_flac_read.restype = ctypes.c_longlong
            lib.vb_flac_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                         ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)]
    except Exception:
        lib = None
    _loaded[slot] = lib
    return lib


def _floats(buf: np.ndarray):
    return buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def native_available() -> bool:
    return _load("wavio") is not None


def wav_info(path) -> Optional[Tuple[int, int]]:
    """-> (n_samples, sample_rate) or None."""
    lib = _load("wavio")
    if lib is None:
        return None
    sr = ctypes.c_int(0)
    n = lib.vb_wav_info(str(path).encode(), ctypes.byref(sr))
    if n < 0:
        return None
    return int(n), int(sr.value)


def wav_read(path) -> Optional[Tuple[np.ndarray, int]]:
    """Decode one wav -> (float32 mono wave, sample_rate) or None."""
    lib = _load("wavio")
    if lib is None:
        return None
    info = wav_info(path)
    if info is None:
        return None
    n, _ = info
    buf = np.empty(n, dtype=np.float32)
    sr = ctypes.c_int(0)
    got = lib.vb_wav_read(str(path).encode(), _floats(buf), n, ctypes.byref(sr))
    if got < 0:
        return None
    return buf[:got], int(sr.value)


def wav_read_batch(paths: List, max_samples: int,
                   num_threads: int = 0) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Threaded batch decode -> (batch (n, max_samples) float32 zero-padded,
    lengths (n,) int64 with -1 for failures), or None if the library is
    unavailable."""
    lib = _load("wavio")
    if lib is None:
        return None
    n = len(paths)
    joined = b"\0".join(str(p).encode() for p in paths) + b"\0"
    out = np.zeros((n, max_samples), dtype=np.float32)
    lengths = np.zeros(n, dtype=np.int64)
    lib.vb_wav_read_batch(joined, n, _floats(out), max_samples,
                          lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), num_threads)
    return out, lengths


def flac_available() -> bool:
    return _load("flacio") is not None


def flac_info(path) -> Optional[Tuple[int, int]]:
    """-> (n_samples, sample_rate) from STREAMINFO (header only), or None,
    also for streams that do not declare their length."""
    lib = _load("flacio")
    if lib is None:
        return None
    sr, ch = ctypes.c_int(0), ctypes.c_int(0)
    n = lib.vb_flac_info(str(path).encode(), ctypes.byref(sr), ctypes.byref(ch))
    if n < 0:
        return None
    return int(n), int(sr.value)


def flac_read(path) -> Optional[Tuple[np.ndarray, int]]:
    """Decode one flac -> (float32 mono wave, sample_rate) or None."""
    lib = _load("flacio")
    if lib is None:
        return None
    info = flac_info(path)
    declared = info is not None
    if declared:
        cap = info[0]
    else:
        # no declared length: start from 4x the compressed size and, since
        # FLAC compresses constant audio past any fixed factor, grow and
        # decode again while the result fills the buffer (got == cap may be
        # a decode cut at the buffer's edge)
        try:
            cap = max(os.path.getsize(str(path)) * 4, 1 << 16)
        except OSError:
            return None
    while True:
        if cap > (1 << 31):
            # > 2^31 samples (24+ hours mono at 24 kHz): most likely a corrupt
            # stream; undecodable rather than exhausting host memory
            return None
        try:
            buf = np.empty(int(cap), dtype=np.float32)
        except MemoryError:
            return None
        sr = ctypes.c_int(0)
        got = lib.vb_flac_read(str(path).encode(), _floats(buf), int(cap), ctypes.byref(sr))
        if got < 0:
            return None
        if declared or got < cap:
            return buf[:got], int(sr.value)
        cap *= 4
