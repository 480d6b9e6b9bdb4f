"""The port's native WAV and FLAC decoders (`voicebox_tpu_torch/native`)
against the JAX package's (`voicebox_tpu.native`) on the same files: the
same arrays bit for bit and the same rates, for WAV at int16, int32, uint8
and float32 and stereo averaged to mono, and for FLAC (written by
`flac_ref_encoder.write_flac`) at 16 and 24 bits, mono and stereo, at two
block sizes and without a declared length; the same header reads, batch
reads, and outcomes on truncated and corrupt files. The port's library is
built under the kernels' build directory, never into the package.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from flac_ref_encoder import write_flac
from jax_native_decoders import jax_native_decoders
from voicebox_tpu import native as jnative
from voicebox_tpu_torch import kernels
from voicebox_tpu_torch import native

PACKAGE = Path(native.__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _jax_decoders(tmp_path_factory):
    """The JAX package's decoders load in this worker even where its own
    in-package build lost a race with another worker's
    (`jax_native_decoders`)."""
    with jax_native_decoders(tmp_path_factory.mktemp("jax_native")):
        yield


def _sig(n, seed=0, amp=3000.0, bps=16):
    """A sine under small integer noise, within the bit depth's range."""
    rs = np.random.RandomState(seed)
    x = amp * np.sin(np.arange(n) / 17.0) + rs.randint(-40, 41, size=n)
    lim = 2 ** (bps - 1) - 1
    return np.clip(np.round(x), -lim - 1, lim).astype(np.int64)


def _wav(path, kind):
    n, sr = 1500, 16000
    s = _sig(n, seed=len(kind))
    data = {
        "int16": s.astype(np.int16),
        "int32": (s * 65536 + 1234).astype(np.int32),
        "uint8": (s // 256 + 128).astype(np.uint8),
        "float32": (s / 32768.0).astype(np.float32),
        "stereo": np.stack([s, _sig(n, seed=99)], axis=1).astype(np.int16),
    }[kind]
    wavfile.write(path, sr, data)


WAV_KINDS = ("int16", "int32", "uint8", "float32", "stereo")
# (bits, channels, block size, declared length)
FLAC_KINDS = [(bps, ch, block, True) for bps in (16, 24) for ch in (1, 2) for block in (512, 4096)]
FLAC_KINDS.append((16, 1, 550, False))


def _flac(path, bps, ch, block, declared):
    amp = 3000.0 if bps == 16 else 3e5
    channels = np.stack([_sig(5000, seed=c, amp=amp, bps=bps) for c in range(ch)])
    write_flac(path, channels, 24000, bps=bps, block_size=block, declare_total=declared)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    out = {}
    for kind in WAV_KINDS:
        out[kind] = d / f"{kind}.wav"
        _wav(out[kind], kind)
    for spec in FLAC_KINDS:
        out[spec] = d / ("flac_%d_%d_%d_%d.flac" % spec)
        _flac(out[spec], *spec)
    return out


def _same(ours, ref):
    assert (ours is None) == (ref is None)
    if ref is not None:
        (w, sr), (jw, jsr) = ours, ref
        assert w.dtype == jw.dtype == np.float32 and sr == jsr
        np.testing.assert_array_equal(w, jw)


def test_native_libraries_build():
    assert native.native_available() and native.flac_available()
    assert jnative.native_available() and jnative.flac_available()


@pytest.mark.parametrize("kind", WAV_KINDS)
def test_wav_read_matches_jax(files, kind):
    path = files[kind]
    _same(native.wav_read(path), jnative.wav_read(path))
    assert native.wav_info(path) == jnative.wav_info(path) == (1500, 16000)
    if kind == "int16":  # and the samples written, exactly
        np.testing.assert_array_equal(native.wav_read(path)[0],
                                      _sig(1500, seed=5).astype(np.float32) / 32768.0)


@pytest.mark.parametrize("spec", FLAC_KINDS, ids=lambda s: "bps%d_ch%d_block%d_%s" % (
    s[0], s[1], s[2], "declared" if s[3] else "undeclared"))
def test_flac_read_matches_jax(files, spec):
    path = files[spec]
    ours = native.flac_read(path)
    _same(ours, jnative.flac_read(path))
    assert native.flac_info(path) == jnative.flac_info(path)
    assert native.flac_info(path) == ((5000, 24000) if spec[3] else None)
    assert len(ours[0]) == 5000


def test_wav_read_batch_matches_jax(files, tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav at all")
    paths = [files[k] for k in WAV_KINDS] + [bad]
    ours, ref = native.wav_read_batch(paths, 2000, 2), jnative.wav_read_batch(paths, 2000, 2)
    np.testing.assert_array_equal(ours[0], ref[0])
    np.testing.assert_array_equal(ours[1], ref[1])
    assert ours[1].tolist() == [1500] * 5 + [-1]


@pytest.mark.parametrize("suffix", [".wav", ".flac"])
@pytest.mark.parametrize("damage", ["truncated", "corrupt"])
def test_damaged_files_give_the_jax_outcome(files, tmp_path, suffix, damage):
    src = files["int16"] if suffix == ".wav" else files[(16, 2, 512, True)]
    data = src.read_bytes()
    path = tmp_path / f"damaged{suffix}"
    if damage == "truncated":
        path.write_bytes(data[: len(data) // 2])
    else:  # the header kept, the body overwritten
        path.write_bytes(data[:4] + bytes(range(256)) * 4)
    if suffix == ".wav":
        _same(native.wav_read(path), jnative.wav_read(path))
        assert native.wav_info(path) == jnative.wav_info(path)
    else:
        _same(native.flac_read(path), jnative.flac_read(path))
        assert native.flac_info(path) == jnative.flac_info(path)


def test_library_lands_under_the_build_directory(tmp_path, monkeypatch):
    before = sorted(p.relative_to(PACKAGE) for p in PACKAGE.rglob("*")
                    if "__pycache__" not in p.parts)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "kernels")
    for name in ("wavio", "flacio"):
        lib = native.library_path(name)
        assert lib.parent == tmp_path / "kernels" / "native"
        assert native._load(name) is not None and lib.exists()
    # an edited source is another library
    monkeypatch.setattr(native, "_HERE", tmp_path / "src")
    (tmp_path / "src").mkdir()
    shutil.copy(PACKAGE / "native" / "wavio.cpp", tmp_path / "src" / "wavio.cpp")
    same = native.library_path("wavio")
    with open(tmp_path / "src" / "wavio.cpp", "a") as f:
        f.write("\n// edited\n")
    assert native.library_path("wavio") != same
    after = sorted(p.relative_to(PACKAGE) for p in PACKAGE.rglob("*")
                   if "__pycache__" not in p.parts)
    assert after == before


def test_fixture_decodes_where_the_jax_loader_gave_up(files, tmp_path, monkeypatch):
    """The fault planted: the JAX loader has given up on its FLAC library in
    this process. Through the fixture's route the JAX package's own source
    still decodes every FLAC kind, bit for bit the samples written and the
    port's decoder's output."""
    monkeypatch.setattr(jnative, "_flac_tried", True)
    monkeypatch.setattr(jnative, "_flac_lib", None)
    assert not jnative.flac_available()
    with jax_native_decoders(tmp_path / "lib"):
        assert jnative.flac_available()
        assert jnative._FLAC_LIB_PATH == tmp_path / "lib" / "libvbflac.so"
        for spec in FLAC_KINDS:
            bps, ch = spec[:2]
            amp = 3000.0 if bps == 16 else 3e5
            written = np.mean([_sig(5000, seed=c, amp=amp, bps=bps) for c in range(ch)], axis=0)
            ref = jnative.flac_read(files[spec])
            _same(native.flac_read(files[spec]), ref)
            np.testing.assert_array_equal(ref[0], (written / 2.0 ** (bps - 1)).astype(np.float32))
    assert not jnative.flac_available()  # the loader's state restored on exit


@pytest.mark.parametrize("fault", ["missing_compiler", "broken_source"])
def test_fixture_fails_rather_than_skips(tmp_path, monkeypatch, fault):
    monkeypatch.setattr(jnative, "_flac_tried", True)
    monkeypatch.setattr(jnative, "_flac_lib", None)
    kw = {"cxx": "g++-missing-from-this-path"}
    if fault == "broken_source":
        broken = tmp_path / "flacio.cpp"
        broken.write_text(jnative._FLAC_SRC.read_text().replace("{", "{ not C++ ", 1))
        kw = {"sources": {"_FLAC_SRC": broken}}
    with pytest.raises(pytest.fail.Exception, match="failed"):
        with jax_native_decoders(tmp_path / "lib", **kw):
            pass
    assert not (tmp_path / "lib" / "libvbflac.so").exists()
