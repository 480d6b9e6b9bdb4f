"""The port's codecs (iSTFT, RVQ, Vocos, EncodecVoco, MelVoco) against the
JAX package, on the CPU in float32, at tiny widths with the production
structure (4 bandwidths, AdaLayerNorm, codes -> features; MelVoco's
log-mel encode and its dB -> amplitude -> mel Vocos decode).

Audio is compared at atol 1e-4 x its peak: random Vocos weights make
magnitudes up to the clip at 100, and the overlap-add sums them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_encodec import random_params
from test_torch_transformer import _perturbed
from voicebox_tpu.models.codec import EncodecVoco as JaxEncodecVoco
from voicebox_tpu.models.codec import MelVoco as JaxMelVoco
from voicebox_tpu.models.encodec import EncodecModel, ResidualVQ as JaxResidualVQ
from voicebox_tpu.models.encodec import SEANetEncoder as JaxSEANetEncoder
from voicebox_tpu.models.vocos import Vocos as JaxVocos
from voicebox_tpu.ops.stft import hann_window as jax_hann_window
from voicebox_tpu.ops.stft import istft as jax_istft
from voicebox_tpu_torch.models.codec import EncodecVoco, MelVoco
from voicebox_tpu_torch.models.encodec import ResidualVQ
from voicebox_tpu_torch.models.vocos import Vocos
from voicebox_tpu_torch.ops.stft import hann_window, istft
from voicebox_tpu_torch.utils.convert import encodec_voco_state_dict, vocos_state_dict

LATENT, Q, CODEBOOK = 16, 4, 32
VOCOS = dict(input_channels=LATENT, dim=32, intermediate_dim=48, num_layers=2, n_fft=64,
             hop_length=16, num_bandwidths=4, codebook_size=CODEBOOK, num_quantizers=Q)
RATIOS = (2, 2, 2, 2)  # frame hop 16 = the tiny vocoder's hop
N_FILTERS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _audio_close(out, ref):
    np.testing.assert_allclose(out, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("n_fft,hop,frames", [
    (64, 16, 12),
    (1280, 320, 6),   # the vocos-encodec-24khz geometry
    (64, 16, 1),      # one frame: the window-square floor
    (48, 20, 9),      # a hop that does not divide n_fft
])
def test_istft_matches_jax(n_fft, hop, frames):
    rs = np.random.RandomState(0)
    spec = (rs.randn(2, n_fft // 2 + 1, frames) + 1j * rs.randn(2, n_fft // 2 + 1, frames))
    spec = spec.astype(np.complex64)
    ref = jax.jit(functools.partial(jax_istft, n_fft=n_fft, hop_length=hop, padding="same"))(
        jnp.asarray(spec)
    )
    out = istft(torch.from_numpy(spec), n_fft, hop)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_hann_window_matches_jax():
    np.testing.assert_allclose(hann_window(1280).numpy(), np.asarray(jax_hann_window(1280)),
                               atol=1e-6)  # float32 cos rounding


@functools.cache
def _jax_codec():
    """A JAX EncodecVoco with perturbed random weights: its quantizer and
    SEANet encoder (the SEANet decoder is not initialised)."""
    rs = np.random.RandomState(1)
    rvq = JaxResidualVQ(num_quantizers=Q, codebook_size=CODEBOOK, dim=LATENT)
    quantizer = rvq.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, LATENT)))["params"]
    enc = JaxSEANetEncoder(dim=LATENT, n_filters=N_FILTERS, ratios=RATIOS)
    encoder = random_params(jax.eval_shape(enc.init, jax.random.PRNGKey(1),
                                           jnp.zeros((1, 64)))["params"], rs)
    encodec = EncodecModel(dim=LATENT, n_filters=N_FILTERS, ratios=RATIOS, num_quantizers=Q,
                           codebook_size=CODEBOOK,
                           params={"quantizer": quantizer, "encoder": encoder})
    vocos = JaxVocos(**VOCOS, seed=0)
    vocos.params = _perturbed(vocos.params, rs)
    return JaxEncodecVoco(encodec=encodec, vocos=vocos)


def _port_codec(jax_codec):
    codec = EncodecVoco(quantizer=ResidualVQ(Q, CODEBOOK, LATENT), vocos=Vocos(**VOCOS),
                        ratios=RATIOS, n_filters=N_FILTERS)
    params = jax_codec.encodec.params
    codec.load_state_dict(
        encodec_voco_state_dict(params["quantizer"], jax_codec.vocos.params, params["encoder"]),
        strict=True,
    )
    return codec


def _latents(seed, b=2, n=24):
    return np.random.RandomState(seed).randn(b, n, LATENT).astype(np.float32)


@pytest.mark.parametrize("seed", [2, 3])
def test_rvq_codes_equal(seed):
    jc = _jax_codec()
    lat = _latents(seed)
    q_j, codes_j, _ = jc.encodec.rq(jnp.asarray(lat))
    q_t, codes_t, _ = _port_codec(jc).quantizer(torch.from_numpy(lat))
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_allclose(q_t.detach().numpy(), np.asarray(q_j), atol=1e-5)


@pytest.mark.parametrize("bandwidth_id", [2, 0])
def test_vocos_decode_matches_jax(bandwidth_id):
    jc = _jax_codec()
    feats = np.random.RandomState(4).randn(2, LATENT, 24).astype(np.float32)
    ref = jc.vocos.decode(jnp.asarray(feats), bandwidth_id=bandwidth_id)
    vocos = Vocos(**VOCOS)
    vocos.load_state_dict(vocos_state_dict(jc.vocos.params), strict=True)
    with torch.no_grad():
        out = vocos.decode(torch.from_numpy(feats), torch.tensor([bandwidth_id]))
    assert out.shape == (2, 24 * 16)
    _audio_close(out.numpy(), np.asarray(ref))


def test_codes_to_features_matches_jax():
    jc = _jax_codec()
    codes = np.random.RandomState(5).randint(0, CODEBOOK, (2, Q, 24))
    ref = jc.vocos.codes_to_features(jnp.asarray(codes))
    with torch.no_grad():
        out = _port_codec(jc).vocos.codes_to_features(torch.from_numpy(codes))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_encodec_voco_decode_matches_jax():
    jc = _jax_codec()
    lat = _latents(6)
    ref = np.asarray(jc.decode(jnp.asarray(lat)))
    codec = _port_codec(jc)
    out = codec.decode(torch.from_numpy(lat)).numpy()
    assert out.shape == ref.shape == (2, 1, 24 * codec.downsample_factor)
    _audio_close(out, ref)
    codes = codec.decode_to_codes(torch.from_numpy(lat))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc.decode_to_codes(jnp.asarray(lat))))


def test_encode_is_not_ported_yet():
    """The name dates from before the SEANet encoder was ported: encode now
    runs it, at the codec's ratios, and matches the JAX codec's encode."""
    jc = _jax_codec()
    codec = _port_codec(jc)
    wave = (0.3 * np.random.RandomState(7).randn(2, 320)).astype(np.float32)
    out = codec.encode(torch.from_numpy(wave)).numpy()
    ref = np.asarray(jc.encode(jnp.asarray(wave)))
    assert out.shape == ref.shape == (2, 320 // codec.downsample_factor, LATENT)
    np.testing.assert_allclose(out, ref, atol=2e-4 * max(1.0, np.abs(ref).max()), rtol=0)
    default = EncodecVoco(quantizer=ResidualVQ(Q, CODEBOOK, LATENT), vocos=Vocos(**VOCOS))
    assert default.downsample_factor == 320 and default.latent_dim == LATENT


# MelVoco at a tiny mel geometry: 8 mels, n_fft 64, win 48, hop 16 (the
# vocoder's), the JAX package's vocos-mel head without bandwidths
MEL_VOCOS = dict(input_channels=8, dim=32, intermediate_dim=48, num_layers=2, n_fft=64,
                 hop_length=16)
MEL = dict(n_mels=8, n_fft=64, win_length=48)


@functools.cache
def _jax_mel_voco():
    vocos = JaxVocos(**MEL_VOCOS, seed=3)
    vocos.params = _perturbed(vocos.params, np.random.RandomState(8))
    return JaxMelVoco(vocos=vocos, **MEL)


def _port_mel_voco():
    vocos = Vocos(**MEL_VOCOS)
    vocos.load_state_dict(vocos_state_dict(_jax_mel_voco().vocos.params), strict=True)
    return MelVoco(vocos=vocos, **MEL)


@pytest.mark.parametrize("shape", [(2, 1000), (1, 1, 333)])
def test_mel_voco_encode_matches_jax(shape):
    rs = np.random.RandomState(9)
    wave = (0.5 * np.sin(np.arange(shape[-1]) * rs.uniform(0.05, 0.5, shape[:-1] + (1,)))
            + 0.1 * rs.randn(*shape)).astype(np.float32)
    ref = np.asarray(_jax_mel_voco().encode(jnp.asarray(wave)))
    codec = _port_mel_voco()
    out = codec.encode(torch.from_numpy(wave)).numpy()
    assert out.shape == ref.shape == (shape[0], shape[-1] // 16 + 1, 8)
    np.testing.assert_allclose(out, ref, atol=1e-2, rtol=0)  # dB, as tests/test_torch_stft.py
    assert (codec.frame_offset, codec.latent_dim, codec.downsample_factor) == (1, 8, 16)


def test_mel_voco_decode_matches_jax():
    mel = (np.random.RandomState(10).randn(2, 24, 8) * 10 - 30).astype(np.float32)  # dB
    ref = np.asarray(_jax_mel_voco().decode(jnp.asarray(mel)))
    out = _port_mel_voco().decode(torch.from_numpy(mel)).numpy()
    assert out.shape == ref.shape == (2, 24 * 16)
    _audio_close(out, ref)


def test_mel_voco_geometry_checks():
    with pytest.raises(ValueError, match="n_mels"):
        MelVoco(n_mels=80, vocos=Vocos(**MEL_VOCOS))
    with pytest.warns(UserWarning, match="hop_length 8 != vocoder hop 16"):
        codec = MelVoco(hop_length=8, vocos=Vocos(**MEL_VOCOS), **MEL)
    assert codec.downsample_factor == 8
    default = MelVoco()  # vocos-mel-24khz
    assert (default.vocos.input_channels, default.hop_length, default.vocos.head.n_fft) == (
        100, 256, 1024)
