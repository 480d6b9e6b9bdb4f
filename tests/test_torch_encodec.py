"""The port's SEANet codec (`models/encodec.py`) and `EncodecVoco.encode`
against the JAX package, on the CPU in float32, at tiny widths with the
production structure (causal convs, residual units, a two-layer LSTM with
its skip, transposed convs trimmed on the right), the weights carried by
`utils/convert.py` (random fan-in scaled leaves on the JAX trees' shapes,
drawn without compiling an init):

* `_LSTM` alone first (the per-gate flax Denses packed into torch's
  [i, f, g, o] rows, the bias folded into `bias_hh`): atol 2e-4;
* `SEANetEncoder`, `SEANetDecoder`, `EncodecModel.encode` / `rq` /
  `decode_latents` / `decode_codes` and `EncodecVoco.encode`: atol 2e-4
  (relative to the output's peak where it exceeds 1);
* the converter's keys are upstream facebook/encodec's and load with
  `strict=True`, and `voicebox_tpu/utils/port_weights.py::
  load_encodec_torch` reads them back into the JAX tree exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicebox_tpu.models.codec import EncodecVoco as JaxEncodecVoco
from voicebox_tpu.models.encodec import EncodecModel as JaxEncodecModel
from voicebox_tpu.models.encodec import _LSTM as JaxLSTM
from voicebox_tpu.models.vocos import Vocos as JaxVocos
from voicebox_tpu.utils.port_weights import load_encodec_torch
from voicebox_tpu_torch.models.codec import EncodecVoco
from voicebox_tpu_torch.models.encodec import EncodecModel, ResidualVQ, _LSTM
from voicebox_tpu_torch.models.vocos import Vocos
from voicebox_tpu_torch.utils.convert import _lstm, encodec_model_state_dict, encodec_voco_state_dict

DIM, N_FILTERS, RATIOS, Q, CODEBOOK = 8, 2, (4, 2), 2, 16
HOP = 8
N_SAMPLES = 960  # 0.04 s at 24 kHz: 120 frames


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(out, ref, atol=2e-4):
    np.testing.assert_allclose(out, ref, atol=atol * max(1.0, np.abs(ref).max()), rtol=0)


def random_params(shapes, rs):
    """Random leaves of a flax tree's shapes (from `jax.eval_shape`, which
    compiles nothing): fan-in scaled normals for kernels and tables, 0.1 x
    normals for biases."""
    def leaf(sd):
        scale = 1.0 / np.sqrt(np.prod(sd.shape[:-1])) if len(sd.shape) > 1 else 0.1
        return (scale * rs.randn(*sd.shape)).astype(np.float32)

    return jax.tree.map(leaf, shapes)


@functools.cache
def _jax_model():
    model = JaxEncodecModel(dim=DIM, n_filters=N_FILTERS, ratios=RATIOS, num_quantizers=Q,
                            codebook_size=CODEBOOK, params={})
    key, rs = jax.random.PRNGKey(0), np.random.RandomState(0)
    model.params = {
        "encoder": random_params(jax.eval_shape(model.encoder.init, key,
                                                jnp.zeros((1, 4 * HOP)))["params"], rs),
        "decoder": random_params(jax.eval_shape(model.decoder.init, key,
                                                jnp.zeros((1, 4, DIM)))["params"], rs),
        "quantizer": {"codebooks": rs.randn(Q, CODEBOOK, DIM).astype(np.float32)},
    }
    return model


def _port_model():
    model = EncodecModel(dim=DIM, n_filters=N_FILTERS, ratios=RATIOS, num_quantizers=Q,
                         codebook_size=CODEBOOK)
    model.load_state_dict(encodec_model_state_dict(_jax_model().params), strict=True)
    return model


def _wave(seed, b=2, n=N_SAMPLES):
    return (0.3 * np.random.RandomState(seed).randn(b, n)).astype(np.float32)


def _latents(seed):
    """Latents of the waves' shape, (2, N_SAMPLES / HOP, DIM): every JAX
    program of the file then compiles at one shape."""
    return np.random.RandomState(seed).randn(2, N_SAMPLES // HOP, DIM).astype(np.float32)


def test_lstm_alone_matches_jax():
    lstm = JaxLSTM(features=6)
    x = np.random.RandomState(1).randn(2, 30, 6).astype(np.float32)
    params = random_params(jax.eval_shape(lstm.init, jax.random.PRNGKey(0),
                                          jnp.asarray(x))["params"], np.random.RandomState(2))
    ref = np.asarray(lstm.apply({"params": params}, jnp.asarray(x)))
    port = _LSTM(6)
    state = {}
    _lstm(state, "lstm", params)
    port.load_state_dict(state, strict=True)
    assert not state["lstm.bias_ih_l0"].any()
    with torch.no_grad():
        out = port(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    _close(out, ref)


def test_encoder_and_decoder_match_jax():
    jm, port = _jax_model(), _port_model()
    wave = _wave(3)
    ref = np.asarray(jm.encode(jnp.asarray(wave)))
    out = port.encode(torch.from_numpy(wave)).numpy()
    assert out.shape == ref.shape == (2, N_SAMPLES // HOP, DIM)
    _close(out, ref)
    # (b, 1, n) is the same audio
    _close(port.encode(torch.from_numpy(wave[:, None])).numpy(), ref)

    lat = _latents(4)
    ref = np.asarray(jm._decode(jm.params, jnp.asarray(lat)))
    out = port.decoder(torch.from_numpy(lat)).detach().numpy()
    assert out.shape == ref.shape == (2, N_SAMPLES)
    _close(out, ref)


def test_rq_and_decodes_match_jax():
    jm, port = _jax_model(), _port_model()
    lat = _latents(5)
    _, codes_j, _ = jm.rq(jnp.asarray(lat))
    _, codes_t, _ = port.rq(torch.from_numpy(lat))
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    _close(port.decode_latents(torch.from_numpy(lat)).numpy(),
           np.asarray(jm.decode_latents(jnp.asarray(lat))))
    _close(port.decode_codes(codes_t).numpy(), np.asarray(jm.decode_codes(codes_j)))
    audio, codes, _ = port(torch.from_numpy(_wave(6)))
    ref_audio, ref_codes, _ = jm(jnp.asarray(_wave(6)))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
    _close(audio.numpy(), np.asarray(ref_audio))
    lat_only, none_codes, _ = port(torch.from_numpy(_wave(6)), return_encoded=True)
    assert none_codes is None and lat_only.shape == (2, N_SAMPLES // HOP, DIM)


def test_state_dict_is_upstream_layout_and_round_trips():
    state = encodec_model_state_dict(_jax_model().params)
    n = len(RATIOS)
    for key in ("encoder.model.0.conv.conv.weight", "encoder.model.1.block.1.conv.conv.weight",
                "encoder.model.3.conv.conv.bias", f"encoder.model.{3 * n + 1}.lstm.weight_ih_l1",
                f"encoder.model.{3 * n + 3}.conv.conv.weight",
                "decoder.model.1.lstm.weight_hh_l0", "decoder.model.3.convtr.convtr.weight",
                f"decoder.model.{3 * n + 3}.conv.conv.weight", "quantizer.codebooks"):
        assert key in state, key
    import tempfile

    upstream = {k: v.numpy() for k, v in state.items()}
    upstream.update({f"quantizer.vq.layers.{i}._codebook.embed": upstream["quantizer.codebooks"][i]
                     for i in range(Q)})
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/encodec.pt"
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in upstream.items()}, path)
        back = load_encodec_torch(path, _jax_model().params, ratios=RATIOS)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(_jax_model().params))
    for path, leaf in flat_a:
        # torch's two LSTM biases sum to the flax hidden bias: exact here (one is zero)
        np.testing.assert_allclose(np.asarray(leaf), np.asarray(flat_b[path]), atol=1e-7,
                                   err_msg=jax.tree_util.keystr(path))


@functools.cache
def _jax_voco():
    return JaxVocos(input_channels=DIM, dim=16, intermediate_dim=24, num_layers=1, n_fft=32,
                    hop_length=HOP, num_bandwidths=4, codebook_size=CODEBOOK, num_quantizers=Q)


@pytest.mark.parametrize("shape", [(2, N_SAMPLES), (2, 1, N_SAMPLES)])
def test_encodec_voco_encode_matches_jax(shape):
    jm, jv = _jax_model(), _jax_voco()
    jc = JaxEncodecVoco(encodec=jm, vocos=jv)
    codec = EncodecVoco(quantizer=ResidualVQ(Q, CODEBOOK, DIM),
                        vocos=Vocos(input_channels=DIM, dim=16, intermediate_dim=24, num_layers=1,
                                    n_fft=32, hop_length=HOP, num_bandwidths=4,
                                    codebook_size=CODEBOOK, num_quantizers=Q),
                        ratios=RATIOS, n_filters=N_FILTERS)
    codec.load_state_dict(encodec_voco_state_dict(jm.params["quantizer"], jv.params,
                                                  jm.params["encoder"]), strict=True)
    wave = _wave(7).reshape(shape)
    ref = np.asarray(jc.encode(jnp.asarray(wave)))
    out = codec.encode(torch.from_numpy(wave)).numpy()
    assert out.shape == ref.shape == (shape[0], N_SAMPLES // HOP, DIM)
    _close(out, ref)
    assert codec.downsample_factor == HOP and codec.latent_dim == DIM
