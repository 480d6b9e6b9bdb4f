"""The port's duration-predictor inference and tokenizers against the JAX
package, on the CPU in float32.

* tokenizer ids identical to the JAX tokenizers (graphemes; espeak through
  the committed `tests/fixtures/espeak_ipa.json` as the backend);
* `DurationPredictorNet` durations against the JAX net (atol 2e-4), with a
  `proj_in`, bucket pads and a batch row of pads only;
* `masked_frame_durations` and `align_phoneme_ids_with_durations` exact,
  pads, ties and `total_length` included, on numpy and torch inputs;
* `DurationPredictor.forward_with_cond_scale` with `cond=None` and with
  `cond_scale != 1`, its aligned ids exact;
* `duration_predictor_state_dict` equal to `export_duration_predictor_torch`
  and loading with `strict=True`.
"""

import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_transformer import _perturbed, _xla_inv_freq
from voicebox_tpu.models import duration as jd
from voicebox_tpu.utils import tokenizer as jtok
from voicebox_tpu.utils.port_weights import export_duration_predictor_torch
from voicebox_tpu_torch.models import duration as td
from voicebox_tpu_torch.utils import tokenizer as ttok
from voicebox_tpu_torch.utils.convert import duration_predictor_state_dict

ATOL = 2e-4
FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "espeak_ipa.json"
DP_CONFIG = dict(dim_phoneme_emb=32, dim=32, depth=2, dim_head=8, heads=4,
                 aligner_dim_in=13, aligner_attn_channels=13)
LATENT = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Codec:
    """Stands in for an attached codec: the predictor reads only its width."""

    latent_dim = LATENT


class _FixtureBackend:
    """phonemizer's interface over the committed espeak-ng phonemizations."""

    def __init__(self, entries):
        self.ipa = {e["text"]: e["ipa"] for e in entries}

    def phonemize(self, texts):
        return [self.ipa[t] for t in texts]


TEXTS = ["Hello, World!", "speech synthesis", "a", "ünïcode & tabs\tand 42?", ""]


@pytest.mark.parametrize("max_length", [None, 4])
def test_grapheme_tokenizer_ids_match_jax(max_length):
    texts = TEXTS[:-1]
    got = ttok.GraphemeTokenizer().texts_to_tensor_ids(texts, max_length=max_length)
    ref = jtok.GraphemeTokenizer().texts_to_tensor_ids(texts, max_length=max_length)
    assert got.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert ttok.GraphemeTokenizer().vocab_size == jtok.GraphemeTokenizer().vocab_size
    assert ttok.ESPEAK_AVAILABLE == jtok.ESPEAK_AVAILABLE
    assert type(ttok.Tokenizer()).__name__ == type(jtok.Tokenizer()).__name__


def test_espeak_tokenizer_ids_match_jax_and_fixture():
    entries = json.loads(FIXTURE.read_text())["entries"]
    texts = [e["text"] for e in entries]
    got = ttok.EspeakTokenizer(backend=_FixtureBackend(entries)).texts_to_tensor_ids(texts)
    ref = jtok.EspeakTokenizer(backend=_FixtureBackend(entries)).texts_to_tensor_ids(texts)
    np.testing.assert_array_equal(got, ref)
    for row, e in zip(got, entries):
        assert row[: len(e["ids"])].tolist() == e["ids"]
        assert (row[len(e["ids"]):] == -1).all()
    assert ttok._IPA_SYMBOLS == jtok._IPA_SYMBOLS
    assert ttok.EspeakTokenizer(backend=_FixtureBackend([])).vocab_size == 256
    unk = ttok.EspeakTokenizer(backend=_FixtureBackend([{"text": "x", "ipa": "ⵣa"}]))
    assert unk.texts_to_tensor_ids(["x"]).tolist() == [[0, 2]]


@functools.cache
def _dp_models(seed=0):
    tok = jtok.GraphemeTokenizer()
    jdp = jd.DurationPredictor(tokenizer=tok, audio_enc_dec=_Codec(), **DP_CONFIG)
    params = jdp.init_params(jax.random.PRNGKey(seed), seq_len=24, n_phonemes=12, batch=2)
    # noise on every leaf; to_pred's bias moves the durations to a few frames
    params = _perturbed(params, np.random.RandomState(seed + 1))
    params["to_pred"]["bias"] = params["to_pred"]["bias"] + 3.0
    jdp.params = params
    port = td.DurationPredictor(tokenizer=ttok.GraphemeTokenizer(), audio_enc_dec=_Codec(),
                                **DP_CONFIG)
    state = _xla_inv_freq(duration_predictor_state_dict(jax.tree.map(np.asarray, params)),
                          "transformer.")
    port.net.load_state_dict(state, strict=True)
    return jdp, port.eval()


def _ids(seed=3, b=3, n=12):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 40, (b, n)).astype(np.int32)
    ids[0, 9:] = -1  # bucket pads
    ids[-1] = -1  # a batch row of pads only: every key masked
    return ids


def test_state_dict_matches_exporter_and_loads_strict():
    jdp, port = _dp_models()
    ref = export_duration_predictor_torch(jdp.params)
    got = duration_predictor_state_dict(jax.tree.map(np.asarray, jdp.params))
    assert list(got) == list(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)
    assert set(got) == set(port.net.state_dict())
    assert not any(k.startswith("aligner") for k in got)


@pytest.mark.parametrize("with_cond", [False, True])
def test_net_durations_match_jax(with_cond):
    jdp, port = _dp_models()
    ids = _ids()
    rs = np.random.RandomState(4)
    cond = (rs.randn(3, 15, LATENT) if with_cond else np.zeros((3, 12, LATENT))).astype(np.float32)
    drop = np.array([False, True, False])
    ref = np.asarray(jdp.net.apply({"params": jdp.params}, cond=jnp.asarray(cond),
                                   phoneme_ids=jnp.asarray(ids), cond_drop_mask=jnp.asarray(drop),
                                   train=False))
    got = port.net(cond=torch.from_numpy(cond), phoneme_ids=torch.from_numpy(ids).long(),
                   cond_drop_mask=torch.from_numpy(drop))
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_masked_frame_durations_match_jax(kind):
    ids = _ids(5)
    d = np.random.RandomState(6).uniform(-2, 6, ids.shape).astype(np.float32)
    d[0, :4] = [0.5, 1.5, 2.5, -0.5]  # ties round to even, then clip to 1
    ref = np.asarray(jd.masked_frame_durations(jnp.asarray(ids), jnp.asarray(d)))
    got = td.masked_frame_durations(ids, d if kind == "numpy" else torch.from_numpy(d))
    got = np.asarray(got) if kind == "numpy" else got.numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int32 and (got[ids < 0] == 0).all()


@pytest.mark.parametrize("total_length", [None, 7, 60])
def test_align_phoneme_ids_matches_jax(total_length):
    ids = _ids(7, b=4)
    ids[2, 5:] = -1
    d = np.random.RandomState(8).uniform(0, 5, ids.shape).astype(np.float32)
    ref = np.asarray(jd.align_phoneme_ids_with_durations(jnp.asarray(ids), jnp.asarray(d),
                                                         total_length))
    got = td.align_phoneme_ids_with_durations(torch.from_numpy(ids).long(),
                                              torch.from_numpy(d), total_length)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("cond_scale", [1.0, 1.7])
def test_forward_with_cond_scale_matches_jax(cond_scale):
    jdp, port = _dp_models()
    ids = _ids(9)
    cond = None
    if cond_scale != 1.0:
        cond = np.random.RandomState(10).randn(3, 12, LATENT).astype(np.float32)
    d_ref, a_ref = jdp.forward_with_cond_scale(
        cond=None if cond is None else jnp.asarray(cond), phoneme_ids=jnp.asarray(ids),
        cond_scale=cond_scale, return_aligned_phoneme_ids=True, total_length=48)
    d, a = port.forward_with_cond_scale(
        cond=None if cond is None else torch.from_numpy(cond), phoneme_ids=ids,
        cond_scale=cond_scale, return_aligned_phoneme_ids=True, total_length=48)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    # the pads-only row speaks for no frame
    assert (a[-1] == 0).all()
    # from texts through the tokenizer, as the JAX facade takes them
    got = port.forward_with_cond_scale(texts=["hi there", "a"])
    ref = jdp.forward_with_cond_scale(cond=None, texts=["hi there", "a"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_training_half_raises():
    """The name dates from before the training half was ported
    (`tests/test_torch_duration_train.py` holds it against JAX): training
    now raises only without the aligner's inputs, as the JAX net asserts."""
    _, port = _dp_models()
    with pytest.raises(ValueError, match="missing: mel, phoneme_len"):
        port(cond=torch.zeros(1, 4, LATENT), phoneme_ids=torch.zeros(1, 4, dtype=torch.long),
             train=True)
    with pytest.raises(ValueError, match="needs an aligner"):
        port.net(cond=torch.zeros(1, 4, LATENT), phoneme_ids=torch.zeros(1, 4, dtype=torch.long),
                 train=True, mel=torch.zeros(1, 4, 13), phoneme_len=torch.ones(1),
                 mel_len=torch.ones(1), phoneme_mask=torch.ones(1, 4, dtype=torch.bool),
                 mel_mask=torch.ones(1, 4, dtype=torch.bool))
    with pytest.raises(ValueError):
        td.DurationPredictor(tokenizer=ttok.GraphemeTokenizer(), num_phoneme_tokens=3)
