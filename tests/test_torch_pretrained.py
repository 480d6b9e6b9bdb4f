"""Checkpoint and geometry entry points of the port against the JAX
package's files, on the CPU:

* `DurationPredictor.load_torch` reads the JAX package's `save_torch`
  file (bare and under `duration_predictor.`) and predicts its durations
  at atol 2e-4; the port's `save_torch` file loads back into the JAX
  predictor with every parameter equal;
* `Vocos.from_pretrained`: a local upstream-layout file (with the upstream
  keys the port does not hold) decodes as the JAX package's
  `from_pretrained` of the same file; a known name without a file builds
  the published geometry, shape for shape the JAX package's;
* `TTSEngine(compilation_cache_dir=)` moves the kernels' build directory
  for the process.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_codec import VOCOS, _audio_close
from test_torch_duration import DP_CONFIG
from test_torch_serving import ENGINE, VB_CONFIG
from test_torch_transformer import _perturbed
from voicebox_tpu.models.duration import DurationPredictor as JaxDP
from voicebox_tpu.models.vocos import Vocos as JaxVocos
from voicebox_tpu.utils.tokenizer import GraphemeTokenizer as JaxGraphemes
from voicebox_tpu_torch import (ConditionalFlowMatcherWrapper, DurationPredictor, TTSEngine,
                                VoiceBox, Vocos, kernels)
from voicebox_tpu_torch.utils.convert import vocos_state_dict
from voicebox_tpu_torch.utils.tokenizer import GraphemeTokenizer

ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def _jax_dp(seed):
    jdp = JaxDP(tokenizer=JaxGraphemes(), **DP_CONFIG)
    jdp.params = _perturbed(jdp.init_params(jax.random.PRNGKey(seed), seq_len=16,
                                            n_phonemes=8), np.random.RandomState(seed))
    return jdp


@pytest.mark.parametrize("prefix", ["", "duration_predictor."])
def test_duration_predictor_checkpoints_round_trip_with_jax(tmp_path, prefix):
    jdp = _jax_dp(0)
    jdp.save_torch(str(tmp_path / "jax.pt"), prefix=prefix)
    dp = DurationPredictor(tokenizer=GraphemeTokenizer(), **DP_CONFIG)
    dp.load_torch(tmp_path / "jax.pt")
    ids = np.asarray(JaxGraphemes().texts_to_tensor_ids(["hello you", "ok"]))
    cond = np.random.RandomState(1).randn(2, ids.shape[1], DP_CONFIG["dim"]).astype(np.float32)
    ref = jdp.forward_with_cond_scale(cond=jnp.asarray(cond), phoneme_ids=jnp.asarray(ids))
    got = dp.forward_with_cond_scale(cond=torch.from_numpy(cond),
                                     phoneme_ids=torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    # the port's file, read by the JAX package into another predictor's tree
    pkg = dp.save_torch(tmp_path / "port.pt", prefix=prefix)
    assert set(pkg) == {"model", "optim", "scheduler"}
    back = _jax_dp(5)
    back.load_torch(str(tmp_path / "port.pt"))
    compared = 0
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back.params),
                            jax.tree_util.tree_leaves(jdp.params)):
        if "aligner" in str(path):  # training only; neither package writes it
            continue
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))
        compared += 1
    assert compared == len(dp.net.state_dict()) - 2  # all but null_cond and inv_freq


def test_duration_predictor_load_rejects_another_geometry(tmp_path):
    _jax_dp(0).save_torch(str(tmp_path / "jax.pt"))
    wider = DurationPredictor(tokenizer=GraphemeTokenizer(), **{**DP_CONFIG, "depth": 4})
    with pytest.raises(KeyError, match="not a DurationPredictor checkpoint"):
        wider.load_torch(tmp_path / "jax.pt")


def test_vocos_from_a_local_file_decodes_as_jax(tmp_path):
    kw = {k: v for k, v in VOCOS.items() if k not in ("input_channels", "num_bandwidths")}
    src = JaxVocos(input_channels=128, num_bandwidths=4, seed=3, **kw)  # the encodec layout
    src.params = _perturbed(src.params, np.random.RandomState(4))
    sd = dict(vocos_state_dict(src.params))
    # upstream keys the port's module does not hold
    sd["feature_extractor.encodec.quantizer.vq.layers.0._codebook.embed"] = torch.zeros(2, 2)
    path = tmp_path / "vocos-encodec-24khz"
    torch.save(sd, path)
    jv = JaxVocos.from_pretrained(str(path), **kw)
    tv = Vocos.from_pretrained(str(path), **kw)
    assert (tv.input_channels, tv.num_bandwidths, tv.hop_length) == (128, 4, 16)
    feats = np.random.RandomState(5).randn(2, 128, 12).astype(np.float32)
    ref = jv.decode(jnp.asarray(feats), bandwidth_id=1)
    with torch.no_grad():
        out = tv.decode(torch.from_numpy(feats), torch.tensor([1]))
    _audio_close(out.numpy(), np.asarray(ref))
    with pytest.warns(UserWarning, match="keep their init"):  # a file missing the head
        torch.save({k: v for k, v in sd.items() if not k.startswith("head.")}, path)
        Vocos.from_pretrained(str(path), **kw)


@pytest.mark.parametrize("name", ["charactr/vocos-encodec-24khz", "charactr/vocos-mel-24khz"])
def test_vocos_known_name_builds_the_published_geometry(name):
    small = dict(dim=32, intermediate_dim=48, num_layers=2)
    jv = JaxVocos.from_pretrained(name, **small)
    tv = Vocos.from_pretrained(name, **small)
    want = {k: tuple(v.shape) for k, v in vocos_state_dict(jv.params).items()}
    assert {k: tuple(v.shape) for k, v in tv.state_dict().items()} == want
    assert (tv.hop_length, tv.head.n_fft) == ((320, 1280) if "encodec" in name else (256, 1024))


def test_compilation_cache_dir_moves_the_kernels_build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "BUILD_DIR", kernels.BUILD_DIR)  # restored afterwards
    tok = GraphemeTokenizer()
    cfm = ConditionalFlowMatcherWrapper(
        VoiceBox(num_cond_tokens=tok.vocab_size, **VB_CONFIG),
        duration_predictor=DurationPredictor(tokenizer=tok, **DP_CONFIG), device="cpu")
    engine = TTSEngine(cfm, compilation_cache_dir=str(tmp_path / "cache"), **ENGINE)
    assert engine.wrapper is cfm and kernels.BUILD_DIR == (tmp_path / "cache").resolve()
    # a library already built under the directory is found there: nothing compiles
    src = kernels._CSRC / "w8a16_matmul.cu"
    lib = kernels.BUILD_DIR / f"libw8a16_matmul_{kernels.source_digest(src)}.so"
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"")
    assert kernels.build("w8a16_matmul") == lib
