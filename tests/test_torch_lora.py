"""The port's LoRA adapters (`voicebox_tpu_torch/ops/lora.py`) against the
JAX package's (`voicebox_tpu/ops/lora.py`), on the CPU in float32, on the
tiny VoiceBox of `tests/test_lora.py` (dim 32, depth 2, 2 x 16 heads, 2
registers). JAX's adapters come across through
`utils/convert.py::lora_from_jax`, with B made non-zero from a seed.

* the adapted layers equal JAX `lora_init`'s on VoiceBox and the
  DurationPredictor, and both refuse the TextToSemantic (no `transformer`
  scope);
* identity at init, bit for bit;
* the hooked loss at atol 2e-4, adapter gradients at cosine > 0.999 and
  atol 2e-3, none on the base;
* `fold_lora` against JAX's `fold_lora`, the folded forward against the
  hooked one, and fold then w8a16 (the plain version of K4) against JAX's
  fold then `quantize_dense_params`;
* the unrolled `skip_combiner_{i}`: adapted by place here, missed by JAX's
  exact name match.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_duration import DP_CONFIG, _Codec
from test_torch_train import _assert_leaves_close
from test_torch_transformer import _perturbed, _xla_inv_freq
from voicebox_tpu import ConditionalFlowMatcherWrapper as JaxCFM
from voicebox_tpu import VoiceBox as JaxVoiceBox
from voicebox_tpu.models import duration as jd
from voicebox_tpu.models.text_to_semantic import TextToSemantic as JaxT2S
from voicebox_tpu.ops import lora as jl
from voicebox_tpu.ops import quant as jq
from voicebox_tpu.utils import tokenizer as jtok
from voicebox_tpu_torch import DurationPredictor, TextToSemantic, VoiceBox
from voicebox_tpu_torch.models.transformer import Transformer
from voicebox_tpu_torch.ops import lora as tl
from voicebox_tpu_torch.ops.quant import quantize_voicebox
from voicebox_tpu_torch.utils.convert import lora_from_jax, voicebox_state_dict
from voicebox_tpu_torch.utils.tokenizer import GraphemeTokenizer

ATOL = 2e-4
RANK, ALPHA = 4, 16
B, N, DIM = 2, 16, 32
CONFIG = dict(num_cond_tokens=0, dim_in=DIM, dim_cond_emb=0, dim=DIM, depth=2, dim_head=16,
              heads=2, num_register_tokens=2, attn_qk_norm=False, condition_on_text=False)


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
def _models():
    """JAX VoiceBox params (noise on every leaf) and seeded adapters with a
    non-zero B."""
    cfm = JaxCFM(JaxVoiceBox(**CONFIG))
    params = _perturbed(cfm.init_params(jax.random.PRNGKey(0), seq_len=N, batch=B),
                        np.random.RandomState(1))
    lora = jl.lora_init(jax.random.PRNGKey(1), params, rank=RANK)
    rs = np.random.RandomState(2)
    lora = jax.tree.map(lambda x: np.asarray(x) + 0.05 * rs.randn(*x.shape).astype(np.float32),
                        lora)
    return cfm.voicebox, params, lora


def _port(params):
    vb = VoiceBox(**CONFIG)
    state = voicebox_state_dict(params, dim_head=CONFIG["dim_head"])
    vb.load_state_dict(_xla_inv_freq(state, "transformer."), strict=True)
    return vb


def _inputs(seed=3):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, N, DIM).astype(np.float32)
    return dict(x=x, times=rs.rand(B).astype(np.float32),
                target=rs.randn(B, N, DIM).astype(np.float32),
                cond_mask=rs.rand(B, N) < 0.6, self_attn_mask=rs.rand(B, N) > 0.1,
                cond_drop_mask=np.array([False, True]))


def _names(tree, path=()):
    for key, sub in tree.items():
        if "lora_a" in sub:
            yield path + (key,), sub["lora_a"].shape, sub["lora_b"].shape
        else:
            yield from _names(sub, path + (key,))


def _jax_duration_params():
    jdp = jd.DurationPredictor(tokenizer=jtok.GraphemeTokenizer(), audio_enc_dec=_Codec(),
                               **DP_CONFIG)
    return jdp.init_params(jax.random.PRNGKey(0), seq_len=24, n_phonemes=12, batch=2)


T2S = dict(dim=32, num_text_token_ids=47, num_semantic_token_ids=30, source_depth=2,
           target_depth=2, heads=2, dim_head=16)


@pytest.mark.parametrize("model", ["voicebox", "duration", "text_to_semantic"])
def test_targets_match_jax(model):
    if model == "voicebox":
        params, port, prefix = _models()[1], VoiceBox(**CONFIG), ""
    elif model == "duration":
        params, prefix = _jax_duration_params(), "net."
        port = DurationPredictor(tokenizer=GraphemeTokenizer(), audio_enc_dec=_Codec(),
                                 **DP_CONFIG)
    else:
        jt = JaxT2S(**T2S)
        jt.init_params(jax.random.PRNGKey(0), n_text=8, n_sem=8, batch=2)
        with pytest.raises(AssertionError, match="no Dense kernels matched"):
            jl.lora_init(jax.random.PRNGKey(1), jt.params, rank=RANK)
        with pytest.raises(ValueError, match="no Linear matched"):
            tl.lora_init(TextToSemantic(**T2S, device="cpu"), rank=RANK)
        return
    jlora = jax.tree.map(np.asarray, jl.lora_init(jax.random.PRNGKey(1), params, rank=RANK))
    ours = tl.lora_init(port, rank=RANK, generator=torch.Generator().manual_seed(0))
    theirs = lora_from_jax(jlora, prefix=prefix)
    assert list(ours) == tl.lora_layer_names(port)
    assert set(ours) == set(theirs) and len(ours) == 4 * 2
    for name, ab in ours.items():
        for k in ("lora_a", "lora_b"):
            assert ab[k].shape == theirs[name][k].shape, (name, k)
            assert ab[k].dtype == torch.float32 and ab[k].requires_grad
        assert not ab["lora_b"].detach().any()
        # A ~ N(0, 1 / r): the shapes' few hundred draws sit near sqrt(1 / r)
        assert 0.3 < float(ab["lora_a"].detach().std()) < 0.7
    assert len(list(_names(jlora))) == len(ours)


def test_identity_at_init():
    """With B = 0 the adapted forward equals the base forward bit for bit."""
    vb = _port(_models()[1]).eval()
    inp = _inputs()
    kw = dict(times=torch.from_numpy(inp["times"]), cond=torch.from_numpy(inp["x"]),
              cond_drop_mask=torch.from_numpy(inp["cond_drop_mask"]))
    with torch.no_grad():
        base = vb(torch.from_numpy(inp["x"]), **kw)
        lora = tl.lora_init(vb, rank=RANK, generator=torch.Generator().manual_seed(0))
        tl.merge_lora_params(vb, lora)
        with tl.lora_dense(tl.lora_scale(ALPHA, RANK)):
            adapted = vb(torch.from_numpy(inp["x"]), **kw)
    assert torch.equal(adapted, base)


def _jax_loss(jvb, params, lora, inp, scale):
    @jax.jit
    def loss(lora_tree):
        with jl.lora_dense(scale):
            return jvb.apply({"params": jl.merge_lora_params(params, lora_tree)},
                             jnp.asarray(inp["x"]), train=True,
                             **{k: jnp.asarray(v) for k, v in inp.items() if k != "x"})

    return jax.value_and_grad(loss)(jax.tree.map(jnp.asarray, lora))


def _port_kw(inp):
    return {k: torch.from_numpy(v) for k, v in inp.items() if k != "x"}


def test_hooked_loss_and_adapter_gradients_match_jax():
    jvb, params, jlora = _models()
    inp, scale = _inputs(), tl.lora_scale(ALPHA, RANK)
    jloss, jgrads = _jax_loss(jvb, params, jlora, inp, scale)
    ref = lora_from_jax(jax.tree.map(np.asarray, jgrads))

    vb = _port(params)
    lora = lora_from_jax(jlora)
    tl.merge_lora_params(vb, lora)
    with tl.lora_dense(scale):
        loss = vb(torch.from_numpy(inp["x"]), train=True, **_port_kw(inp))
        loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=ATOL, rtol=0)
    ours = {f"{n}.{k}": p.grad.numpy() for n, ab in lora.items() for k, p in ab.items()}
    _assert_leaves_close(ours, {f"{n}.{k}": p.detach().numpy() for n, ab in ref.items()
                                for k, p in ab.items()})
    assert all(p.grad is None and not p.requires_grad for p in vb.parameters())
    # outside the block the module computes the base again
    with torch.no_grad():
        base = _port(params)(torch.from_numpy(inp["x"]), train=True, **_port_kw(inp))
        again = vb(torch.from_numpy(inp["x"]), train=True, **_port_kw(inp))
    assert torch.equal(again, base) and not torch.equal(again, loss.detach())


def test_fold_matches_jax_and_the_hooked_forward():
    jvb, params, jlora = _models()
    scale = tl.lora_scale(ALPHA, RANK)
    folded_ref = voicebox_state_dict(jax.tree.map(np.asarray, jl.fold_lora(params, jlora, scale)),
                                     dim_head=CONFIG["dim_head"])

    vb = _port(params)
    lora = lora_from_jax(jlora)
    tl.merge_lora_params(vb, lora)
    folded = tl.fold_lora(vb, lora, scale)
    state = folded.state_dict()
    for name in lora:
        key = f"{name}.weight"
        np.testing.assert_allclose(state[key].numpy(), folded_ref[key].numpy(), atol=1e-6,
                                   rtol=0, err_msg=key)
        assert not torch.equal(state[key], vb.state_dict()[key])  # the base is untouched
    assert set(state) == set(vb.state_dict())
    shared = [n for n, p in folded.named_parameters() if p is dict(vb.named_parameters())[n]]
    assert len(shared) == len(list(vb.parameters())) - len(lora)

    inp = _inputs(seed=4)
    kw = dict(times=torch.from_numpy(inp["times"]), cond=torch.from_numpy(inp["x"]),
              cond_drop_mask=torch.from_numpy(inp["cond_drop_mask"]))
    with torch.no_grad(), tl.lora_dense(scale):
        hooked = vb(torch.from_numpy(inp["x"]), **kw)
        plain = folded(torch.from_numpy(inp["x"]), **kw)  # no adapter left to add
    np.testing.assert_allclose(plain.numpy(), hooked.numpy(), atol=ATOL, rtol=0)


def test_fold_then_w8a16_matches_jax_fold_then_quantize():
    jvb, params, jlora = _models()
    scale = tl.lora_scale(ALPHA, RANK)
    qparams = jq.quantize_dense_params(jl.fold_lora(params, jlora, scale))
    inp = _inputs(seed=5)

    @jax.jit
    def run(p):
        with jq.quantized_dense("w8a16"):
            return jvb.apply({"params": p}, jnp.asarray(inp["x"]),
                             times=jnp.asarray(inp["times"]), cond=jnp.asarray(inp["x"]),
                             cond_drop_prob=0.0, cond_drop_mask=jnp.asarray(inp["cond_drop_mask"]),
                             train=False)

    ref = np.asarray(run(qparams))
    vb = _port(params)
    lora = lora_from_jax(jlora)
    tl.merge_lora_params(vb, lora)
    served = quantize_voicebox(tl.fold_lora(vb, lora, scale), "w8a16")
    with torch.no_grad():
        got = served(torch.from_numpy(inp["x"]), times=torch.from_numpy(inp["times"]),
                     cond=torch.from_numpy(inp["x"]),
                     cond_drop_mask=torch.from_numpy(inp["cond_drop_mask"])).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    # a quantized copy takes no adapter: its matmuls are no Linear
    with pytest.raises(TypeError, match="not a Linear"):
        tl.merge_lora_params(quantize_voicebox(vb, "w8a16"), lora)


def test_skip_combiners_are_adapted_where_jax_names_them_apart():
    """`DEFAULT_LORA_LAYERS` names `skip_combiner` and the port adapts a
    block's skip combiner by its place. The JAX package's unrolled
    transformer names them `skip_combiner_{i}`, which its exact-name match
    (`key in names`) misses (ROADMAP Queue 3); VoiceBox builds no skip
    connections, so the two sets agree on every VoiceBox."""

    class _Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.transformer = Transformer(dim=32, depth=2, dim_head=16, heads=2,
                                           use_unet_skip_connection=True)

    lora = tl.lora_init(_Holder(), rank=RANK)
    assert "transformer.layers.1.0" in lora and "transformer.layers.0.0" not in lora
    assert len(lora) == 2 * 4 + 1 and lora["transformer.layers.1.0"]["lora_a"].shape == (64, 4)
    tree = {"transformer": {"skip_combiner_1": {"kernel": jnp.ones((64, 32))},
                            "block_0": {"attn": {"to_out": {"kernel": jnp.ones((32, 32))}}}}}
    jlora = jl.lora_init(jax.random.PRNGKey(0), tree, rank=RANK)["transformer"]
    assert "skip_combiner_1" not in jlora and "to_out" in jlora["block_0"]["attn"]
