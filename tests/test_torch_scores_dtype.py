"""`attn_scores_dtype` / `scores_dtype`: the JAX package's opt-in bf16 score
matrix, in the port's plain attention and its modules, against the JAX
package on the CPU.

* `reference_attention(scores_dtype=torch.bfloat16)` against JAX's
  `reference_attention(scores_dtype=jnp.bfloat16)`, masked and unmasked, at
  the default scale and qk-norm's 10, with and without an injected dropout
  keep mask. Tolerances in bf16 ulps (`ULP` = 2^-7, bf16's spacing at 1):
  each probability within one ulp of its own magnitude (v = identity makes
  out the probabilities); out within one ulp of a unit probability times
  max |v| (a probability one ulp off moves out by at most that); dq and dk
  within `GRAD_ULPS` ulps of their largest entry (the backward's bf16 sums
  cancel, and XLA's bf16 reduction orders its sum otherwise than torch),
  dv within fp32 rounding. The fp32 scores move out a hundredfold further
  from JAX's bf16 path than the port's bf16 path does.
* `flash_attention` passes `scores_dtype` to the plain version on CPU
  tensors, also inside a block whose remat policy saves K1's outputs.
* `VoiceBox(attn_scores_dtype=torch.bfloat16, attn_dropout=0.25)` in
  training (its loss and every gradient leaf) against JAX's under jit, with
  the keep masks injected on both sides (`jax.random.bernoulli` and the
  port's `uniform`, each replaced by the same masks in layer order); the
  loss within 4 ulps, each leaf at cosine > 0.999 and within `GRAD_ULPS`
  ulps of its largest entry (+ 2e-3).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_transformer import _perturbed, _xla_inv_freq
from voicebox_tpu import VoiceBox as JaxVoiceBox
from voicebox_tpu.ops.flash_attention import reference_attention as jax_reference_attention
from voicebox_tpu.utils.port_weights import load_voicebox_torch
from voicebox_tpu_torch import VoiceBox
from voicebox_tpu_torch.ops import flash_attention as fa
from voicebox_tpu_torch.ops.remat import remat_call
from voicebox_tpu_torch.utils.convert import voicebox_state_dict

ULP = 2.0 ** -7  # bf16's spacing at 1: 8 significant bits
GRAD_ULPS = 4
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


def _t(a):
    return torch.from_numpy(np.array(a))


def _ulp_of(x):
    """bf16's spacing at each |x| (at the smallest normal below it)."""
    mag = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _attention_inputs(seed, b=2, h=3, n=40, kv=37, d=40, identity_v=False):
    rs = np.random.RandomState(seed)
    q, k = rs.randn(b, h, n, d).astype(np.float32), rs.randn(b, h, kv, d).astype(np.float32)
    if identity_v:
        v = np.broadcast_to(np.eye(kv, d, dtype=np.float32), (b, h, kv, d)).copy()
    else:
        v = rs.randn(b, h, kv, d).astype(np.float32)
    do = rs.randn(b, h, n, d).astype(np.float32)
    mask = rs.rand(b, kv) > 0.3
    mask[:, 0] = True
    return q, k, v, do, mask


def _both(q, k, v, do, mask, scale, p):
    """out and (dq, dk, dv) of JAX's plain attention and the port's, the
    JAX keep mask handed to the port."""
    key = jax.random.PRNGKey(7)
    keep = np.asarray(jax.random.bernoulli(key, 1.0 - p, q.shape[:3] + k.shape[2:3])) if p else None
    jmask = None if mask is None else jnp.asarray(mask)

    def jax_fn(q, k, v):
        return jax_reference_attention(q, k, v, mask=jmask, scale=scale, dropout=p,
                                       dropout_rng=key if p else None,
                                       scores_dtype=jnp.bfloat16)

    # eager: each primitive rounds its bf16 result, the program's own order
    # (under jit XLA may keep a fusion's intermediates in fp32)
    ref, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in (q, k, v)))
    ref_grads = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    qkv = [_t(a).requires_grad_() for a in (q, k, v)]
    out = fa.reference_attention(*qkv, None if mask is None else _t(mask), scale, dropout=p,
                                 keep=None if keep is None else _t(keep),
                                 scores_dtype=torch.bfloat16)
    out.backward(_t(do))
    return (out.detach().numpy(), np.asarray(ref), [t.grad.numpy() for t in qkv], ref_grads,
            keep)


@pytest.mark.parametrize("p", [0.0, 0.3], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("scale", [None, 10.0], ids=["default_scale", "qk_scale"])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_plain_bf16_scores_match_jax(masked, scale, p):
    q, k, v, do, mask = _attention_inputs(1)
    if scale == 10.0:  # qk-norm's bounded logits: |q| = |k| = 1, |sim| <= 10
        q, k = (a / np.linalg.norm(a, axis=-1, keepdims=True) for a in (q, k))
    out, ref, grads, ref_grads, keep = _both(q, k, v, do, mask if masked else None, scale, p)
    out_tol = ULP * np.abs(v).max() / (1.0 - p)
    np.testing.assert_allclose(out, ref, atol=out_tol, rtol=0)
    for name, got, want in zip("qk", grads[:2], ref_grads[:2]):
        gap = np.abs(got - want).max()
        assert gap <= GRAD_ULPS * ULP * np.abs(want).max(), (name, gap, np.abs(want).max())
    np.testing.assert_allclose(grads[2], ref_grads[2], atol=1e-5, rtol=1e-5)
    # the option acts: fp32 scores move out a hundredfold further from JAX's
    # bf16 path than the port's bf16 path does
    f32 = fa.reference_attention(_t(q), _t(k), _t(v), _t(mask) if masked else None, scale,
                                 dropout=p, keep=None if keep is None else _t(keep))
    assert np.abs(f32.numpy() - ref).max() > 100 * max(np.abs(out - ref).max(), 1e-7)


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_plain_bf16_probabilities_within_one_ulp_of_jax(masked):
    """With v the identity (kv <= d), out is the probabilities themselves."""
    q, k, v, do, mask = _attention_inputs(2, identity_v=True)
    out, ref, *_ = _both(q, k, v, do, mask if masked else None, 0.7, 0.0)
    assert (np.abs(out - ref) <= _ulp_of(ref)).all(), np.abs(out - ref).max()
    if masked:  # masked keys get no weight
        assert (out[0, ..., :mask.shape[1]][..., ~mask[0]] == 0).all()


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat_attn_out_lse"])
def test_flash_attention_hands_scores_dtype_to_the_plain_version_on_the_cpu(remat):
    q, k, v, do, mask = _attention_inputs(3)
    args = [_t(a) for a in (q, k, v)]

    def run(scores):
        qkv = [a.clone().requires_grad_() for a in args]

        def fn(q, k, v):
            return fa.flash_attention(q, k, v, mask=_t(mask), scale=10.0, scores_dtype=scores)

        out = remat_call(fn, *qkv, policy="attn_out+attn_lse") if remat else fn(*qkv)
        out.backward(_t(do))
        return out.detach(), [a.grad for a in qkv]

    plain = [a.clone().requires_grad_() for a in args]
    want = fa.reference_attention(*plain, _t(mask), 10.0, scores_dtype=torch.bfloat16)
    want.backward(_t(do))
    got, grads = run(torch.bfloat16)
    assert torch.equal(got, want.detach())
    for g, p in zip(grads, plain):
        assert torch.equal(g, p.grad)
    f32, _ = run(None)
    assert torch.equal(f32, fa.reference_attention(*args, _t(mask), 10.0))
    assert not torch.equal(f32, got)


# ---------------------------------------------------------------------------
# modules

B, N, N_REG = 2, 124, 4  # 124 frames + 4 registers = 128 tokens: no lane padding in JAX
SMALL = dict(num_cond_tokens=20, dim_cond_emb=16, dim=32, depth=2, dim_head=8, heads=4,
             num_register_tokens=N_REG, attn_qk_norm=True, dim_in=8)


def _jax_params(config, seed=0):
    """A JAX parameter tree: the port's initialisation under `seed` read into
    the JAX layout by the JAX package's `load_voicebox_torch` (its template
    from `eval_shape`, no compile), every leaf perturbed."""
    d = config["dim_in"]
    template = jax.eval_shape(functools.partial(JaxVoiceBox(**config).init, cond_drop_prob=0.0),
                              {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 8, d)),
                              times=jnp.zeros((1,)), cond=jnp.zeros((1, 8, d)),
                              cond_token_ids=jnp.zeros((1, 8), jnp.int32))["params"]
    torch.manual_seed(seed)
    params = load_voicebox_torch(VoiceBox(**config).state_dict(), template)
    return _perturbed(params, np.random.RandomState(seed))


def _voicebox_inputs(d_in, seed=1):
    rs = np.random.RandomState(seed)
    return dict(
        x=rs.randn(B, N, d_in).astype(np.float32),
        cond=rs.randn(B, N, d_in).astype(np.float32),
        times=rs.rand(B).astype(np.float32),
        cond_token_ids=rs.randint(0, 20, (B, N)).astype(np.int32),
        cond_mask=rs.rand(B, N) < 0.6,
        target=rs.randn(B, N, d_in).astype(np.float32),
    )


def _port(config, params, **kw):
    port = VoiceBox(**config, **kw)
    port.load_state_dict(_xla_inv_freq(voicebox_state_dict(params), "transformer."))
    return port


def _cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return (a @ b) / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("scores", ["bf16", "f32"])
def test_voicebox_training_with_dropout_matches_jax(scores, monkeypatch):
    """The masked-MSE loss and every gradient leaf of a VoiceBox in training
    with attention dropout 0.25, the keep masks drawn once and injected into
    both packages in layer order."""
    p = 0.25
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if scores == "bf16" else (None, None)
    config = SMALL
    params = _jax_params(config)
    inp = _voicebox_inputs(config["dim_in"])
    tokens = N + N_REG
    rs = np.random.RandomState(5)
    keeps = [rs.rand(B, config["heads"], tokens, tokens) >= p for _ in range(config["depth"])]

    calls = {"jax": 0, "port": 0}

    def fake_bernoulli(key, prob, shape):
        keep = keeps[calls["jax"]]
        calls["jax"] += 1
        assert tuple(shape) == keep.shape and abs(prob - (1 - p)) < 1e-9
        return jnp.asarray(keep)

    def fake_uniform(shape, generator, device):
        keep = keeps[calls["port"]]
        calls["port"] += 1
        assert tuple(shape) == keep.shape
        return torch.from_numpy(np.where(keep, 0.0, 1.0).astype(np.float32))

    monkeypatch.setattr(jax.random, "bernoulli", fake_bernoulli)
    monkeypatch.setattr(fa, "uniform", fake_uniform)

    jvb = JaxVoiceBox(**config, attn_dropout=p, attn_scores_dtype=jdt)
    j_inp = {k: jnp.asarray(v) for k, v in inp.items()}

    def jax_loss(params):
        return jvb.apply({"params": params}, j_inp["x"], times=j_inp["times"],
                         cond_token_ids=j_inp["cond_token_ids"], cond=j_inp["cond"],
                         cond_mask=j_inp["cond_mask"], target=j_inp["target"],
                         cond_drop_prob=0.0, train=True, rngs={"dropout": jax.random.PRNGKey(0)})

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    assert calls["jax"] == config["depth"]
    ref_sd = voicebox_state_dict(jax.tree.map(np.asarray, ref_grads))

    port = _port(config, params, attn_dropout=p, attn_scores_dtype=tdt)
    t_inp = {k: _t(v) for k, v in inp.items()}
    loss = port(t_inp["x"], times=t_inp["times"], cond_token_ids=t_inp["cond_token_ids"],
                cond=t_inp["cond"], cond_mask=t_inp["cond_mask"], target=t_inp["target"],
                cond_drop_mask=torch.zeros(B, dtype=torch.bool), train=True,
                generator=torch.Generator().manual_seed(0))
    loss.backward()
    assert calls["port"] == config["depth"]
    loss_tol = 4 * ULP * abs(float(ref_loss)) if scores == "bf16" else ATOL
    assert abs(loss.item() - float(ref_loss)) <= loss_tol, (loss.item(), float(ref_loss))
    for name, param in port.named_parameters():
        if param.grad is None:
            continue
        want = ref_sd[name].numpy()
        assert _cosine(param.grad.numpy(), want) > 0.999, name
        np.testing.assert_allclose(param.grad.numpy(), want, atol=2e-3 if scores == "f32"
                                   else GRAD_ULPS * ULP * np.abs(want).max() + 2e-3, rtol=0,
                                   err_msg=name)
