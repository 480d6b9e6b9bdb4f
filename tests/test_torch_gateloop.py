"""The port's GateLoop against the JAX package's, on the CPU in float32:

* `gated_linear_recurrence` (chunked log-space scan) against the JAX
  associative scan at lengths around its 64-step chunks and, at 256 steps,
  under gates closed for 32 steps and then open, and under wide normal
  gate logits; outputs at atol 2e-4 and gradients at cosine > 0.999 and
  atol 2e-3;
* `SimpleGateLoopLayer` outputs and parameter gradients;
* the `Transformer`'s GateLoop slot (`layers.{i}.1.*`, through
  `transformer_state_dict`) with a key mask, and the flag on VoiceBox and
  the duration predictor.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import _assert_leaves_close
from test_torch_transformer import _perturbed, _xla_inv_freq
from voicebox_tpu.models import primitives as jp
from voicebox_tpu.models.transformer import Transformer as JaxTransformer
from voicebox_tpu.ops.gateloop import gated_linear_recurrence as jax_recurrence
from voicebox_tpu_torch.models.duration import DurationPredictorNet
from voicebox_tpu_torch.models.primitives import SimpleGateLoopLayer
from voicebox_tpu_torch.models.transformer import Transformer
from voicebox_tpu_torch.models.voicebox import VoiceBox
from voicebox_tpu_torch.ops.gateloop import gated_linear_recurrence
from voicebox_tpu_torch.utils.convert import transformer_state_dict

ATOL = 2e-4
DIM = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@jax.jit
def _jax_vjp(a, x, g):
    out, vjp = jax.vjp(jax_recurrence, a, x)
    return out, vjp(g)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 200])
def test_recurrence_and_its_gradient_match_jax(n):
    rs = np.random.RandomState(n)
    a = (1 / (1 + np.exp(-2 * rs.randn(2, n, 3)))).astype(np.float32)
    x = rs.randn(2, n, 3).astype(np.float32)
    g = rs.randn(2, n, 3).astype(np.float32)
    ref, (ref_da, ref_dx) = _jax_vjp(jnp.asarray(a), jnp.asarray(x), jnp.asarray(g))
    ta = torch.tensor(a, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    out = gated_linear_recurrence(ta, tx)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    out.backward(torch.from_numpy(g))
    if n == 1:  # s_0 = 0: the gate has no gradient on either side
        assert not ta.grad.any() and not np.asarray(ref_da).any()
        _assert_leaves_close({"x": tx.grad.numpy()}, {"x": np.asarray(ref_dx)})
    else:
        _assert_leaves_close({"a": ta.grad.numpy(), "x": tx.grad.numpy()},
                             {"a": np.asarray(ref_da), "x": np.asarray(ref_dx)})


def _gate_logits(schedule, rs, shape):
    """Gate logits g over (batch, 256 steps, channels): closed gates (-20)
    for steps 0-31 and then open ones, or normal draws."""
    if schedule == "closed_then_9":
        g = np.full(shape, 9.0)
    elif schedule == "closed_then_n4":
        g = rs.normal(4.0, 1.0, shape)
    else:
        return rs.normal(0.0, {"n0_6": 6.0, "n0_1": 1.0}[schedule], shape).astype(np.float32)
    g[:, :32] = -20.0
    return g.astype(np.float32)


@pytest.mark.parametrize("schedule", ["closed_then_9", "closed_then_n4", "n0_6", "n0_1"])
def test_recurrence_keeps_precision_after_closed_gates(schedule):
    """Closed gates drive a chunk's running sum of log a to ~-640; each
    in-chunk decay is summed over its own steps, so the outputs keep the
    JAX scan's precision (a difference of running sums read 4.4e-4)."""
    rs = np.random.RandomState(7)
    g = _gate_logits(schedule, rs, (2, 256, 8))
    a = (1 / (1 + np.exp(-g.astype(np.float64)))).astype(np.float32)  # as the layer's sigmoid
    x = rs.randn(2, 256, 8).astype(np.float32)
    dout = rs.randn(2, 256, 8).astype(np.float32)
    ref, (ref_da, ref_dx) = _jax_vjp(jnp.asarray(a), jnp.asarray(x), jnp.asarray(dout))
    ta = torch.tensor(a, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    out = gated_linear_recurrence(ta, tx)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    out.backward(torch.from_numpy(dout))
    _assert_leaves_close({"a": ta.grad.numpy(), "x": tx.grad.numpy()},
                         {"a": np.asarray(ref_da), "x": np.asarray(ref_dx)})


def test_recurrence_along_another_axis_and_closed_gates():
    rs = np.random.RandomState(0)
    a = rs.uniform(0.0, 1.0, (70, 2)).astype(np.float32)
    a[10] = 0.0  # a closed gate forgets the state before it
    x = rs.randn(70, 2).astype(np.float32)
    ref = np.zeros_like(x)
    s = np.zeros(2, np.float64)
    for t in range(70):
        s = a[t] * s + x[t]
        ref[t] = s
    out = gated_linear_recurrence(torch.from_numpy(a), torch.from_numpy(x), dim=0)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def _layer_state(tree):
    return {"norm.gamma": torch.from_numpy(np.array(tree["norm"]["gamma"])),
            "to_qkva.weight": torch.from_numpy(np.array(tree["to_qkva"]["kernel"]).T.copy()),
            "post_norm.weight": torch.from_numpy(np.array(tree["post_norm"]["scale"])),
            "post_norm.bias": torch.from_numpy(np.array(tree["post_norm"]["bias"]))}


def test_layer_outputs_and_gradients_match_jax():
    layer = jp.SimpleGateLoopLayer(dim=DIM)
    x = np.random.RandomState(1).randn(2, 70, DIM).astype(np.float32)
    params = _perturbed(jax.jit(layer.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"],
                        np.random.RandomState(2))

    def loss(p, x):
        return jnp.sum(jnp.sin(layer.apply({"params": p}, x)))

    ref = np.asarray(jax.jit(layer.apply)({"params": params}, jnp.asarray(x)))
    grads = jax.jit(jax.grad(loss))(params, jnp.asarray(x))
    ours = SimpleGateLoopLayer(DIM)
    ours.load_state_dict(_layer_state(params), strict=True)
    out = ours(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL, rtol=0)
    out.sin().sum().backward()
    got = {k: p.grad.numpy() for k, p in ours.named_parameters()}
    _assert_leaves_close(got, {k: v.numpy() for k, v in _layer_state(
        jax.tree.map(np.asarray, grads)).items()})


@functools.cache
def _transformers():
    jt = JaxTransformer(dim=DIM, depth=2, heads=2, dim_head=8, use_gateloop_layers=True)
    x = np.random.RandomState(3).randn(2, 40, DIM).astype(np.float32)
    params = _perturbed(jax.jit(jt.init)(jax.random.PRNGKey(1), jnp.asarray(x))["params"],
                        np.random.RandomState(4))
    tt = Transformer(dim=DIM, depth=2, heads=2, dim_head=8, use_gateloop_layers=True)
    tt.load_state_dict(_xla_inv_freq(transformer_state_dict(params, dim_head=8)), strict=True)
    return jt, params, tt, x


def test_transformer_gateloop_slot_matches_jax():
    jt, params, tt, x = _transformers()
    mask = np.ones((2, 40), bool)
    mask[1, 25:] = False
    ref = np.asarray(jax.jit(jt.apply)({"params": params}, jnp.asarray(x),
                                       mask=jnp.asarray(mask)))
    with torch.no_grad():
        out = tt(torch.from_numpy(x), mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out[0], ref[0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(out[1, :25], ref[1, :25], atol=ATOL, rtol=0)
    assert "layers.0.1.to_qkva.weight" in tt.state_dict()


def test_flag_on_voicebox_and_duration_predictor():
    vb = VoiceBox(num_cond_tokens=10, dim_in=8, dim=DIM, depth=2, heads=2, dim_head=8,
                  dim_cond_emb=8, num_register_tokens=2, use_gateloop_layers=True)
    dp = DurationPredictorNet(num_phoneme_tokens=10, dim_phoneme_emb=8, dim=DIM, depth=2,
                              heads=2, dim_head=8, use_gateloop_layers=True)
    for model in (vb, dp):
        keys = model.state_dict()
        assert all(f"transformer.layers.{i}.1.post_norm.bias" in keys for i in range(2))
    out = vb(torch.randn(1, 12, 8), times=torch.rand(1), cond=torch.randn(1, 12, 8),
             cond_token_ids=torch.zeros(1, 12).long())
    assert out.shape == (1, 12, 8) and bool(torch.isfinite(out).all())
