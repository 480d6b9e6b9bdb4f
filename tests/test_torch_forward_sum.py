"""The port's forward-sum loss (`ops/forward_sum.py`, `F.ctc_loss`) against
the JAX package's (`optax.ctc_loss`), on the CPU in float32: the loss at
atol 2e-4 and its gradient with respect to the log-probabilities per
element at atol 2e-3 with cosine > 0.999, on ragged key and query lengths,
including a row that cannot align (key_len > query_len: loss 0 and a zero,
finite gradient)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicebox_tpu.ops.forward_sum import forward_sum_loss as jax_forward_sum_loss
from voicebox_tpu_torch.ops.forward_sum import forward_sum_loss

_jax_value_and_grad = jax.jit(jax.value_and_grad(jax_forward_sum_loss))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, b, t_mel, t_ph):
    rs = np.random.RandomState(seed)
    logits = rs.randn(b, 1, t_mel, t_ph).astype(np.float32) * 2
    logprob = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    return logprob.astype(np.float32)


@pytest.mark.parametrize("key_lens,query_lens", [
    ([6, 3, 1], [20, 11, 7]),
    ([6, 9, 4], [20, 8, 4]),  # row 1 cannot align: 9 phonemes over 8 frames
])
def test_loss_and_gradient_match_jax(key_lens, query_lens):
    b, t_mel, t_ph = 3, 20, 9
    lp = _inputs(sum(key_lens), b, t_mel, t_ph)
    kl, ql = np.array(key_lens, np.int32), np.array(query_lens, np.int32)
    ref, ref_grad = _jax_value_and_grad(jnp.asarray(lp), jnp.asarray(kl), jnp.asarray(ql))
    x = torch.from_numpy(lp).requires_grad_()
    loss = forward_sum_loss(x, torch.from_numpy(kl), torch.from_numpy(ql))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), atol=2e-4, rtol=0)
    g, r = x.grad.numpy().astype(np.float64), np.asarray(ref_grad, np.float64)
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, r, atol=2e-3, rtol=0)
    cos = (g * r).sum() / (np.linalg.norm(g) * np.linalg.norm(r))
    assert cos > 0.999
    infeasible = kl > ql
    assert (g[infeasible] == 0).all()
    # (b, t_mel, t_ph) is the same loss as (b, 1, t_mel, t_ph)
    assert forward_sum_loss(torch.from_numpy(lp[:, 0]), torch.from_numpy(kl),
                            torch.from_numpy(ql)).item() == loss.item()
