"""The port's fp32 attention backward at the edges of the fp32 K2/K3 tiling,
against the JAX package, on the CPU.

`k23_f32_edges()` lists (n, kv) at 1, one under, at and one over the 16-,
32- and 64-row tiles of the fp32 kernels, and at the duration predictor's
phoneme buckets (32, 64, 128). Each pair runs at head dims 64 and 128 and
under one of four masks: none, prefix (the predictor's text padding),
random, and a batch element whose every key is masked. The prefix and
fully-masked cases run qk-normed logits at scale 10, as the predictor's
attention does. The kernels themselves run only on the card, where
`tests/test_torch_cuda.py` and `chip_smoke.py` hold them against the plain
backward at the same shapes; here the plain backward
(`reference_attention_backward`, and the wrappers, which take it for CPU
tensors) and autograd of `flash_attention` on CPU tensors are held against
`jax.vjp` of the JAX package's `reference_attention`. The JAX Pallas
backward is not the reference here: its interpret mode takes seconds a
shape, and it gives NaN on fully-masked rows (`tests/
test_torch_flash_backward.py`), where the plain softmax gives dq = dk = 0
and dv = sum(dO) / kv.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicebox_tpu.ops.flash_attention import reference_attention as jax_reference_attention
from voicebox_tpu_torch.ops.flash_attention import (
    attention_delta,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    k23_f32_edges,
    reference_attention,
    reference_attention_backward,
)

MASKS = (None, "prefix", "random", "empty_row")
# every edge at both head dims, the masks taken in turn (shifted by one at
# d = 128, so that each pair meets two of them)
CASES = [(n, kv, d, MASKS[(i + j) % len(MASKS)])
         for j, d in enumerate((64, 128)) for i, (n, kv) in enumerate(k23_f32_edges())]
IDS = [f"n{n}-kv{kv}-d{d}-{mask}" for n, kv, d, mask in CASES]

# Tolerance, relative to the largest |gradient| of the reference: the two
# sides compute the same fp32 function with products summed in another
# order. Unit-normal logits (scale d^-0.5) keep that to a few ulps (1e-5);
# qk-normed logits at scale 10 reach 10 d, where one ulp of a logit moves
# its exp by ~1e-5 relative and dq, dk, which weigh the keys by those
# probabilities, by ~1e-4 of their largest entry (as chip_smoke.py's fp32
# K2/K3 tolerance).
TOL = {"randn": 1e-5, "qk": 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _case(n, kv, d, mask_kind):
    """numpy inputs (b = 2, h = 2) from a seed of the case, the scale, the
    inputs' kind and jax.vjp's dq, dk, dv of the JAX reference_attention."""
    rs = np.random.RandomState(1000 * n + kv + d)
    b, h = 2, 2
    q = rs.randn(b, h, n, d).astype(np.float32)
    k = rs.randn(b, h, kv, d).astype(np.float32)
    v = rs.randn(b, h, kv, d).astype(np.float32)
    do = rs.randn(b, h, n, d).astype(np.float32)
    kind = "qk" if mask_kind in ("prefix", "empty_row") else "randn"
    scale = d ** -0.5
    if kind == "qk":  # qk-normed to norm sqrt(d), scale 10: logits up to 10 d
        q, k = (x / np.linalg.norm(x, axis=-1, keepdims=True) * d ** 0.5 for x in (q, k))
        q, k = q.astype(np.float32), k.astype(np.float32)
        scale = 10.0
    mask = None
    if mask_kind == "prefix":  # ragged text lengths, the first element full
        lengths = rs.randint(max(1, kv // 3), kv + 1, size=b)
        lengths[0] = kv
        mask = np.arange(kv)[None, :] < lengths[:, None]
    elif mask_kind == "random":
        mask = rs.rand(b, kv) < 0.7
        mask[:, 0] = True
    elif mask_kind == "empty_row":
        mask = rs.rand(b, kv) < 0.7
        mask[0, 0] = True
        mask[-1] = False  # every key of the last batch element masked
    jmask = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda a, bb, c: jax_reference_attention(a, bb, c, jmask, scale),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = tuple(np.asarray(g) for g in vjp(jnp.asarray(do)))
    return (q, k, v, do, mask), scale, kind, ref


def _torch(arrays):
    return [None if a is None else torch.from_numpy(np.array(a)) for a in arrays]


def _single_key_floor(q, k, v, do, scale):
    """Bounds on |dq| and |dk| where kv = 1. A row's one real key has p = 1,
    so ds = p (dO.v - delta) scale is 0 in exact arithmetic and the
    computed dq and dk are rounding noise of the difference, which sides
    round differently: a few ulps of |dO| |v|, times scale, times |k|
    (dq) or |q| (dk). 2^-20 is 16 ulps of fp32."""
    base = 2.0 ** -20 * scale * np.linalg.norm(do, axis=-1).max() * np.linalg.norm(
        v, axis=-1).max()
    return base * np.abs(k).max(), base * np.abs(q).max()


def _check(got, ref, tol, label, floors=(0.0, 0.0, 0.0)):
    """max |got - ref| <= tol max |ref| for each of dq, dk, dv, or within
    its floor where the reference is rounding noise."""
    for name, a, r, floor in zip(("dq", "dk", "dv"), got, ref, floors):
        a = a.detach().numpy()
        assert a.dtype == np.float32 and np.isfinite(a).all(), f"{label} {name}"
        bound = max(tol * np.abs(r).max(), floor)
        err = np.abs(a - r).max()
        assert err <= bound, f"{label} {name}: max |err| {err:.3e} > {bound:.3e}"


def _floors(arrays, scale):
    q, k, v, do, _ = arrays
    return (*_single_key_floor(q, k, v, do, scale), 0.0) if k.shape[2] == 1 else (0.0,) * 3


@pytest.mark.parametrize("n,kv,d,mask_kind", CASES, ids=IDS)
def test_plain_backward_matches_jax_at_tile_edges(n, kv, d, mask_kind):
    arrays, scale, kind, ref = _case(n, kv, d, mask_kind)
    q, k, v, do, mask = _torch(arrays)
    out, lse = reference_attention(q, k, v, mask, scale, return_lse=True)
    got = reference_attention_backward(q, k, v, mask, out, lse, do, scale)
    _check(got, ref, TOL[kind], "plain backward", _floors(arrays, scale))
    # the wrappers take the plain version for CPU tensors, launching nothing
    delta = attention_delta(do, out)
    before = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    wrapped = (flash_attention_bwd_dq(q, k, v, mask, do, lse, delta, scale),
               *flash_attention_bwd_dkv(q, k, v, mask, do, lse, delta, scale))
    assert (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches) == before
    for a, b in zip(wrapped, got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    if mask_kind == "empty_row":  # the plain softmax's gradient, exactly
        dq, dk, dv = got
        assert torch.count_nonzero(dq[-1]) == 0 and torch.count_nonzero(dk[-1]) == 0
        want = (do[-1].sum(dim=1, keepdim=True) / kv).expand_as(dv[-1])
        torch.testing.assert_close(dv[-1], want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n,kv,d,mask_kind", CASES, ids=IDS)
def test_cpu_autograd_matches_jax_at_tile_edges(n, kv, d, mask_kind):
    arrays, scale, kind, ref = _case(n, kv, d, mask_kind)
    q, k, v, do, mask = _torch(arrays)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    flash_attention(*leaves, mask, scale).backward(do)
    _check([t.grad for t in leaves], ref, TOL[kind], "autograd of flash_attention",
           _floors(arrays, scale))


def test_edges_cover_each_tile_size_and_bucket():
    """Every edge the tiling has is in the list, on both sides: n and kv
    each take 1, one under, at and one over 16 (head dim 256's streamed
    tiles), 32 and 64, and 128."""
    edges = k23_f32_edges()
    want = {1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 128}
    assert {n for n, _ in edges} == want and {kv for _, kv in edges} == want
