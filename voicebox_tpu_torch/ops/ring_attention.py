"""Ring attention: bidirectional attention with the sequence split over a
process group.

Counterpart of `voicebox_tpu/ops/ring_attention.py`. Each rank holds a
shard of the query, key and value rows; the rank's key/value block passes
round the ring (`parallel/collectives.py::ring_shift`, JAX's `ppermute`),
so after `world - 1` passes every query has met every key, and the
per-block results merge by their log-sum-exp, in fp32.

* `ring_attention(q, k, v, mask, scale, group)`: the rank's rows attend to
  every rank's; `mask` is the key-padding mask of the rank's keys.
* `ring_attention_prefixed(q, k, v, num_prefix, ...)`: the first
  `num_prefix` rows (the registers) are a prefix replicated on every rank.
  They are keys held locally, merged once (with the rank's own keys, in
  one block) and never passed; the prefix rows' outputs, computed on every
  rank with the blocks merged in another order, are averaged over the group
  (JAX's `pmean`, with its transpose in the backward). Returns
  `(out_prefix, out_local)`, as the JAX function does.

On CUDA tensors each block is one K1 launch (`flash_attention._launch_k1`,
out and lse; q holds p + n_local rows while a passed block holds n_local
keys, so K1 runs with n != kv), inside an autograd Function whose
backward computes delta = rowsum(dO * O) once from the merged output, then
K2 and K3 per block against the merged lse and that delta (the global
softmax's probabilities, block by block), re-passing the blocks round the
ring; the gradient of a passed block's keys and values travels with it and
is handed back to its owner (`_kernel_ring`). On CPU tensors each block is
the plain `reference_attention` and autograd differentiates the same merge
through differentiable passes: the plain version of the whole ring
(`_plain_ring`). `_ROUTES` maps a device type to its route: the CPU tests
run `_kernel_ring` on CPU tensors, where each of its kernels is its plain
version, and `chip_smoke.py` runs `_plain_ring` on the card's tensors, to
hold each route against the other.

A batch row whose keys in one block are all padding gets K1's empty row
there (out = mean(V), lse = fill + log(kv), which rounds to the fill): its
merge weight exp(lse - max) underflows to 0 beside any block with a real
key, and the merged lse is that of the real keys, so K2 / K3 take their
ordinary branch. A row with no real key in any block keeps the plain
version's answer, the mean of the blocks' means, with K2 / K3's empty-row
branch scaled to it. K1's output is rounded to q's dtype before the merge:
in bf16 that adds one rounding of each block's output, against the one
rounding of a single launch on the gathered sequence.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..parallel.collectives import mean_over_group, ring_shift
from . import flash_attention as fa

__all__ = ["ring_attention", "ring_attention_prefixed"]


def _world(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _merge(outs, lses):
    """The blocks' (out, lse (b, h, 1, n)) merged by lse: (out fp32, lse)."""
    lse = torch.stack([t.squeeze(2) for t in lses])  # (blocks, b, h, n)
    top = lse.max(dim=0).values
    w = torch.exp(lse - top)
    z = w.sum(dim=0)
    out = sum(o.float() * (wi / z)[..., None] for o, wi in zip(outs, w))
    return out, (top + torch.log(z)).unsqueeze(2)


class _Shift(torch.autograd.Function):
    """ring_shift, differentiable: the gradient goes back the other way."""

    @staticmethod
    def forward(ctx, t, group, shift):
        ctx.group, ctx.shift = group, shift
        return ring_shift(t, group, shift)

    @staticmethod
    def backward(ctx, g):
        return ring_shift(g.contiguous(), ctx.group, -ctx.shift), None, None


def _plain_ring(q, k, v, mask, p, scale, group):
    """The plain version: reference_attention per block, the same merge."""
    k_loc, v_loc = k[:, :, p:], v[:, :, p:]
    m_loc = None if mask is None else mask[:, p:]
    outs, lses = [], []
    out, lse = fa.reference_attention(q, k, v, mask, scale, return_lse=True)
    outs.append(out)
    lses.append(lse)
    for _ in range(_world(group) - 1):
        k_loc, v_loc = _Shift.apply(k_loc, group, 1), _Shift.apply(v_loc, group, 1)
        if m_loc is not None:
            m_loc = ring_shift(m_loc, group, 1)
        out, lse = fa.reference_attention(q, k_loc, v_loc, m_loc, scale, return_lse=True)
        outs.append(out)
        lses.append(lse)
    return _merge(outs, lses)[0].to(q.dtype)


def _block(q, k, v, mask, scale):
    """One block's (out, lse): K1 on CUDA tensors, its plain version on CPU
    tensors."""
    if q.device.type == "cpu":
        return fa.reference_attention(q, k, v, mask, scale, return_lse=True)
    return fa._launch_k1(q, k, v, mask, scale)


class _RingAttention(torch.autograd.Function):
    """K1 per block forward; delta, then K2 + K3 per block backward. The
    rank's own block is the prefix keys (pk, pv; None without a prefix)
    joined to its keys (k_loc, v_loc), which alone travel."""

    @staticmethod
    def forward(ctx, q, pk, pv, k_loc, v_loc, m_own, m_loc, scale, p, group):
        k_own = k_loc if p == 0 else torch.cat([pk, k_loc], dim=2)
        v_own = v_loc if p == 0 else torch.cat([pv, v_loc], dim=2)
        outs, lses = [], []
        out, lse = _block(q, k_own, v_own, m_own, scale)
        outs.append(out)
        lses.append(lse)
        kt, vt, mt = k_loc, v_loc, m_loc
        for _ in range(_world(group) - 1):
            kv = ring_shift(torch.stack([kt, vt]), group, 1)
            kt, vt = kv[0], kv[1]
            mt = None if mt is None else ring_shift(mt, group, 1)
            out, lse = _block(q, kt, vt, mt, scale)
            outs.append(out)
            lses.append(lse)
        merged, lse = _merge(outs, lses)
        out = merged.to(q.dtype)
        ctx.save_for_backward(q, k_own, v_own, m_own, k_loc, v_loc, m_loc, out, lse)
        ctx.scale, ctx.prefix, ctx.group = scale, p, group
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k_own, v_own, m_own, k_loc, v_loc, m_loc, out, lse = ctx.saved_tensors
        scale, p, group = ctx.scale, ctx.prefix, ctx.group
        world = _world(group)
        do = dout.contiguous()
        if p == 0 and m_own is not None and world > 1:
            # rows without a real key anywhere: the mean of the blocks' means
            empty = (lse < fa.MASK_FILL / 2).transpose(2, 3)  # (b, h, n, 1)
            do = torch.where(empty, do / world, do).contiguous()
        delta = fa.attention_delta(do, out)
        dq = fa.flash_attention_bwd_dq(q, k_own, v_own, m_own, do, lse, delta, scale).float()
        dk_own, dv_own = fa.flash_attention_bwd_dkv(q, k_own, v_own, m_own, do, lse, delta,
                                                    scale)
        acc = torch.stack([dk_own[:, :, p:], dv_own[:, :, p:]]).float()
        kt, vt, mt = k_loc, v_loc, m_loc
        for _ in range(world - 1):
            kv = ring_shift(torch.stack([kt, vt]), group, 1)
            kt, vt = kv[0], kv[1]
            mt = None if mt is None else ring_shift(mt, group, 1)
            dq += fa.flash_attention_bwd_dq(q, kt, vt, mt, do, lse, delta, scale).float()
            dk, dv = fa.flash_attention_bwd_dkv(q, kt, vt, mt, do, lse, delta, scale)
            acc = ring_shift(acc, group, 1) + torch.stack([dk, dv]).float()
        if world > 1:  # every rank's share of a block's gradient, home to its owner
            acc = ring_shift(acc, group, 1)
        dpk, dpv = (None, None) if p == 0 else (dk_own[:, :, :p], dv_own[:, :, :p])
        return (dq.to(q.dtype), dpk, dpv, acc[0].to(k_loc.dtype), acc[1].to(v_loc.dtype),
                None, None, None, None, None)


def _kernel_ring(q, k, v, mask, p, scale, group):
    """`_RingAttention` on the rank's own block and the travelling keys."""
    k_loc, v_loc = k[:, :, p:].contiguous(), v[:, :, p:].contiguous()
    m_loc = None if mask is None else mask[:, p:].contiguous()
    pk = pv = None
    if p:
        pk, pv = k[:, :, :p], v[:, :, :p]
    return _RingAttention.apply(q.contiguous(), pk, pv, k_loc, v_loc,
                                None if mask is None else mask.contiguous(), m_loc,
                                scale, p, group)


_ROUTES = {"cpu": _plain_ring, "cuda": _kernel_ring}


def _ring(q, k, v, mask, num_prefix, scale, group):
    """Attention of q against the rank's keys (prefix included) and every
    other rank's non-prefix keys."""
    if q.device.type not in _ROUTES:
        raise ValueError(f"no ring attention path for device {q.device}")
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    return _ROUTES[q.device.type](q, k, v, mask, num_prefix, scale, group)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor] = None, scale: Optional[float] = None,
                   group=None) -> torch.Tensor:
    """q, k, v (b, h, n_local, d): the rank's rows of a sequence split over
    `group`; mask (b, n_local) its keys' padding mask (True = keep). Equals
    `reference_attention` on the gathered sequence, the rank's rows."""
    return _ring(q, k, v, mask, 0, scale, group)


def ring_attention_prefixed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            num_prefix: int, mask: Optional[torch.Tensor] = None,
                            scale: Optional[float] = None, group=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v (b, h, p + n_local, d): the replicated prefix's rows, then the
    rank's; mask (b, p + n_local), True on the prefix. Returns (the prefix
    rows' output averaged over the group (b, h, p, d), the rank's rows'
    (b, h, n_local, d))."""
    assert num_prefix > 0, "use ring_attention when there is no prefix"
    out = _ring(q, k, v, mask, num_prefix, scale, group)
    out_prefix = out[:, :, :num_prefix]
    if group is not None and _world(group) > 1:
        out_prefix = mean_over_group(out_prefix, group).to(q.dtype)
    return out_prefix, out[:, :, num_prefix:]
