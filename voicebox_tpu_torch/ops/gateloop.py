"""The gated linear recurrence of the GateLoop layer, in torch ops.

Counterpart of `voicebox_tpu/ops/gateloop.py`, which runs

    s_t = a_t * s_{t-1} + x_t        (s_0 = 0, per channel)

as one `jax.lax.associative_scan`. Here it runs in log space, in fp32,
chunked: with S(j, t] the sum of log a over the steps j < i <= t of a chunk
of 64 steps,

    s_t = sum_{j <= t in the chunk} exp(S(j, t]) x_j + exp(S(start, t]) s_start,

where every exponent is <= 0. Each S(j, t] is summed over its own steps
(a masked cumulative sum), never taken as the difference of two running
sums: once closed gates drive a running sum to ~-640, such a difference
keeps only ~6e-5 of absolute precision. The first term is one (64, 64)
masked product per chunk, the second a loop over the chunks carrying the
state at each chunk's end: a few launches per 64 steps, not one per step.
The gate comes in as log a (`gated_linear_recurrence_log`; the layer
passes log sigmoid(g) = -softplus(-g)), clamped at -100 (a gate below
e^-100 acts as 0), or as a > 0 (`gated_linear_recurrence`). Returns x's
dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["CHUNK", "gated_linear_recurrence", "gated_linear_recurrence_log"]

CHUNK = 64
_LOG_FLOOR = -100.0


def gated_linear_recurrence_log(log_a: torch.Tensor, x: torch.Tensor, dim: int = 1,
                                chunk: int = CHUNK) -> torch.Tensor:
    """s_t = exp(log_a_t) s_{t-1} + x_t along `dim` (s_0 = 0)."""
    dtype = x.dtype
    la = log_a.float().clamp_min(_LOG_FLOOR).movedim(dim, -1)
    xs = x.float().movedim(dim, -1)
    *lead, n = xs.shape
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    if pad:  # padded steps sit after the last real one and are cut off
        la, xs = F.pad(la, (0, pad)), F.pad(xs, (0, pad))
    la = la.reshape(*lead, n_chunks, chunk)
    xs = xs.reshape(*lead, n_chunks, chunk)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    # [t, j] = S(j, t]: log a_i at [i, j] for i > j, summed down the rows
    steps = la[..., :, None].expand(*la.shape, chunk).masked_fill(~causal.tril(-1), 0.0)
    seg = steps.cumsum(dim=-2).masked_fill(~causal, float("-inf")).exp()
    out = (seg @ xs[..., None])[..., 0]  # each chunk from a zero state
    decay = la.cumsum(dim=-1).exp()  # exp(S(start, t]): what is left of the entering state
    state = torch.zeros(lead, device=x.device)
    chunks = []
    for c in range(n_chunks):
        o = out[..., c, :] + decay[..., c, :] * state[..., None]
        chunks.append(o)
        state = o[..., -1]
    out = torch.stack(chunks, dim=-2).reshape(*lead, n_chunks * chunk)[..., :n]
    return out.movedim(-1, dim).to(dtype)


def gated_linear_recurrence(a: torch.Tensor, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """s_t = a_t s_{t-1} + x_t along `dim` (s_0 = 0), for gates a > 0 of x's
    shape."""
    return gated_linear_recurrence_log(torch.log(a.float()), x, dim)
