"""Monotonic alignment search (MAS, `maximum_path`) on the device.

Counterpart of `voicebox_tpu/ops/mas.py`: a Viterbi DP over the (phoneme x
mel-frame) grid, run as torch ops over the frame axis, with the phoneme axis
vectorised per step, as the JAX package's two `lax.scan`s run it:

* forward, frame by frame: v[j, i] = max(v[j-1, i], v[j-1, i-1]) + value[i, j]
  on reachable cells (i <= j and i >= x_len - (y_len - j)), -1e9 elsewhere,
  with v[0, 0] = value[0, 0] (three kernels a frame);
* the backtrack's choices are read off v in one vectorised pass (the JAX
  tie rule: move down a phoneme when `index == j` or `v_stay < v_adv`, on
  frames inside the row's length), so the reversed walk from
  (x_len - 1, y_len - 1) is a gather and a subtraction a frame.

The path is bool (b, t_x, t_y), True on one cell per frame inside the
masks; `path.sum(-1)` are the phoneme durations. MAS is not differentiable:
it runs under `no_grad` on a detached input. Every comparison is of
identical float32 sums, so the port and the JAX package take the same path
on the same input, ties included.
"""

from __future__ import annotations

import torch

__all__ = ["maximum_path"]

_NEG = -1e9


@torch.no_grad()
def maximum_path(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """value (b, t_x, t_y) alignment scores (higher is better), mask
    (b, t_x, t_y) bool validity (the outer product of the length masks) ->
    bool hard path (b, t_x, t_y)."""
    b, t_x, t_y = value.shape
    dev = value.device
    mask = mask.to(torch.bool)
    m = mask.to(torch.int32)
    x_lens = m.sum(dim=1).amax(dim=-1)  # (b,)
    y_lens = m.sum(dim=2).amax(dim=-1)
    i_idx = torch.arange(t_x, device=dev)
    j_idx = torch.arange(t_y, device=dev)
    # reach[j, b, i]: the cells a monotonic path from (0, 0) to
    # (x_len - 1, y_len - 1) can cross
    reach = ((i_idx[None, None, :] <= j_idx[:, None, None])
             & (i_idx[None, None, :] >= (x_lens - y_lens)[None, :, None] + j_idx[:, None, None]))
    val = value.detach().float().permute(2, 0, 1).contiguous()  # (t_y, b, t_x)
    neg = torch.tensor(_NEG, device=dev)

    # v[j, :, 1:] is the best score ending at (i, j); column 0 stays -1e9 as
    # the "advance" source of row 0
    v = torch.full((t_y, b, t_x + 1), _NEG, device=dev)
    best = torch.full((b, t_x), _NEG, device=dev)
    best[:, 0] = 0.0  # at j = 0 only (0, 0) is live, with zero prior
    torch.where(reach[0], best + val[0], neg, out=v[0, :, 1:])
    for j in range(1, t_y):
        prev = v[j - 1]
        best = torch.maximum(prev[:, 1:], prev[:, :-1])
        best += val[j]
        torch.where(reach[j], best, neg, out=v[j, :, 1:])

    # down[j, b, i]: at frame j, coming from phoneme i, the path came from
    # i - 1 at frame j - 1
    in_range = j_idx[:, None] <= (y_lens - 1)[None, :]  # (t_y, b)
    down = torch.zeros(t_y, b, t_x, dtype=torch.int64, device=dev)
    if t_y > 1 and t_x > 1:
        prev = v[:-1, :, 1:]  # v at frame j - 1, for j = 1 .. t_y - 1
        moves = (i_idx[None, None, 1:] == j_idx[1:, None, None]) | (prev[..., 1:] < prev[..., :-1])
        down[1:, :, 1:] = (moves & in_range[1:, :, None]).to(torch.int64)

    index = (x_lens - 1).clamp_min(0).to(torch.int64)[:, None]  # (b, 1)
    rows = [None] * t_y
    for j in range(t_y - 1, -1, -1):
        rows[j] = index
        index = index - down[j].gather(1, index)
    at = torch.cat(rows, dim=1)  # (b, t_y): the phoneme of each frame
    path = (i_idx[None, :, None] == at[:, None, :]) & in_range.T[:, None, :]
    return path & mask
