"""Length adaptation: 1-D linear interpolation and curtail/pad.

Counterpart of `voicebox_tpu/ops/interp.py`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["interpolate_1d", "curtail_or_pad"]


def interpolate_1d(t: torch.Tensor, length: int) -> torch.Tensor:
    """Linearly resample the last axis of a `(b, n)` or `(b, d, n)` tensor to
    `length` (half-pixel centres, no antialias). Bool inputs come back bool
    (nonzero -> True)."""
    dtype = t.dtype
    x = t.float()
    implicit_one_channel = x.dim() == 2
    if implicit_one_channel:
        x = x[:, None, :]
    x = F.interpolate(x, size=length, mode="linear", align_corners=False)
    if implicit_one_channel:
        x = x[:, 0, :]
    if dtype == torch.bool:
        return x > 0
    return x.to(dtype)


def curtail_or_pad(t: torch.Tensor, target_length: int) -> torch.Tensor:
    """Truncate or right-pad axis -2 to `target_length` (zeros)."""
    length = t.shape[-2]
    if length > target_length:
        return t[..., :target_length, :]
    if length < target_length:
        return F.pad(t, (0, 0, 0, target_length - length))
    return t
