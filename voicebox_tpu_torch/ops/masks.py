"""Probabilistic and span mask builders of the training loss, and the
draws of the port's random numbers.

Counterpart of `voicebox_tpu/ops/masks.py`. Every random draw takes an
explicit `torch.Generator`, or is handed its uniforms directly
(`uniform_draw=`), so that a test can feed the very numbers another
framework drew.

`batch_rows(offset, rows, total)` makes a data-parallel rank draw what one
process would: inside it, `uniform` and `normal` draw a shape whose leading
axis is `rows` at `total` rows and return rows [offset, offset + rows).
Every rank draws the global micro-batch's numbers from the same generator
and keeps its own, so the generators stay in step with a single process's
and the run equals it. Draws without a batch axis (the duration
predictor's coin flip) are drawn whole on every rank, as they would be
once. `batch_frames(offset, frames, total)` does the same for a sequence
split over ranks (`parallel/sequence_parallel.py`): a draw whose second axis
is `frames` is drawn at `total` frames and frames [offset, offset +
frames) of it are returned; inside both blocks a draw is cut both ways.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch

__all__ = [
    "batch_frames",
    "batch_rows",
    "prob_mask_like",
    "reduce_masks_with_and",
    "mask_from_start_end_indices",
    "mask_from_frac_lengths",
    "coin_flip",
    "normal",
    "split_generator",
    "uniform",
]


_ROWS: List[Tuple[int, int, int]] = []  # (offset, rows, total) of the open blocks
_FRAMES: List[Tuple[int, int, int]] = []  # the same for the frames of a split sequence


@contextlib.contextmanager
def batch_rows(offset: int, rows: int, total: int):
    """Inside the block, a draw of leading axis `rows` is drawn at `total`
    rows and rows [offset, offset + rows) of it are returned."""
    _ROWS.append((offset, rows, total))
    try:
        yield
    finally:
        _ROWS.pop()


@contextlib.contextmanager
def batch_frames(offset: int, frames: int, total: int):
    """Inside the block, a draw whose second axis is `frames` is drawn at
    `total` frames and frames [offset, offset + frames) of it are returned."""
    _FRAMES.append((offset, frames, total))
    try:
        yield
    finally:
        _FRAMES.pop()


def _draw(fn, shape, generator, device, dtype) -> torch.Tensor:
    gen_device = generator.device if generator is not None else device
    full, cut = list(shape), [slice(None)] * len(shape)
    for axis, blocks in ((0, _ROWS), (1, _FRAMES)):
        if blocks and len(full) > axis and full[axis] == blocks[-1][1]:
            offset, n, total = blocks[-1]
            full[axis], cut[axis] = total, slice(offset, offset + n)
    out = fn(tuple(full), generator=generator, device=gen_device, dtype=dtype)
    return out[tuple(cut)].to(device)


def uniform(shape, generator: Optional[torch.Generator] = None, device=None,
            dtype=torch.float32) -> torch.Tensor:
    """U[0, 1) of `shape`, drawn on the generator's device, then moved."""
    return _draw(torch.rand, shape, generator, device, dtype)


def split_generator(generator: torch.Generator, device) -> torch.Generator:
    """A new generator on `device`, seeded by one draw from `generator`: the
    deterministic counterpart of `jax.random.split` for one child. The draw
    is read back to the host, so a generator on the card costs a device
    synchronization and one on the CPU none."""
    seed = torch.randint(0, 2**62, (1,), generator=generator, device=generator.device)
    return torch.Generator(device=device).manual_seed(int(seed.item()))


def normal(shape, generator: Optional[torch.Generator] = None, device=None,
           dtype=torch.float32) -> torch.Tensor:
    """N(0, 1) of `shape`, drawn on the generator's device, then moved."""
    return _draw(torch.randn, shape, generator, device, dtype)


def prob_mask_like(shape, prob: float, generator: Optional[torch.Generator] = None,
                   device=None, uniform_draw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bernoulli(prob) bool mask: `uniform < prob`. p = 0 and p = 1 draw
    nothing (the result is then independent of the generator)."""
    if prob == 1:
        return torch.ones(shape, dtype=torch.bool, device=device)
    if prob == 0:
        return torch.zeros(shape, dtype=torch.bool, device=device)
    u = uniform_draw if uniform_draw is not None else uniform(shape, generator, device)
    return u < prob


def reduce_masks_with_and(*masks):
    """AND of the masks that are not None; None when all are."""
    masks = [m for m in masks if m is not None]
    if not masks:
        return None
    out = masks[0]
    for m in masks[1:]:
        out = out & m
    return out


def mask_from_start_end_indices(seq_len: int, start: torch.Tensor,
                                end: torch.Tensor) -> torch.Tensor:
    """Bool mask over [start, end) per batch element; indices truncate to
    int32 toward zero."""
    seq = torch.arange(seq_len, dtype=torch.int32, device=start.device)
    start = start[..., None].to(torch.int32)
    end = end[..., None].to(torch.int32)
    return (seq >= start) & (seq < end)


def mask_from_frac_lengths(seq_len: int, frac_lengths: torch.Tensor,
                           generator: Optional[torch.Generator] = None,
                           uniform_draw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A random contiguous span covering `frac` of the sequence (the infilling
    mask): lengths truncate toward zero, the start is uniform in
    [0, seq_len - length]."""
    lengths = (frac_lengths * seq_len).to(torch.int32)
    max_start = (seq_len - lengths).to(frac_lengths.dtype)
    rand = (uniform_draw if uniform_draw is not None
            else uniform(frac_lengths.shape, generator, frac_lengths.device,
                         frac_lengths.dtype))
    start = (max_start * rand).clamp_min(0)
    end = start + lengths.to(start.dtype)
    return mask_from_start_end_indices(seq_len, start, end)


def coin_flip(generator: Optional[torch.Generator] = None, device=None,
              uniform_draw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A 0-d bool tensor, True with probability 1/2."""
    u = uniform_draw if uniform_draw is not None else uniform((), generator, device)
    return u < 0.5
