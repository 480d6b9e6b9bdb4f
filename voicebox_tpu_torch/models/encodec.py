"""Residual vector quantisation of Encodec latents.

Counterpart of `voicebox_tpu/models/encodec.py::ResidualVQ`. Each of the q
codebooks quantises the residual of the previous stage by its nearest entry.
The distance is the JAX package's `||c||^2 - 2 r.c` (the `||r||^2` term does
not change the argmin), so a code chosen here is the code chosen there up to
rounding at a near tie. The SEANet encoder and decoder are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

__all__ = ["ResidualVQ"]


class ResidualVQ(nn.Module):
    def __init__(self, num_quantizers: int = 8, codebook_size: int = 1024, dim: int = 128):
        super().__init__()
        self.codebooks = nn.Parameter(torch.randn(num_quantizers, codebook_size, dim))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x (b, n, dim) -> (quantized (b, n, dim), codes (b, n, q), commit loss)."""
        residual = x
        quantized = torch.zeros_like(x)
        codes = []
        for codebook in self.codebooks:
            dist = codebook.square().sum(dim=-1) - 2 * torch.matmul(residual, codebook.T)
            idx = dist.argmin(dim=-1)  # (b, n); the first index on a tie
            q = codebook[idx]
            residual = residual - q
            quantized = quantized + q
            codes.append(idx)
        return quantized, torch.stack(codes, dim=-1), residual.square().mean()
