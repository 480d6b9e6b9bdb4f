"""Neural primitives of the denoiser.

Counterpart of `voicebox_tpu/models/primitives.py`. A layer built with
`dtype` computes in it, as flax's `dtype` does, and stores its weights in
`param_dtype` (flax's name), which defaults to `dtype`. For serving that
default is right: rounding fp32 weights to bf16 once, at load, gives the
values that flax's cast at every use gives, without a cast kernel per call.
Training keeps fp32 parameters (`param_dtype=torch.float32`) and casts each
weight to `dtype` at every use, explicitly (not through `torch.autocast`,
whose cast rules differ from flax's), as the JAX trainer does. The
norms, the rotary embedding, the time features and the adaptive-norm
projections compute in fp32 whatever the model's dtype, as in the JAX
package. The tanh GELU is the denoiser's (the vocoder uses the exact one).
The norms' and the GEGLU's outputs carry the JAX package's remat tags
("norm_out", "gelu_out"; `ops/remat.py`). `SimpleGateLoopLayer` runs its
recurrence through `ops/gateloop.py`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.gateloop import gated_linear_recurrence_log
from ..ops.remat import checkpoint_name
from ..parallel.collectives import copy_to_group, gather_last_from_group, reduce_from_group
from ..parallel.sequence_parallel import current_shard, halo_exchange

__all__ = [
    "Linear",
    "Conv1d",
    "l2norm",
    "LearnedSinusoidalPosEmb",
    "RotaryEmbedding",
    "rotate_half",
    "apply_rotary_pos_emb",
    "ConvPositionEmbed",
    "RMSNorm",
    "AdaptiveRMSNorm",
    "MultiheadRMSNorm",
    "GEGLU",
    "FeedForward",
    "SimpleGateLoopLayer",
]


def _cast(t: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    # no call where nothing changes: a decode step makes hundreds of these
    return t if t is None or t.dtype == dtype else t.to(dtype)


class Linear(nn.Linear):
    """nn.Linear with its weights in `param_dtype` (default `dtype`),
    computing in `dtype`. Under tensor parallelism (`tp`, set by
    `parallel/tensor_parallel.py`) it holds this rank's piece of the weight:
    "column" rows (its input's gradient all-reduced over "model", its whole
    bias's rows used), "column_gather" the same with the output all-gathered,
    "row" columns (the output all-reduced, then the whole bias added)."""

    tp = None

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32, param_dtype=None):
        super().__init__(in_features, out_features, bias=bias, dtype=param_dtype or dtype)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        if self.tp is not None:
            return self._tp_forward(_cast(x, dt), _cast(self.weight, dt), _cast(self.bias, dt))
        return F.linear(_cast(x, dt), _cast(self.weight, dt), _cast(self.bias, dt))

    def _tp_forward(self, x, weight, bias):
        tp = self.tp
        if tp.mode == "row":
            y = reduce_from_group(F.linear(x, weight), tp.group)
            return y if bias is None else y + bias
        y = F.linear(copy_to_group(x, tp.group), weight,
                     None if bias is None else bias.index_select(0, tp.rows))
        return gather_last_from_group(y, tp.group) if tp.mode == "column_gather" else y


class Conv1d(nn.Conv1d):
    """nn.Conv1d on channels-first input, weights in `param_dtype` (default
    `dtype`), computing in `dtype`."""

    def __init__(self, *args, dtype=torch.float32, param_dtype=None, **kwargs):
        super().__init__(*args, dtype=param_dtype or dtype, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


def l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) over the last axis, with the clamp inside the
    square root (an all-zero row stays finite)."""
    sumsq = x.square().sum(dim=-1, keepdim=True)
    return x * torch.rsqrt(sumsq.clamp_min(eps * eps))


class LearnedSinusoidalPosEmb(nn.Module):
    """Learned-frequency Fourier features of the scalar ODE time, fp32."""

    def __init__(self, dim: int):
        super().__init__()
        assert dim % 2 == 0
        self.weights = nn.Parameter(torch.randn(dim // 2))

    def forward(self, t: torch.Tensor) -> torch.Tensor:  # (b,) -> (b, dim)
        freqs = t[:, None].float() * self.weights[None, :] * 2 * math.pi
        return torch.cat([freqs.sin(), freqs.cos()], dim=-1)


class RotaryEmbedding(nn.Module):
    """RoPE frequency table, fp32, from the registered `inv_freq` buffer."""

    def __init__(self, dim: int, theta: float = 50000.0):
        super().__init__()
        inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
        self.register_buffer("inv_freq", inv_freq)

    def forward(self, positions: torch.Tensor) -> torch.Tensor:  # (n,) -> (n, dim)
        freqs = positions.float()[:, None] * self.inv_freq[None, :]
        return torch.cat([freqs, freqs], dim=-1)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary_pos_emb(pos: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Rotary applied in fp32, cast back to t's dtype."""
    t32 = t.float()
    return (t32 * pos.cos() + rotate_half(t32) * pos.sin()).to(t.dtype)


class ConvPositionEmbed(nn.Module):
    """Depthwise 1-D conv + tanh GELU on (b, n, dim), masked before and
    after. The caller adds the residual. Inside `seq_shard` (sequence
    parallelism) x is this rank's frames: a halo of kernel_size // 2 frames
    comes from each neighbour and the conv runs without padding over the
    widened block, the full sequence's conv on the rank's frames."""

    def __init__(self, dim: int, kernel_size: int = 31, groups: Optional[int] = None,
                 dtype=torch.float32, param_dtype=None):
        super().__init__()
        assert kernel_size % 2 == 1
        self.dw_conv1d = nn.Sequential(
            Conv1d(dim, dim, kernel_size, groups=groups or dim,
                   padding=kernel_size // 2, dtype=dtype, param_dtype=param_dtype),
            nn.GELU(approximate="tanh"),
        )

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if mask is not None:
            x = x.masked_fill(~mask[..., None], 0.0)
        conv = self.dw_conv1d[0]
        shard = current_shard()
        if shard is not None and conv.kernel_size[0] > 1:
            x = halo_exchange(x, conv.kernel_size[0] // 2, shard.group)
            dt = conv.compute_dtype
            out = F.conv1d(x.transpose(1, 2).to(dt), conv.weight.to(dt), _cast(conv.bias, dt),
                           groups=conv.groups)
            out = self.dw_conv1d[1](out).transpose(1, 2)
        else:
            out = self.dw_conv1d(x.transpose(1, 2)).transpose(1, 2)
        if mask is not None:
            out = out.masked_fill(~mask[..., None], 0.0)
        return out


class RMSNorm(nn.Module):
    """gamma * sqrt(dim) * l2norm(x), computed in fp32."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = dim ** 0.5
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return checkpoint_name((l2norm(x.float()) * self.scale * self.gamma).to(x.dtype),
                               "norm_out")


class AdaptiveRMSNorm(nn.Module):
    """RMSNorm whose gain and bias are fp32 projections of a condition
    vector, zero-initialised so the module starts as the identity norm.
    The projections compute in fp32 whatever their storage dtype: weights
    stored in bf16 (`cast_float_params`) are upcast at use, as flax does."""

    def __init__(self, dim: int, cond_dim: Optional[int] = None):
        super().__init__()
        cond_dim = cond_dim or dim
        self.scale = dim ** 0.5
        self.to_gamma = Linear(cond_dim, dim)
        self.to_beta = Linear(cond_dim, dim)
        for lin, bias in ((self.to_gamma, 1.0), (self.to_beta, 0.0)):
            nn.init.zeros_(lin.weight)
            nn.init.constant_(lin.bias, bias)

    def forward(self, x: torch.Tensor, *, cond: torch.Tensor) -> torch.Tensor:
        normed = l2norm(x.float()) * self.scale
        cond = cond.float()
        gamma, beta = self.to_gamma(cond), self.to_beta(cond)
        return checkpoint_name((normed * gamma[:, None, :] + beta[:, None, :]).to(x.dtype),
                               "norm_out")


class MultiheadRMSNorm(nn.Module):
    """Per-head qk-norm on (b, h, n, d): gamma (h, 1, d) * sqrt(d) * l2norm;
    `heads` (a slice) picks the gains of the heads x holds."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.scale = dim ** 0.5
        self.gamma = nn.Parameter(torch.ones(heads, 1, dim))

    def forward(self, x: torch.Tensor, heads: Optional[slice] = None) -> torch.Tensor:
        gamma = self.gamma if heads is None else self.gamma[heads]
        return (l2norm(x.float()) * gamma * self.scale).to(x.dtype)


class GEGLU(nn.Module):
    """gelu(gate) * x over the two halves of the last axis. With `row_pitch`
    > 1 and no gradient to record, the product is written straight into a
    buffer whose rows are padded to a multiple of `row_pitch` elements, and
    the unpadded view of it is returned: the same values, rows that a TMA
    load can address (K4 reads the 1365-wide flagship activation at a pitch
    of 1376). `quantize_voicebox` sets it on a w8a16 copy."""

    def __init__(self, row_pitch: int = 1):
        super().__init__()
        self.row_pitch = row_pitch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, gate = x.chunk(2, dim=-1)
        if self.row_pitch == 1 or (torch.is_grad_enabled() and x.requires_grad):
            return checkpoint_name(F.gelu(gate, approximate="tanh") * x, "gelu_out")
        n = x.shape[-1]
        pitched = -(-n // self.row_pitch) * self.row_pitch
        out = x.new_empty(*x.shape[:-1], pitched)[..., :n]
        return torch.mul(F.gelu(gate, approximate="tanh"), x, out=out)


class SimpleGateLoopLayer(nn.Module):
    """GateLoop with head dim 1 (the JAX package's `SimpleGateLoopLayer`):
    RMSNorm, one bias-free dim x 3 projection into (q, kv, g), the state
    s_t = sigmoid(g_t) s_{t-1} + kv_t (`ops/gateloop.py`, fp32), q * s, then
    a LayerNorm (eps 1e-6, flax's default) in fp32. The caller adds the
    residual. (b, n, dim) -> (b, n, dim)."""

    def __init__(self, dim: int, dtype=torch.float32, param_dtype=None):
        super().__init__()
        self.norm = RMSNorm(dim)
        self.to_qkva = Linear(dim, dim * 3, bias=False, dtype=dtype, param_dtype=param_dtype)
        self.post_norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, kv, g = self.to_qkva(self.norm(x)).chunk(3, dim=-1)
        state = gated_linear_recurrence_log(-F.softplus(-g.float()), kv, dim=1)
        out = q * state
        return F.layer_norm(out.float(), out.shape[-1:], self.post_norm.weight.float(),
                            self.post_norm.bias.float(), self.post_norm.eps).to(x.dtype)


def FeedForward(dim: int, mult: float = 4.0, dropout: float = 0.0,
                dtype=torch.float32, param_dtype=None) -> nn.Sequential:
    """GEGLU MLP with inner dim int(dim * mult * 2 / 3). A Sequential, so the
    projections sit at the reference's keys `0` and `3`."""
    dim_inner = int(dim * mult * 2 / 3)
    return nn.Sequential(
        Linear(dim, dim_inner * 2, dtype=dtype, param_dtype=param_dtype),
        GEGLU(),
        nn.Dropout(dropout),
        Linear(dim_inner, dim, dtype=dtype, param_dtype=param_dtype),
    )
