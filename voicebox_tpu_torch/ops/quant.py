"""Int8 inference quantization of the denoiser's transformer matmuls, and
the wrapper of K4, the weight-only int8 matrix product.

Counterpart of `voicebox_tpu/ops/quant.py`. One weight format serves both
modes: symmetric per-output-channel int8 (`quantize_kernel`), taken once
per weights version by `quantize_voicebox`.

* `"w8a16"`: weight-only. `w8a16_matmul` runs K4, the hand-written kernel
  in `csrc/w8a16_matmul.cu`, on CUDA tensors: the int8 weight is converted
  to x's dtype inside the kernel and the product sums in fp32, then the
  scale applies. CPU tensors take the plain version,
  `w8a16_matmul_reference`, the same arithmetic in torch ops. On a CUDA
  tensor it launches K4 or raises; it never falls back. bf16 K4 reads x
  through TMA, which needs x's rows 16-byte aligned: a quantized copy's
  GEGLUs write their output at a row pitch of 16 elements for it
  (`quantize_voicebox`), and the tile of y each block computes comes from
  `k4_tile`. fp32 K4 (the seq2seq decode) takes x at any pitch: `k4_tile`
  picks its GEMV route for m <= K4_GEMV_ROWS rows and its tiled route
  above.
* `"int8"`: dynamic activation quantization, per token (symmetric absmax
  over the features), then s8 x s8 -> s32 through `torch._int_mm`, a
  library product (the JAX package leaves it to XLA, outside any kernel).

Layout. A torch `Linear` keeps its weight as (out, in), so the
per-output-channel absmax runs over the last axis (axis -2 of a flax
kernel). `QuantLinear` stores the codes as (out_pad, in_pad) int8, zero
padded once: in to a multiple of 16 (K4's 16-byte weight rows, and
`_int_mm`'s multiple of 8) and out to a multiple of 8 (`_int_mm`). K4 reads
only the first `out` rows and masks x's ragged k itself, so no activation
is padded or copied on the w8a16 path.

Scope. Only the transformer's weight matmuls are quantized: per block the
attention's `to_qkv` and `to_out`, the feed-forward's two projections and
the U-Net skip combiner when there is one (`DEFAULT_QUANT_LAYERS` in the
JAX package's names). The modules are found by their place in the block,
not by name: the port's feed-forward projections are `ff.0` and `ff.3`, and
VoiceBox's own top-level `proj_in`, `to_embed`, `to_pred`, the
adaptive-norm projections and the time MLP stay float. In the
TextToSemantic seq2seq (`quantize_seq2seq`, the JAX package's
`SEQ2SEQ_QUANT_LAYERS` under `SEQ2SEQ_QUANT_SCOPE`) every matmul of the
decoder blocks `dec_*` (self-attention `to_qkv`, `to_out`; cross-attention
`to_q`, `to_kv`, `to_out`; feed-forward `proj_in`, `proj_out`) and the
vocabulary head `to_logits` are quantized, and the text encoder stays
float. The seq2seq computes in fp32, so "w8a16" runs fp32 K4 there.

`cast_float_params` is the storage-dtype cast of `sample(param_store_dtype=)`:
parameters only, never buffers (the rotary table stays fp32, as the JAX
package computes it).
"""

from __future__ import annotations

import copy
import ctypes
import functools
from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from .. import kernels
from .flash_attention import _sm_count

__all__ = [
    "DEFAULT_QUANT_LAYERS",
    "QUANT_MODES",
    "QuantLinear",
    "SCOPE",
    "cast_float_params",
    "K4_GEMV_ROWS",
    "K4_TILES",
    "int8_matmul",
    "k4_tile",
    "quantize_kernel",
    "quantize_seq2seq",
    "quantize_voicebox",
    "quantized_layer_names",
    "seq2seq_quantized_layer_names",
    "w8a16_matmul",
    "w8a16_matmul_reference",
]

QUANT_MODES = ("int8", "w8a16")

# the JAX package's Dense names of the quantized layers, all under the
# `transformer` scope, and where each sits in a port block
# [skip_combiner, gateloop, attn_prenorm, attn, ff_prenorm, ff]
DEFAULT_QUANT_LAYERS = ("to_qkv", "to_out", "proj_in", "proj_out", "skip_combiner")
SCOPE = "transformer"
_BLOCK_PLACES = {"to_qkv": "3.to_qkv", "to_out": "3.to_out", "proj_in": "5.0",
                 "proj_out": "5.3", "skip_combiner": "0"}

# the seq2seq's quantized layers, in the JAX package's names: in the decoder
# blocks (`dec_*`) and the vocabulary head
SEQ2SEQ_QUANT_LAYERS = ("to_qkv", "to_out", "to_q", "to_kv", "proj_in", "proj_out",
                        "to_logits")
SEQ2SEQ_QUANT_SCOPE = ("dec_", "to_logits")

_K4 = "w8a16_matmul"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_K_ALIGN, _N_ALIGN = 16, 8
_X_ROW_ALIGN = 16  # bytes: TMA's global stride and base alignment (bf16 x)

# the (rows of y, columns of y) tiles of one K4 block that the C entry point
# takes, largest first: bf16 has 256 rows of x x 128 output channels (two
# consumer warpgroups), 128 x 64 and 64 x 64 (one); fp32 has the tiled route
# (64 x 64) and the GEMV route for m <= K4_GEMV_ROWS, whose block takes
# every row of x, 8 at a time (a warp each), and 16, 8 or 4 output
# channels (a warp per 4, times a warp per 512 of k)
K4_TILES = {
    torch.bfloat16: ((256, 128), (128, 64), (64, 64)),
    torch.float32: ((64, 64), (8, 16), (8, 8), (8, 4)),
}
K4_GEMV_ROWS = 128
# the GEMV block's warps: per 4 channels x per 512 of k (at most 3) x per 8
# rows (at most 4) <= 12, and those of one row group <= 4 (PERF.md §6, PR 11)
_GEMV_ROW_GROUP_WARPS, _GEMV_WARPS = 4, 12


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def quantize_kernel(w: torch.Tensor):
    """Symmetric per-output-channel int8 quantization of a Linear weight
    (..., out, in): returns codes int8 of w's shape and scales fp32
    (..., out), so that `q * scale[..., None] ~= w`. Round half to even,
    the fp32 division and the clip to [-127, 127] are the JAX package's, so
    the codes equal its codes bit for bit; an all-zero channel gets scale 0
    and codes 0."""
    w32 = w.float()
    scale = w32.abs().amax(dim=-1) / 127.0
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.round(w32 / safe[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def w8a16_matmul_reference(x: torch.Tensor, weight_q: torch.Tensor,
                           weight_scale: torch.Tensor) -> torch.Tensor:
    """The plain version of K4: (x @ float(W_q)^T) in fp32, times the
    per-output-channel scale, cast to x's dtype. x (..., k); weight_q
    (n[_pad], k_pad) int8 with k <= k_pad; weight_scale (n,) fp32. A bf16
    x times an int8 code is exact in fp32, so only the order of the sums
    differs from K4."""
    k, n = x.shape[-1], weight_scale.shape[0]
    w = weight_q[:n, :k].float()
    y = torch.matmul(x.float(), w.t()) * weight_scale.float()
    return y.to(x.dtype)


@functools.lru_cache(maxsize=4096)
def k4_tile(m: int, k: int, n: int, dtype: torch.dtype, sms: int) -> tuple:
    """The (rows, channels) tile of y that each K4 block computes for an
    (m, k) x (k, n) product on a card of `sms` SMs. bf16: the largest tile
    whose grid of ceil(m / rows) x ceil(n / channels) blocks covers at least
    half the SMs and whose rows past m waste at most an eighth of its row
    tiles, else 64 x 64 (measured on the H100 at the engine's shapes,
    PERF.md, "K4's tile"). fp32: for m <= K4_GEMV_ROWS the GEMV route with
    the most channels whose block keeps at most 4 warps on a row group's
    4-channel sets and k slabs and at most 12 in all (measured on the H100
    at the decode's shapes, PERF.md §6, PR 11), above it the 64 x 64 tiled
    route."""
    if dtype != torch.bfloat16:
        tiled, *gemv = K4_TILES[torch.float32]
        if m > K4_GEMV_ROWS:
            return tiled
        k_warps, r_warps = min(-(-k // 512), 3), min(-(-m // 8), 4)
        for rows, cols in gemv:
            group = cols // 4 * k_warps
            if group <= _GEMV_ROW_GROUP_WARPS and group * r_warps <= _GEMV_WARPS:
                return rows, cols
        return gemv[-1]
    for rows, cols in K4_TILES[dtype]:
        row_tiles = -(-m // rows)
        if row_tiles * -(-n // cols) >= sms / 2 and 8 * m >= 7 * row_tiles * rows:
            return rows, cols
    return K4_TILES[dtype][-1]


@functools.cache
def _k4_entry():
    fn = getattr(kernels.load(_K4), "vb_w8a16_matmul")
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _x_rows(x: torch.Tensor) -> tuple:
    """x (..., k) as (m, k) rows, without a copy, and the elements between
    its rows (ldx). Raises ValueError where x's rows do not lie one stride
    apart with unit stride inside a row."""
    k = x.shape[-1]
    try:
        x2 = x.view(-1, k)
    except RuntimeError:
        raise ValueError(
            f"K4 takes x whose rows lie one stride apart; got shape {tuple(x.shape)}, strides "
            f"{x.stride()}"
        ) from None
    m = x2.shape[0]
    if k > 1 and x2.stride(1) != 1:
        raise ValueError(f"K4 takes x with unit stride along k; got strides {x2.stride()}")
    # one row has no row stride: TMA gets the smallest 16-byte aligned one
    ldx = x2.stride(0) if m > 1 else _round_up(k, _X_ROW_ALIGN // x.element_size())
    return x2, ldx


def _check_k4_operands(x2, ldx, weight_q, weight_scale):
    if not (x2.is_cuda and weight_q.device == x2.device and weight_scale.device == x2.device):
        raise ValueError(
            f"K4 needs x, weight_q, weight_scale on one CUDA device; got {x2.device}, "
            f"{weight_q.device}, {weight_scale.device}"
        )
    if x2.dtype not in _DTYPES:
        raise ValueError(f"K4 takes float32 or bfloat16 x, got {x2.dtype}")
    if weight_q.dtype != torch.int8 or weight_q.dim() != 2:
        raise ValueError(
            f"K4 takes an int8 (n, k_pad) weight, got {weight_q.dtype} {tuple(weight_q.shape)}"
        )
    m, k = x2.shape
    n = weight_scale.shape[0]
    rows, k_pad = weight_q.shape
    if weight_scale.dtype != torch.float32 or weight_scale.dim() != 1 or rows < n:
        raise ValueError(
            f"K4 takes an fp32 (n,) scale with n <= weight rows; got {weight_scale.dtype} "
            f"{tuple(weight_scale.shape)} for a {tuple(weight_q.shape)} weight"
        )
    if k > k_pad or k_pad % _K_ALIGN:
        raise ValueError(
            f"K4 needs the weight's rows padded to a multiple of {_K_ALIGN} holding x's "
            f"k = {k}; got k_pad = {k_pad}"
        )
    if m == 0 or n == 0 or k == 0 or m >= 2**31 or n > 65535 * 64:
        raise ValueError(f"K4 cannot launch for x {tuple(x2.shape)}, n = {n}")
    if ldx < k or ldx >= 2**31:
        raise ValueError(f"K4 takes x rows at least k = {k} elements apart; got {ldx}")
    if not (weight_q.is_contiguous() and weight_scale.is_contiguous()):
        raise ValueError("K4 needs contiguous weight_q and weight_scale")
    if weight_q.data_ptr() % 16:
        raise ValueError("K4 needs weight_q 16-byte aligned")
    if x2.dtype == torch.bfloat16 and (x2.data_ptr() % _X_ROW_ALIGN
                                       or ldx * x2.element_size() % _X_ROW_ALIGN):
        raise ValueError(
            f"bf16 K4 reads x through TMA: its rows must start on {_X_ROW_ALIGN}-byte "
            f"boundaries (a row pitch that is a multiple of 8 elements, as the GEGLUs of a "
            f"quantized copy write); got a row pitch of {ldx} elements at address "
            f"{x2.data_ptr():#x}"
        )


def _launch_k4(x2, ldx, weight_q, weight_scale, tile=None):
    """One K4 launch on x2 (m, k) with rows ldx apart; `tile` (rows,
    channels) overrides `k4_tile`'s choice."""
    m, k = x2.shape
    n = weight_scale.shape[0]
    if tile is None:
        tile = k4_tile(m, k, n, x2.dtype, _sm_count(x2.device.index))
    y = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    with torch.cuda.device(x2.device):
        err = _k4_entry()(
            x2.data_ptr(), weight_q.data_ptr(), weight_scale.data_ptr(), y.data_ptr(),
            m, n, k, weight_q.shape[1], ldx, _DTYPES[x2.dtype], *tile,
            torch.cuda.current_stream(x2.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"K4 launch failed: cudaError_t {err}")
    w8a16_matmul.launches += 1
    return y


def w8a16_matmul(x: torch.Tensor, weight_q: torch.Tensor,
                 weight_scale: torch.Tensor) -> torch.Tensor:
    """x (..., k) @ dequant(weight_q)^T in x's dtype, with fp32 sums and the
    scale applied after them. CUDA tensors go through K4 (float32 x, or
    bfloat16 x whose rows are 16-byte aligned; else ValueError), CPU tensors
    through the plain version. x's rows may lie further apart than k (a
    pitched view); x is never copied. `w8a16_matmul.launches` counts K4
    launches."""
    if x.device.type == "cpu":
        return w8a16_matmul_reference(x, weight_q, weight_scale)
    if x.device.type != "cuda":
        raise ValueError(f"no w8a16 path for device {x.device}")
    *lead, k = x.shape
    x2, ldx = _x_rows(x)
    _check_k4_operands(x2, ldx, weight_q, weight_scale)
    y = _launch_k4(x2, ldx, weight_q, weight_scale)
    return y.reshape(*lead, weight_scale.shape[0])


w8a16_matmul.launches = 0


def int8_matmul(x: torch.Tensor, weight_q: torch.Tensor,
                weight_scale: torch.Tensor) -> torch.Tensor:
    """x (..., k) @ dequant(weight_q)^T with x quantized per token to int8
    (symmetric absmax over k, per call, as in the JAX package) and the
    product s8 x s8 -> s32 through `torch._int_mm`. weight_q is (n_pad,
    k_pad) with k_pad and n_pad multiples of 8; x's codes are zero padded to
    k_pad per call, and on CUDA its rows to at least 17 (`_int_mm` wants
    m > 16). Returns x's dtype."""
    *lead, k = x.shape
    n = weight_scale.shape[0]
    x32 = x.reshape(-1, k).float()
    row_scale = x32.abs().amax(dim=-1, keepdim=True) / 127.0
    safe = torch.where(row_scale == 0.0, torch.ones_like(row_scale), row_scale)
    xq = torch.round(x32 / safe).clamp(-127, 127).to(torch.int8)
    m, k_pad = xq.shape[0], weight_q.shape[1]
    rows = max(m, 17) if xq.is_cuda else m
    if (rows, k_pad) != (m, k):
        xq = F.pad(xq, (0, k_pad - k, 0, rows - m))
    acc = torch._int_mm(xq, weight_q.t())[:m, :n]
    out = acc.float() * row_scale * weight_scale
    return out.to(x.dtype).reshape(*lead, n)


class QuantLinear(nn.Module):
    """A `Linear` whose weight is stored as int8 codes and fp32 scales,
    computing in `compute_dtype` through `w8a16_matmul` or `int8_matmul`,
    then adding the bias in that dtype (the JAX interceptor's order)."""

    def __init__(self, linear: nn.Linear, mode: str):
        super().__init__()
        if mode not in QUANT_MODES:
            raise ValueError(f"unknown quantize mode {mode!r} (use one of {QUANT_MODES})")
        self.mode = mode
        self.in_features, self.out_features = linear.in_features, linear.out_features
        self.compute_dtype = getattr(linear, "compute_dtype", linear.weight.dtype)
        q, scale = quantize_kernel(linear.weight.detach())
        k_pad = _round_up(self.in_features, _K_ALIGN)
        n_pad = _round_up(self.out_features, _N_ALIGN)
        q = F.pad(q, (0, k_pad - self.in_features, 0, n_pad - self.out_features))
        self.register_buffer("weight_q", q.contiguous())
        self.register_buffer("weight_scale", scale.contiguous())
        bias = linear.bias
        self.register_buffer("bias", None if bias is None else bias.detach().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        matmul = w8a16_matmul if self.mode == "w8a16" else int8_matmul
        y = matmul(x, self.weight_q, self.weight_scale)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"mode={self.mode}, compute_dtype={self.compute_dtype}")


def quantized_layer_names(voicebox: nn.Module) -> List[str]:
    """Module names of the layers `quantize_voicebox` replaces: in every
    block of `voicebox.transformer`, the attention's `to_qkv` and `to_out`
    (`layers.i.3.*`), the feed-forward's projections (`layers.i.5.0` and
    `layers.i.5.3`) and the skip combiner (`layers.i.0`) when there is one."""
    names = []
    for i, block in enumerate(getattr(voicebox, SCOPE).layers):
        for layer in DEFAULT_QUANT_LAYERS:
            place = _BLOCK_PLACES[layer]
            if block[int(place[0])] is not None:
                names.append(f"{SCOPE}.layers.{i}.{place}")
    return names


def _share_parameters_copy(module: nn.Module) -> nn.Module:
    """A copy of the module tree that shares every parameter and buffer with
    the original (and the unregistered codec a VoiceBox holds)."""
    memo = {id(t): t for t in (*module.parameters(), *module.buffers())}
    for m in module.modules():
        codec = m.__dict__.get("audio_enc_dec")
        if codec is not None:
            memo[id(codec)] = codec
    return copy.deepcopy(module, memo)


def _replace_linears(module: nn.Module, names: List[str], mode: str) -> None:
    for name in names:
        parent_name, _, child = name.rpartition(".")
        parent = module.get_submodule(parent_name) if parent_name else module
        linear = parent[int(child)] if child.isdigit() else getattr(parent, child)
        quant = QuantLinear(linear, mode)
        if child.isdigit():
            parent[int(child)] = quant
        else:
            setattr(parent, child, quant)


def seq2seq_quantized_layer_names(net: nn.Module) -> List[str]:
    """Module names of the seq2seq's Linears that `quantize_seq2seq`
    replaces: those named in SEQ2SEQ_QUANT_LAYERS whose path holds one of
    SEQ2SEQ_QUANT_SCOPE (the decoder blocks and the head)."""
    return [name for name, m in net.named_modules()
            if isinstance(m, nn.Linear) and name.rpartition(".")[2] in SEQ2SEQ_QUANT_LAYERS
            and any(scope in part for part in name.split(".") for scope in SEQ2SEQ_QUANT_SCOPE)]


def quantize_seq2seq(net: nn.Module, mode: str) -> nn.Module:
    """A copy of a TextToSemantic `_Seq2Seq` whose decoder and head matmuls
    (`seq2seq_quantized_layer_names`) are `QuantLinear`s; every other
    parameter is shared and the caller's module is never changed. In
    "w8a16" the decoder's GEGLUs write at a row pitch of 16 elements, as in
    `quantize_voicebox`."""
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quantize mode {mode!r} (use one of {QUANT_MODES})")
    out = _share_parameters_copy(net)
    if mode == "w8a16":
        for block in out.blocks:
            block.ff.act.row_pitch = _K_ALIGN
    _replace_linears(out, seq2seq_quantized_layer_names(out), mode)
    return out


def quantize_voicebox(voicebox: nn.Module, mode: str) -> nn.Module:
    """A copy of `voicebox` whose in-scope Linears (`quantized_layer_names`)
    are `QuantLinear`s holding `weight_q`, `weight_scale` and the bias. The
    copy shares every other parameter with the original; the caller's
    module is never changed. In "w8a16" the copy's feed-forward GEGLUs
    write their output at a row pitch of 16 elements, so that K4 reads the
    down projection's x through TMA without a copy (1365 -> 1376 at the
    flagship's width)."""
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quantize mode {mode!r} (use one of {QUANT_MODES})")
    out = _share_parameters_copy(voicebox)
    if mode == "w8a16":
        for block in getattr(out, SCOPE).layers:
            block[5][1].row_pitch = _K_ALIGN  # ff = [proj_in, GEGLU, Dropout, proj_out]
    _replace_linears(out, quantized_layer_names(out), mode)
    return out


def cast_float_params(module: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """A copy of `module` with every float parameter cast to `dtype`: a
    storage-dtype change for serving. Buffers and the caller's module stay
    as they are."""
    out = _share_parameters_copy(module)
    for m in out.modules():
        for name, p in m._parameters.items():
            if p is not None and p.is_floating_point() and p.dtype != dtype:
                m._parameters[name] = nn.Parameter(p.detach().to(dtype),
                                                   requires_grad=p.requires_grad)
    return out
