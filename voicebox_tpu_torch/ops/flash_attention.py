"""Bidirectional attention: the plain PyTorch versions and the wrappers of
K1 (forward), K2 and K3 (backward).

Counterpart of `voicebox_tpu/ops/flash_attention.py`. Two functions compute
the same forward:

* `reference_attention` is the plain version (the JAX package's
  `reference_attention`): fp32 logits times `scale`, masked keys filled with
  -0.7 * f32max, an fp32 softmax, probabilities cast to v's dtype for the
  second product. With `return_lse=True` it also gives the per-row
  log-sum-exp of the filled logits, from `torch.logsumexp`. With
  `scores_dtype=torch.bfloat16` (the JAX package's `attn_scores_dtype`)
  the score matrix and the softmax are bf16, in the JAX order.
* `flash_attention` runs K1, the hand-written forward kernel in
  `csrc/flash_attention_fwd.cu` (its query-tile height from `k1_block_q`),
  on CUDA tensors, inside an autograd
  Function whose backward is `attention_delta` (a torch op, as the JAX
  package leaves it to XLA) then K2 (`flash_attention_bwd_dq`) and K3
  (`flash_attention_bwd_dkv`) from `csrc/flash_attention_bwd.cu`. The
  forward saves out and lse and the backward recomputes nothing of it. On
  CPU tensors it runs the plain version, and autograd differentiates that.
  On a CUDA tensor it launches the kernels or raises; it never falls back.
  `scores_dtype` acts on the plain version only: K1 never holds the score
  matrix, so on the card the option changes no bit (the JAX package's
  Pallas path ignores it too).

With `dropout > 0`, `reference_attention` drops attention weights after
the softmax (kept ones scaled by 1 / (1 - dropout)), with a keep mask that
is passed in or drawn from `generator`: the JAX package's
`reference_attention(dropout=, dropout_rng=)`, an XLA einsum path and no
kernel there, so ordinary torch ops here. The attention module sends a
training call with dropout there, and every other call to
`flash_attention`.

Inside a rematerialised block whose policy saves "attn_out" and "attn_lse"
(`ops/remat.py`), `flash_attention` runs K1 as the registered op
`voicebox_tpu_torch::flash_attention_fwd`, with the same backward, so the
policy can save K1's outputs instead of launching it again.

`reference_attention_backward` is the plain version of K2 + K3: the
FlashAttention-2 backward from the saved lse, with the kernels' roundings
(P and dS cast to the input dtype before their products).

The JAX package sends every call with kv <= 4096 to XLA's einsum (a rule
measured on a TPU); here every attention call on a CUDA tensor goes through
K1, and every backward through K2 and K3.

The wrappers take any head dim in either dtype. Up to 256 the kernels are
built for the head dims in `HEAD_DIMS`; past 256 the chunked kernels take
any multiple of 64 (`WIDE_STEP`): a block owns 256 columns of the output
(K1's out, K2's dq, K3's dk and dv; the chunk index a grid dimension) and
streams the logits' operands in 64-column slices, so every width runs and
the last chunk may be narrower. The scale is resolved from
the true d, then q, k, v (and dO) are zero-padded to the width the call
launches at (`kernel_head_dim`: the narrowest built width at or above d up
to 256, the next multiple of 64 past it), the kernel runs, and out, dq, dk
and dv are sliced back to d. That is exact: the zero columns add exact
zeros to every q.k and P.V sum, and the padded columns of the gradients
are zero.

A row whose keys are all masked has one defined answer on every path: every
real key gets the same filled logit, so the row is mean(V) over the real
keys and its lse is fill + log(kv), which rounds to the fill. Its gradient
is that of the plain softmax: dQ = dK = 0 (the filled logits do not depend
on q or k) and every real key's dV gains dO / kv. (The JAX Pallas kernels
give sum(V) / kv_padded forward and NaN backward there.) Masked keys get
p = 0 by a select, never exp(s - lse) * 0, which is NaN once the unmasked
logit overflows exp.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from .. import kernels
from .masks import uniform
from .remat import checkpoint_name, saves

__all__ = [
    "HEAD_DIMS",
    "MASK_FILL",
    "WIDE_STEP",
    "attention_delta",
    "flash_attention",
    "flash_attention_bwd_dkv",
    "flash_attention_bwd_dq",
    "k1_block_q",
    "k23_f32_edges",
    "kernel_head_dim",
    "reference_attention",
    "reference_attention_backward",
]

MASK_FILL = -0.7 * torch.finfo(torch.float32).max

_K1 = "flash_attention_fwd"
_BWD = "flash_attention_bwd"  # K2 and K3
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# head dims each dtype's kernels are built for: fp32 also takes the narrow
# heads of small models (the quality canaries' 16 and 32); bf16's wgmma
# tiles take 64-column chunks. Other head dims up to 256 are zero-padded to
# the next of these (`kernel_head_dim`): 129-255 to 256
HEAD_DIMS = {torch.float32: (16, 32, 64, 128, 256), torch.bfloat16: (64, 128, 256)}
# past 256, the chunked kernels: a block owns 256 columns of the output and
# streams the logits' operands in slices of WIDE_STEP columns; they take
# any multiple of WIDE_STEP, other widths are zero-padded to one
WIDE_STEP = 64


def kernel_head_dim(d: int, dtype: torch.dtype) -> int:
    """The head dim a d-wide call of K1, K2 or K3 launches at: the narrowest
    width in `HEAD_DIMS[dtype]` at or above d, past 256 the next multiple of
    `WIDE_STEP` (d itself for a dtype the kernels do not take: the operand
    checks name it)."""
    widths = HEAD_DIMS.get(dtype)
    if widths is None:
        return d
    for width in widths:
        if d <= width:
            return width
    return -(-d // WIDE_STEP) * WIDE_STEP


def _launches_at(d: int, dtype: torch.dtype) -> bool:
    """Whether a kernel launches at head dim d in dtype as it is: a built
    width, or a multiple of `WIDE_STEP` past 256."""
    widths = HEAD_DIMS[dtype]
    return d in widths or (d > widths[-1] and d % WIDE_STEP == 0)


def _widen(width: int, *ts: torch.Tensor):
    """Each of `ts` with its last axis zero-padded to `width`."""
    return [t if t.shape[-1] == width else F.pad(t, (0, width - t.shape[-1])) for t in ts]


def _narrow(d: int, t: torch.Tensor) -> torch.Tensor:
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    return_lse: bool = False,
    dropout: float = 0.0,
    keep: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    scores_dtype: Optional[torch.dtype] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """q (b, h, n, d), k and v (b, h, kv, d), mask (b, kv) bool (True = keep).
    Returns out (b, h, n, d) in q's dtype and, with `return_lse`, lse
    (b, h, 1, n) fp32. With `dropout > 0` the softmax weights are kept
    where `keep` (b, h, n, kv) is True, or where a uniform draw from
    `generator` is below 1 - dropout, and scaled by 1 / (1 - dropout).

    `scores_dtype=torch.bfloat16` holds the score matrix in bf16, in the
    JAX package's order: the fp32 logits rounded to bf16, then the scale,
    the masked fill, the softmax (max, exp, a sum rounded to bf16, the
    division) and the dropout on bf16 values, each Python scalar first
    rounded to bf16 as JAX's weak types are, and the probabilities cast to
    v's dtype for the second product. None keeps them fp32."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    # fp32 products of the stored values: the einsum's f32 accumulation
    low = scores_dtype not in (None, torch.float32)
    if low:  # JAX's weak-typed Python scalars act as values of the scores' dtype
        sim = _LowLogits.apply(q, k, scores_dtype) * torch.tensor(scale, dtype=scores_dtype)
    else:
        sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        sim = sim.masked_fill(~mask[:, None, None, :], MASK_FILL)
    attn = checkpoint_name(_low_softmax(sim) if low else torch.softmax(sim, dim=-1),
                           "attn_probs")
    if dropout > 0.0:
        if keep is None:  # jax.random.bernoulli: uniform < p
            keep = uniform(attn.shape, generator, attn.device) < 1.0 - dropout
        kept = torch.tensor(1.0 - dropout, dtype=attn.dtype) if low else 1.0 - dropout
        attn = torch.where(keep, attn / kept, 0.0)
    out = torch.matmul(attn.to(v.dtype), v).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(sim.float(), dim=-1).unsqueeze(2)


class _LowLogits(torch.autograd.Function):
    """q k^T in fp32 rounded to `dtype`: the JAX einsum with
    `preferred_element_type=dtype`, whose transposes round dq and dk to
    `dtype` as well."""

    @staticmethod
    def forward(ctx, q, k, dtype):
        ctx.save_for_backward(q, k)
        return torch.matmul(q.float(), k.float().transpose(-1, -2)).to(dtype)

    @staticmethod
    def backward(ctx, g):
        q, k = ctx.saved_tensors
        low, g = g.dtype, g.float()
        dq = torch.matmul(g, k.float()).to(low).to(q.dtype)
        dk = torch.matmul(g.transpose(-1, -2), q.float()).to(low).to(k.dtype)
        return dq, dk, None


class _LowSoftmax(torch.autograd.Function):
    """`jax.nn.softmax` on a bf16 (b, h, n, kv) tensor, with JAX's roundings
    both ways. Forward: e = exp(sim - max) rounded, its sum taken in fp32
    and rounded to s, then y = e / s rounded. Backward: JAX's autodiff of
    those ops (the max held constant): dsim = (g / s - sum(g s^-2 e)) e,
    each product, quotient and sum rounded."""

    @staticmethod
    def forward(ctx, sim):
        e = torch.exp(sim - sim.amax(dim=-1, keepdim=True))
        s = e.float().sum(dim=-1, keepdim=True).to(sim.dtype)
        ctx.save_for_backward(e, s)
        return e / s

    @staticmethod
    def backward(ctx, g):
        e, s = ctx.saved_tensors
        g = g.to(e.dtype)
        ds = (g * s.pow(-2) * e).float().sum(dim=-1, keepdim=True).to(e.dtype)
        return (g / s - ds) * e


_low_softmax = _LowSoftmax.apply


def attention_delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, (b, h, n): the backward's correction
    term (the JAX package computes it in XLA outside its kernels)."""
    return (do.float() * out.float()).sum(dim=-1)


def reference_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of K2 + K3: dq, dk, dv from the forward's out and lse
    (b, h, 1, n) and the output gradient do, each in its input's dtype.
    p = exp(s * scale - lse) on kept keys (a select: 0 elsewhere), 1 / kv on
    every key of a fully-masked row; ds = p (dO.v - delta) scale, 0 on a
    fully-masked row."""
    return _plain_backward(q, k, v, mask, lse, do, attention_delta(do, out), scale)


def _plain_backward(q, k, v, mask, lse, do, delta, scale):
    if scale is None:
        scale = q.shape[-1] ** -0.5
    lse_col = lse.reshape(*q.shape[:3], 1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse_col)
    if mask is not None:
        p = torch.where(mask[:, None, None, :], p, 0.0)
    empty = lse_col < MASK_FILL / 2
    p = torch.where(empty, 1.0 / k.shape[2], p)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = torch.where(empty, 0.0, p * (dp - delta.reshape(lse_col.shape)) * scale)
    # the kernels round P and dS to the input dtype for their products
    dq = torch.matmul(ds.to(k.dtype).float(), k.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _entry(source: str, symbol: str, n_ptrs: int, n_ints: int = 6):
    fn = getattr(kernels.load(source), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check_operands(kernel, q, k, v, mask):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(
            f"{kernel} needs q, k, v on one CUDA device; got {q.device}, {k.device}, {v.device}"
        )
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"{kernel} takes float32 or bfloat16 q, k, v of one dtype; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"{kernel} shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    b, h, n_q, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"{kernel} shapes: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if not _launches_at(d, q.dtype):
        raise ValueError(f"{kernel} launches at head dim "
                         f"{' or '.join(map(str, HEAD_DIMS[q.dtype]))} or a multiple of "
                         f"{WIDE_STEP} past them in {str(q.dtype)[6:]}, got {d}")
    if n_q == 0 or k.shape[2] == 0 or h > 65535 or b > 65535:
        raise ValueError(f"{kernel} cannot launch for q {tuple(q.shape)}, k {tuple(k.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{kernel} needs {name} contiguous and 16-byte aligned")
    if mask is not None:
        if mask.dtype != torch.bool or tuple(mask.shape) != (b, k.shape[2]):
            raise ValueError(
                f"{kernel} mask must be bool (b, kv) = {(b, k.shape[2])}, got "
                f"{mask.dtype} {tuple(mask.shape)}"
            )
        if mask.device != q.device or not mask.is_contiguous():
            raise ValueError(f"{kernel} mask must be contiguous and on q's device")


def _check_backward_operands(kernel, q, k, v, mask, do, lse, delta):
    _check_operands(kernel, q, k, v, mask)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(
            f"{kernel} needs do like q {tuple(q.shape)} {q.dtype}; got "
            f"{tuple(do.shape)} {do.dtype} on {do.device}"
        )
    if not do.is_contiguous() or do.data_ptr() % 16:
        raise ValueError(f"{kernel} needs do contiguous and 16-byte aligned")
    rows = q.shape[0] * q.shape[1] * q.shape[2]
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or t.device != q.device or not t.is_contiguous()
                or t.numel() != rows):
            raise ValueError(
                f"{kernel} needs {name} float32, contiguous, one value per query row "
                f"on q's device; got {t.dtype} {tuple(t.shape)} on {t.device}"
            )


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def k1_block_q(b: int, h: int, n: int, d: int, dtype: torch.dtype, sms: int) -> int:
    """Query rows per K1 block for a (b, h, n, d) call on a card of `sms`
    SMs. bf16 takes 128 rows (two consumer warpgroups sharing each K/V
    tile) at head dim 128 and 256 where that grid of ceil(n / 128) x h x b
    blocks covers at least half the SMs, else 64 (one warpgroup; at head
    dim 64 two of its blocks share an SM; past 256 the chunked kernel has
    one height). fp32 always takes 16. Measured on the H100 (PERF.md, "K1's
    tile height")."""
    if dtype == torch.bfloat16:
        return 128 if 128 <= d <= 256 and 2 * -(-n // 128) * b * h >= sms else 64
    return 16


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_k1(q, k, v, mask, scale, block_q=None):
    """One K1 launch at q's head dim, zero-padded to `kernel_head_dim`;
    `block_q` overrides `k1_block_q`'s tile height."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale  # the true d's
    out, lse = _k1_kernel(*_widen(kernel_head_dim(d, q.dtype), q, k, v), mask, scale, block_q)
    return _narrow(d, out), lse


def _k1_kernel(q, k, v, mask, scale, block_q=None):
    """K1 on operands at a head dim it is built for."""
    _check_operands("K1", q, k, v, mask)
    b, h, n_q, d = q.shape
    if block_q is None:
        block_q = k1_block_q(b, h, n_q, d, q.dtype, _sm_count(q.device.index))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, 1, n_q), dtype=torch.float32, device=q.device)
    entry = _entry(_K1, "vb_flash_attention_fwd", 6, 7)
    with torch.cuda.device(q.device):
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            b, h, n_q, k.shape[2], d, _DTYPES[q.dtype], block_q, float(scale), _stream(q),
        )
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError_t {err}")
    flash_attention.launches += 1
    return out, lse


def k23_f32_edges() -> Tuple[Tuple[int, int], ...]:
    """(n, kv) pairs at the edges of the fp32 K2/K3 tiling: 1, one under,
    at and one over each tile size (64 owned rows; 64 streamed rows at head
    dim 64, 32 at 128, 16 at 256), and the duration predictor's phoneme
    buckets (32, 64, 128), on both sides of each kernel (K2 owns query rows
    and streams keys, K3 the other way). The CPU tests, the card tests and
    chip_smoke.py hold the backward at these shapes."""
    return ((1, 1), (1, 65), (31, 33), (32, 32), (33, 31), (63, 65), (64, 64), (65, 63),
            (128, 128), (33, 128), (128, 33), (65, 1), (15, 17), (16, 16), (17, 15))


def flash_attention_bwd_dq(q, k, v, mask, do, lse, delta, scale) -> torch.Tensor:
    """K2: dq (b, h, n, d) in q's dtype from the forward's operands, its lse
    (b, h, 1, n), the output gradient do and delta = `attention_delta(do,
    out)`. CPU tensors take the plain version. `.launches` counts K2
    launches."""
    if q.device.type == "cpu":
        return _plain_backward(q, k, v, mask, lse, do, delta, scale)[0]
    return _k2(q, k, v, mask, do, lse, delta, scale)


def _k2(q, k, v, mask, do, lse, delta, scale):
    """K2 at q's head dim, its operands zero-padded to `kernel_head_dim`."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale  # the true d's
    width = kernel_head_dim(d, q.dtype)
    return _narrow(d, _k2_kernel(*_widen(width, q, k, v), mask, *_widen(width, do), lse, delta,
                                 scale))


def _k2_kernel(q, k, v, mask, do, lse, delta, scale):
    _check_backward_operands("K2", q, k, v, mask, do, lse, delta)
    b, h, n_q, d = q.shape
    dq = torch.empty_like(q)
    entry = _entry(_BWD, "vb_flash_attention_bwd_dq", 8)
    with torch.cuda.device(q.device):
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, h, n_q, k.shape[2], d, _DTYPES[q.dtype], float(scale), _stream(q),
        )
    if err != 0:
        raise RuntimeError(f"K2 launch failed: cudaError_t {err}")
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, mask, do, lse, delta, scale
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: dk, dv (b, h, kv, d) in k's dtype, from the same operands as K2.
    CPU tensors take the plain version. `.launches` counts K3 launches."""
    if q.device.type == "cpu":
        return _plain_backward(q, k, v, mask, lse, do, delta, scale)[1:]
    return _k3(q, k, v, mask, do, lse, delta, scale)


def _k3(q, k, v, mask, do, lse, delta, scale):
    """K3 at q's head dim, its operands zero-padded to `kernel_head_dim`."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale  # the true d's
    width = kernel_head_dim(d, q.dtype)
    dk, dv = _k3_kernel(*_widen(width, q, k, v), mask, *_widen(width, do), lse, delta, scale)
    return _narrow(d, dk), _narrow(d, dv)


def _k3_kernel(q, k, v, mask, do, lse, delta, scale):
    _check_backward_operands("K3", q, k, v, mask, do, lse, delta)
    b, h, n_q, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    entry = _entry(_BWD, "vb_flash_attention_bwd_dkv", 9)
    with torch.cuda.device(q.device):
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, n_q, k.shape[2], d, _DTYPES[q.dtype], float(scale), _stream(q),
        )
    if err != 0:
        raise RuntimeError(f"K3 launch failed: cudaError_t {err}")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """K1 forward; backward delta -> K2 -> K3 from the saved out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale):
        out, lse = _launch_k1(q, k, v, mask, scale)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        return _kernel_backward(*ctx.saved_tensors, dout, ctx.scale)


def _kernel_backward(q, k, v, mask, out, lse, dout, scale):
    """delta -> K2 -> K3; gradients for (q, k, v, mask, scale)."""
    do = dout.contiguous()
    delta = attention_delta(do, out)
    dq = flash_attention_bwd_dq(q, k, v, mask, do, lse, delta, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, mask, do, lse, delta, scale)
    return dq, dk, dv, None, None


@torch.library.custom_op("voicebox_tpu_torch::flash_attention_fwd", mutates_args=())
def _k1_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor],
           scale: float, scores_dtype: Optional[torch.dtype]
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 (the plain version on the CPU) as an op that a checkpoint policy
    can save. Its backward is `_FlashAttention`'s on the card and autograd
    of the plain version on the CPU, the two paths `flash_attention` takes
    outside remat."""
    if q.device.type == "cpu":
        with torch.no_grad():
            return reference_attention(q, k, v, mask, scale, return_lse=True,
                                       scores_dtype=scores_dtype)
    return _launch_k1(q, k, v, mask, scale)


@_k1_op.register_fake
def _(q, k, v, mask, scale, scores_dtype):
    return torch.empty_like(q), q.new_empty((*q.shape[:2], 1, q.shape[2]), dtype=torch.float32)


def _k1_op_setup(ctx, inputs, output):
    q, k, v, mask, scale, scores_dtype = inputs
    ctx.save_for_backward(q, k, v, mask, *output)
    ctx.scale, ctx.scores_dtype = scale, scores_dtype
    ctx.mark_non_differentiable(output[1])


def _k1_op_backward(ctx, dout, _dlse):
    q, k, v, mask, out, lse = ctx.saved_tensors  # unpacked once: remat recomputes on unpack
    if q.device.type != "cpu":
        return (*_kernel_backward(q, k, v, mask, out, lse, dout, ctx.scale), None)
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        out = reference_attention(*qkv, mask, ctx.scale, scores_dtype=ctx.scores_dtype)
        return (*torch.autograd.grad(out, qkv, dout), None, None, None)


_k1_op.register_autograd(_k1_op_backward, setup_context=_k1_op_setup)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    return_lse: bool = False,
    scores_dtype: Optional[torch.dtype] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Attention forward, same contract as `reference_attention`, and
    differentiable in q, k and v. CUDA tensors go through K1 and, backward,
    K2 + K3 (contiguous float32 or bfloat16 at any head dim, zero-padded to
    the width `kernel_head_dim` gives, else ValueError); CPU tensors through
    the plain version.

    `scores_dtype` reaches the plain version only, on CPU tensors. On CUDA
    tensors it changes nothing: K1 never holds the score matrix, its logits
    and sums are fp32 tile by tile, as the JAX package's Pallas kernel
    ignores the option.
    `flash_attention.launches` counts K1 launches."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention path for device {q.device}")
    if saves("attn_out") and saves("attn_lse"):  # a remat policy saves K1's outputs
        out, lse = _k1_op(q, k, v, mask, float(scale), scores_dtype)
    elif q.device.type == "cpu":
        out, lse = reference_attention(q, k, v, mask, scale, return_lse=True,
                                       scores_dtype=scores_dtype)
    else:
        out, lse = _FlashAttention.apply(q, k, v, mask, float(scale))
    out = checkpoint_name(out, "attn_out")
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
