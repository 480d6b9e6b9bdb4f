"""Bidirectional attention: the plain PyTorch version and the K1 wrapper.

Counterpart of `voicebox_tpu/ops/flash_attention.py`. Two functions compute
the same thing:

* `reference_attention` is the plain version (the JAX package's
  `reference_attention`): fp32 logits times `scale`, masked keys filled with
  -0.7 * f32max, an fp32 softmax, probabilities cast to v's dtype for the
  second product. With `return_lse=True` it also gives the per-row
  log-sum-exp of the filled logits, from `torch.logsumexp`.
* `flash_attention` is the wrapper of K1, the hand-written forward kernel in
  `csrc/flash_attention_fwd.cu`. On a CPU tensor it runs the plain version;
  on a CUDA tensor it launches K1 or raises. It never falls back.

The JAX package sends every call with kv <= 4096 to XLA's einsum (a rule
measured on a TPU); here every attention call on a CUDA tensor goes through
K1.

A row whose keys are all masked has one defined answer on both paths: every
real key gets the same filled logit, so the row is mean(V) over the real
keys, and its lse is fill + log(kv). (The JAX Pallas kernel gives
sum(V) / kv_padded there, which depends on its block size.)
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch

from .. import kernels

__all__ = ["MASK_FILL", "flash_attention", "reference_attention"]

MASK_FILL = -0.7 * torch.finfo(torch.float32).max

_K1 = "flash_attention_fwd"
_K1_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_K1_HEAD_DIMS = (64, 128)


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """q (b, h, n, d), k and v (b, h, kv, d), mask (b, kv) bool (True = keep).
    Returns out (b, h, n, d) in q's dtype and, with `return_lse`, lse
    (b, h, 1, n) fp32."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    # fp32 products of the stored values: the einsum's f32 accumulation
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        sim = sim.masked_fill(~mask[:, None, None, :], MASK_FILL)
    attn = torch.softmax(sim, dim=-1)
    out = torch.matmul(attn.to(v.dtype), v).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(sim, dim=-1).unsqueeze(2)


@functools.cache
def _k1_entry():
    fn = kernels.load(_K1).vb_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check_k1_operands(q, k, v, mask):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(
            f"K1 needs q, k, v on one CUDA device; got {q.device}, {k.device}, {v.device}"
        )
    if q.dtype not in _K1_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"K1 takes float32 or bfloat16 q, k, v of one dtype; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"K1 shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, h, n_q, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"K1 shapes: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if d not in _K1_HEAD_DIMS:
        raise ValueError(f"K1 takes head dim 64 or 128, got {d}")
    if n_q == 0 or k.shape[2] == 0 or h > 65535 or b > 65535:
        raise ValueError(f"K1 cannot launch for q {tuple(q.shape)}, k {tuple(k.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"K1 needs {name} contiguous and 16-byte aligned")
    if mask is not None:
        if mask.dtype != torch.bool or tuple(mask.shape) != (b, k.shape[2]):
            raise ValueError(
                f"K1 mask must be bool (b, kv) = {(b, k.shape[2])}, got "
                f"{mask.dtype} {tuple(mask.shape)}"
            )
        if mask.device != q.device or not mask.is_contiguous():
            raise ValueError("K1 mask must be contiguous and on q's device")


def _launch_k1(q, k, v, mask, scale):
    _check_k1_operands(q, k, v, mask)
    b, h, n_q, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, 1, n_q), dtype=torch.float32, device=q.device)
    entry = _k1_entry()
    with torch.cuda.device(q.device):
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            b, h, n_q, k.shape[2], d, _K1_DTYPES[q.dtype], float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError_t {err}")
    flash_attention.launches += 1
    return out, lse


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Attention forward, same contract as `reference_attention`. CUDA
    tensors go through K1 (contiguous float32 or bfloat16, head dim 64 or
    128, else ValueError); CPU tensors through the plain version.
    `flash_attention.launches` counts K1 launches."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return reference_attention(q, k, v, mask, scale, return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"no attention path for device {q.device}")
    out, lse = _launch_k1(q, k, v, mask, scale)
    return (out, lse) if return_lse else out


flash_attention.launches = 0
