"""AdamW with the reference's decay grouping, the fp32 global-norm clip and
the warmup -> cosine schedule.

Counterpart of `voicebox_tpu/training/optimizer.py` (`get_optimizer`,
`decay_mask`, `clip_by_global_norm_f32`, `warmup_cosine_schedule`) on
`torch.optim`:

* parameters with ndim >= 2 get weight decay, the rest (biases, norm gains,
  the sinusoidal weights) do not; the ndim of every parameter is the same in
  both layouts (`MultiheadRMSNorm.gamma` is (h, 1, d) in both, so it decays
  in both). Two param groups of `torch.optim.AdamW`, or `torch.optim.Adam`
  when wd == 0. AdamW's decoupled decay p (1 - lr wd) equals optax's
  -lr (update + wd p);
* the clip is optax's: scale = max_norm / norm when norm >= max_norm, else 1,
  with the squares summed in fp32 (`torch.nn.utils.clip_grad_norm_` adds
  1e-6 to the norm and does not match);
* the schedule is optax's linear warmup initial_lr -> lr over the warmup
  steps, then cosine decay from lr over `num_train_steps` steps, evaluated
  at the number of steps taken (a `LambdaLR` stepped after each update).

The bf16-moment and EMA options of the JAX package are not ported yet.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch
from torch.optim.lr_scheduler import LambdaLR

__all__ = [
    "clip_by_global_norm_f32",
    "decay_mask",
    "get_optimizer",
    "warmup_cosine_lr",
    "warmup_cosine_schedule",
]


def decay_mask(named_params: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, bool]:
    """{name: True} for the parameters that get weight decay (ndim >= 2)."""
    return {name: p.ndim >= 2 for name, p in named_params}


def get_optimizer(
    named_params: Iterable[Tuple[str, torch.nn.Parameter]],
    lr: float = 1e-4,
    wd: float = 1e-2,
    betas: Tuple[float, float] = (0.9, 0.99),
    eps: float = 1e-8,
) -> torch.optim.Optimizer:
    """AdamW over two groups (decayed: ndim >= 2; not decayed: the rest), or
    Adam when wd == 0."""
    named = [(n, p) for n, p in named_params if p.requires_grad]
    if wd <= 0:
        return torch.optim.Adam([p for _, p in named], lr=lr, betas=betas, eps=eps)
    mask = decay_mask(named)
    groups = [
        {"params": [p for n, p in named if mask[n]], "weight_decay": wd},
        {"params": [p for n, p in named if not mask[n]], "weight_decay": 0.0},
    ]
    return torch.optim.AdamW([g for g in groups if g["params"]], lr=lr, betas=betas, eps=eps)


@torch.no_grad()
def clip_by_global_norm_f32(grads: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale the gradients in place by max_norm / norm when the global norm
    (squares summed in fp32) is at least max_norm; returns the norm before
    clipping, a 0-d fp32 tensor on the gradients' device. No host sync."""
    grads = [g for g in grads if g is not None]
    norms = torch._foreach_norm(grads, 2.0, dtype=torch.float32)
    norm = torch.linalg.vector_norm(torch.stack(norms))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm.clamp_min(1e-16))
    torch._foreach_mul_(grads, scale)
    return norm


def warmup_cosine_lr(step: int, lr: float, initial_lr: float, num_warmup_steps: int,
                     num_train_steps: int) -> float:
    """The learning rate after `step` updates: optax's
    join(linear(initial_lr -> lr, warmup), cosine_decay(lr, num_train_steps))."""
    decay_steps = max(num_train_steps, 1)
    if num_warmup_steps > 0:
        if step < num_warmup_steps:
            frac = 1.0 - step / num_warmup_steps
            return (initial_lr - lr) * frac + lr
        step -= num_warmup_steps
    count = min(step, decay_steps)
    return lr * 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))


def warmup_cosine_schedule(optimizer: torch.optim.Optimizer, lr: float, initial_lr: float,
                           num_warmup_steps: int, num_train_steps: int) -> LambdaLR:
    """A LambdaLR over an optimizer built with learning rate `lr`; call its
    `step()` after each optimizer step."""
    return LambdaLR(optimizer, lambda step: warmup_cosine_lr(
        step, lr, initial_lr, num_warmup_steps, num_train_steps) / lr)
