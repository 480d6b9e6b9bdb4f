"""AdamW with the reference's decay grouping, the fp32 global-norm clip, the
warmup -> cosine schedule, Adam with reduced-precision moments and the
parameter EMA.

Counterpart of `voicebox_tpu/training/optimizer.py` (`get_optimizer`,
`decay_mask`, `clip_by_global_norm_f32`, `warmup_cosine_schedule`,
`track_params_ema`, `adam_state_from_opt_state`, `restore_adam_state`) on
`torch.optim`:

* parameters with ndim >= 2 get weight decay, the rest (biases, norm gains,
  the sinusoidal weights) do not; the ndim of every parameter is the same in
  both layouts (`MultiheadRMSNorm.gamma` is (h, 1, d) in both, so it decays
  in both). Two param groups of `torch.optim.AdamW`, or `torch.optim.Adam`
  when wd == 0. AdamW's decoupled decay p (1 - lr wd) equals optax's
  -lr (update + wd p);
* the clip is optax's: scale = max_norm / norm when norm >= max_norm, else 1,
  with the squares summed in fp32 (`torch.nn.utils.clip_grad_norm_` adds
  1e-6 to the norm and does not match); under FSDP the sum of squares of
  the shards is all-reduced first;
* the schedule is optax's linear warmup initial_lr -> lr over the warmup
  steps, then cosine decay from lr over `num_train_steps` steps, evaluated
  at the number of steps taken (a `LambdaLR` stepped after each update);
* `moment_dtype` (bf16): `AdamLowPrecisionMoments`, the JAX chain
  `_scale_by_adam_fused` -> `add_decayed_weights` -> `scale_by_learning_rate`
  with its roundings: both moments computed in fp32 and stored in
  `moment_dtype`, the bias-corrected update cast to `moment_dtype`, then
  wd * p added in fp32 and the sum scaled by -lr. (`torch.optim.AdamW` keeps
  its moments in the parameter's dtype and decays as p (1 - lr wd).)
* `ParamsEMA`: the EMA of the post-step parameters, e += (1 - decay)(p - e)
  in fp32, stored in `ema_dtype` (`track_params_ema`, the chain's last
  stage).

`adam_state` / `restore_adam_state` read and write (exp_avg, exp_avg_sq,
step) per parameter of either optimizer, for the checkpoints.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.optim.lr_scheduler import LambdaLR

from ..parallel.collectives import all_reduce

__all__ = [
    "AdamLowPrecisionMoments",
    "ParamsEMA",
    "adam_state",
    "clip_by_global_norm_f32",
    "decay_mask",
    "get_optimizer",
    "restore_adam_state",
    "warmup_cosine_lr",
    "warmup_cosine_schedule",
]


def decay_mask(named_params: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, bool]:
    """{name: True} for the parameters that get weight decay (ndim >= 2)."""
    return {name: p.ndim >= 2 for name, p in named_params}


class AdamLowPrecisionMoments(torch.optim.Optimizer):
    """Adam(W) whose two moments are stored in `moment_dtype`, in the JAX
    package's order: per parameter, with count c and g in fp32,

        m = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) g^2     (fp32, stored rounded)
        u = round(m / (1 - b1^c) / (sqrt(v / (1 - b2^c)) + eps))
        p = p + (-lr) (u + wd p)                               (fp32)

    `step(grads)` takes the gradients as a {parameter: gradient} mapping
    (they may be bf16 for fp32 parameters), or reads `.grad`. The state of a parameter
    is torch's Adam layout (`step`, `exp_avg`, `exp_avg_sq`), so the state
    dict loads like AdamW's."""

    def __init__(self, params, lr: float = 1e-4, betas=(0.9, 0.99), eps: float = 1e-8,
                 weight_decay: float = 0.0, moment_dtype=torch.bfloat16):
        defaults = dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay,
                        moment_dtype=moment_dtype)
        super().__init__(params, defaults)

    def _init_state(self, p):
        st = self.state[p]
        if not st:
            dt = self.param_groups[0]["moment_dtype"]
            st["step"] = torch.zeros((), dtype=torch.float32)
            st["exp_avg"] = torch.zeros_like(p, dtype=dt, memory_format=torch.preserve_format)
            st["exp_avg_sq"] = torch.zeros_like(p, dtype=dt,
                                                memory_format=torch.preserve_format)
        return st

    @torch.no_grad()
    def step(self, grads=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            ps, gs, ms, vs = [], [], [], []
            for p in group["params"]:
                g = p.grad if grads is None else grads.get(p)
                if g is None:
                    continue
                st = self._init_state(p)
                ps.append(p)
                gs.append(g.float())
                ms.append(st["exp_avg"])
                vs.append(st["exp_avg_sq"])
            if not ps:
                continue
            count = float(self.state[ps[0]]["step"]) + 1.0
            for p in ps:
                self.state[p]["step"].fill_(count)
            f32 = np.float32
            bc1 = float(f32(1.0) - np.power(f32(b1), f32(count)))
            bc2 = float(f32(1.0) - np.power(f32(b2), f32(count)))
            m32 = torch._foreach_mul([m.float() for m in ms], b1)
            torch._foreach_add_(m32, gs, alpha=1.0 - b1)  # b1 m + (1 - b1) g
            v32 = torch._foreach_mul([v.float() for v in vs], b2)
            torch._foreach_add_(v32, torch._foreach_mul(torch._foreach_mul(gs, gs), 1.0 - b2))
            for dst, src in ((ms, m32), (vs, v32)):
                torch._foreach_copy_(dst, src)
            denom = torch._foreach_sqrt(torch._foreach_div(v32, bc2))
            torch._foreach_add_(denom, group["eps"])
            upd = torch._foreach_div(torch._foreach_div(m32, bc1), denom)
            upd = [u.to(group["moment_dtype"]).float() for u in upd]
            if group["weight_decay"] > 0:
                torch._foreach_add_(upd, torch._foreach_mul(ps, group["weight_decay"]))
            torch._foreach_mul_(upd, -group["lr"])
            torch._foreach_add_(ps, upd)


class ParamsEMA:
    """The exponential moving average of parameters, kept in `dtype` (the
    parameters' when None): after each optimizer step,
    ema = round(ema + (1 - decay) (p - ema)) computed in fp32. Starts as a
    copy of the parameters."""

    def __init__(self, params, decay: float, dtype=None):
        assert 0.0 < decay < 1.0, decay
        self.decay = decay
        self.params = list(params)
        self.shadow = [p.detach().to(dtype or p.dtype, copy=True) for p in self.params]

    @torch.no_grad()
    def update(self) -> None:
        e32 = [e.float() for e in self.shadow]
        delta = torch._foreach_sub([p.float() for p in self.params], e32)
        torch._foreach_mul_(delta, 1.0 - self.decay)
        torch._foreach_add_(e32, delta)
        torch._foreach_copy_(self.shadow, e32)

    @torch.no_grad()
    def reset(self) -> None:
        """Restart the average at the parameters' values."""
        torch._foreach_copy_(self.shadow, [p.detach() for p in self.params])


def get_optimizer(
    named_params: Iterable[Tuple[str, torch.nn.Parameter]],
    lr: float = 1e-4,
    wd: float = 1e-2,
    betas: Tuple[float, float] = (0.9, 0.99),
    eps: float = 1e-8,
    moment_dtype=None,
) -> torch.optim.Optimizer:
    """AdamW over two groups (decayed: ndim >= 2; not decayed: the rest), or
    Adam when wd == 0; `AdamLowPrecisionMoments` over the same groups when
    `moment_dtype` is given."""
    named = [(n, p) for n, p in named_params if p.requires_grad]
    mask = decay_mask(named)
    groups = [
        {"params": [p for n, p in named if mask[n]], "weight_decay": wd if wd > 0 else 0.0},
        {"params": [p for n, p in named if not mask[n]], "weight_decay": 0.0},
    ]
    if moment_dtype is not None:
        return AdamLowPrecisionMoments([g for g in groups if g["params"]], lr=lr, betas=betas,
                                       eps=eps, moment_dtype=moment_dtype)
    if wd <= 0:
        return torch.optim.Adam([p for _, p in named], lr=lr, betas=betas, eps=eps)
    return torch.optim.AdamW([g for g in groups if g["params"]], lr=lr, betas=betas, eps=eps)


def adam_state(optimizer: torch.optim.Optimizer, params) -> Tuple[list, list, int]:
    """(exp_avg list, exp_avg_sq list, step count) for `params` in their
    order; a parameter without state gets None (the optimizer never stepped
    it)."""
    mus, nus, count = [], [], 0
    for p in params:
        st = optimizer.state.get(p, {})
        mus.append(st.get("exp_avg"))
        nus.append(st.get("exp_avg_sq"))
        if "step" in st:
            count = max(count, int(float(st["step"])))
    return mus, nus, count


@torch.no_grad()
def restore_adam_state(optimizer: torch.optim.Optimizer, params, mus, nus, count: int) -> None:
    """Install the moments (any float dtype; cast to the optimizer's moment
    dtype) and the step count for `params`; a None moment leaves that
    parameter without state. AdamW keeps fp32 moments for fp32 parameters,
    `AdamLowPrecisionMoments` its `moment_dtype`."""
    dt = None
    if isinstance(optimizer, AdamLowPrecisionMoments):
        dt = optimizer.param_groups[0]["moment_dtype"]
    for p, mu, nu in zip(params, mus, nus):
        optimizer.state.pop(p, None)
        if mu is None:
            continue
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu.to(p.device, dt or p.dtype, copy=True),
            "exp_avg_sq": nu.to(p.device, dt or p.dtype, copy=True),
        }


@torch.no_grad()
def clip_by_global_norm_f32(grads: Iterable[torch.Tensor], max_norm: float,
                            group=None, counted: Optional[Sequence[bool]] = None
                            ) -> torch.Tensor:
    """Scale the gradients in place by max_norm / norm when the global norm
    (squares summed in fp32) is at least max_norm; returns the norm before
    clipping, a 0-d fp32 tensor on the gradients' device. No host sync.

    Under a mesh (`group`: a process group, or a tuple of groups: a mesh's
    axes) the gradients are this rank's pieces: shards over "data",
    tensor-parallel pieces, or whole gradients that several ranks hold.
    `counted` (one flag per gradient, required with `group`) says which of
    them this rank counts, each distinct piece on one rank; the sum of
    squares is then all-reduced over each group in turn before the scale,
    so every rank clips by the norm of the whole gradient."""
    grads = list(grads)
    keep = [i for i, g in enumerate(grads) if g is not None]
    grads = [grads[i] for i in keep]
    norms = torch._foreach_norm(grads, 2.0, dtype=torch.float32)
    if group is None:
        norm = torch.linalg.vector_norm(torch.stack(norms))
    else:
        if counted is None:
            raise ValueError("clip_by_global_norm_f32 needs `counted` with `group`")
        mine = torch.tensor([counted[i] for i in keep], device=norms[0].device)
        sumsq = (torch.stack(norms).square() * mine).sum()
        for g in group if isinstance(group, tuple) else (group,):
            all_reduce(sumsq, g)
        norm = sumsq.sqrt()
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
