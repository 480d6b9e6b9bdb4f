"""Fixed-grid ODE solvers (explicit midpoint, the paper's, Euler and RK4) and
the flow-matching interpolant of the training loss.

Counterpart of `voicebox_tpu/ops/ode.py::odeint` and `::cfm_interpolant`. A
solver steps over the given grid of times; `steps=3` in the sampler is
`linspace(0, 1, 3)`, two midpoint intervals, four evaluations of the vector
field. The adaptive Tsit5 of the JAX package is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

__all__ = ["cfm_interpolant", "odeint"]


def cfm_interpolant(x1: torch.Tensor, x0: torch.Tensor, times: torch.Tensor,
                    sigma: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The conditional-flow-matching interpolant and its target vector field,
    for per-sample times (b,) and x0, x1 (b, n, d):

        w    = (1 - (1 - sigma) t) x0 + t x1
        flow = x1 - (1 - sigma) x0
    """
    t = times[:, None, None].to(x1.dtype)
    w = (1.0 - (1.0 - sigma) * t) * x0 + t * x1
    flow = x1 - (1.0 - sigma) * x0
    return w, flow


def _midpoint_step(fn, y, t, h):
    k1 = fn(t, y)
    k2 = fn(t + h / 2, y + (h / 2) * k1)
    return y + h * k2


def _euler_step(fn, y, t, h):
    return y + h * fn(t, y)


def _rk4_step(fn, y, t, h):
    k1 = fn(t, y)
    k2 = fn(t + h / 2, y + (h / 2) * k1)
    k3 = fn(t + h / 2, y + (h / 2) * k2)
    k4 = fn(t + h, y + h * k3)
    return y + (h / 6) * (k1 + 2 * k2 + 2 * k3 + k4)


_METHODS = {"midpoint": _midpoint_step, "euler": _euler_step, "rk4": _rk4_step}


def odeint(
    fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    y0: torch.Tensor,
    times: torch.Tensor,
    method: str = "midpoint",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integrate dy/dt = fn(t, y) over the 1-D grid `times` (0-d tensor
    times are passed to `fn`). Returns (y_final, trajectory) with trajectory
    `(len(times), *y0.shape)`, torchdiffeq's contract."""
    if method not in _METHODS:
        raise ValueError(f"unknown ODE method {method!r}; choose from {sorted(_METHODS)}")
    step = _METHODS[method]
    y = y0
    trajectory = [y0]
    for t0, t1 in zip(times[:-1], times[1:]):
        y = step(fn, y, t0, t1 - t0)
        trajectory.append(y)
    return y, torch.stack(trajectory)
