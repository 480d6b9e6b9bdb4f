"""ODE solvers for the sampler and the flow-matching interpolant of the
training loss.

Counterpart of `voicebox_tpu/ops/ode.py`: `odeint` steps over a given grid
of times with explicit midpoint (the paper's), Euler, RK4 or Tsitouras 5(4)
(`"tsit5"`, seven evaluations of the vector field per interval); `steps=3`
in the sampler is `linspace(0, 1, 3)`, two intervals. `odeint_tsit5_adaptive`
is the reference's torchode path (Tsit5 with an integral step-size
controller): the step adapts on the RMS of the embedded error estimate, the
loop is bounded by `max_steps`, and a step at the floor (t1 - t) /
steps_remaining is accepted whatever its error, so the integration always
reaches t1. Its time and step size are fp32, as in the JAX loop, so both
take the same steps on the same vector field.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

__all__ = ["cfm_interpolant", "odeint", "odeint_tsit5", "odeint_tsit5_adaptive"]


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


# the Tsitouras 5(4) tableau (torchode's Tsit5)
_TSIT5_C = (0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0)
_TSIT5_A = (
    (),
    (0.161,),
    (-0.008480655492356989, 0.335480655492357),
    (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
    (5.325864828439257, -11.748883564062828, 7.4955393428898365, -0.09249506636175525),
    (5.86145544294642, -12.92096931784711, 8.159367898576159, -0.071584973281401,
     -0.028269050394068383),
    (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742, -3.290069515436081,
     2.324710524099774),
)
_TSIT5_B = (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
            -3.290069515436081, 2.324710524099774, 0.0)
# b(5th order) - b(4th order): the weights of the embedded error estimate
_TSIT5_B_ERR = (-0.00178001105222577714, -0.0008164344596567469, 0.007880878010261995,
                -0.1447110071732629, 0.5823571654525552, -0.45808210592918697, 1.0 / 66.0)


def _tsit5_stages(fn, y, t, h):
    """(y_next, error estimate) of one Tsit5 step: seven evaluations."""
    ks = []
    for c, row in zip(_TSIT5_C, _TSIT5_A):
        yi = y
        for a, k in zip(row, ks):
            yi = yi + h * a * k
        ks.append(fn(t + c * h, yi))
    y_next, err = y, torch.zeros_like(y)
    for k, b, be in zip(ks, _TSIT5_B, _TSIT5_B_ERR):
        y_next = y_next + h * b * k
        err = err + h * be * k
    return y_next, err


def _tsit5_step(fn, y, t, h):
    return _tsit5_stages(fn, y, t, h)[0]


_METHODS = {"midpoint": _midpoint_step, "euler": _euler_step, "rk4": _rk4_step,
            "tsit5": _tsit5_step}


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


def odeint_tsit5(fn, y0, times):
    """Fixed-grid Tsitouras 5(4): seven evaluations per interval."""
    return odeint(fn, y0, times, method="tsit5")


def odeint_tsit5_adaptive(
    fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    y0: torch.Tensor,
    t0: float = 0.0,
    t1: float = 1.0,
    atol: float = 1e-5,
    rtol: float = 1e-5,
    max_steps: int = 256,
    h0: float = 0.05,
) -> Tuple[torch.Tensor, int]:
    """Adaptive Tsit5 from t0 to t1 with the integral controller
    h <- h * clip(0.9 e^(-1/5), 0.2, 5) on the error norm
    e = rms(err / (atol + rtol max(|y|, |y_next|))). A step is accepted when
    e <= 1 or h sits at the floor (t1 - t) / steps_remaining; at most
    `max_steps` steps, accepted or not. Returns (y_final, steps taken).

    t and h are fp32 on the host, computed as the JAX loop computes them;
    each step reads e from the device once."""
    f32 = np.float32
    t, h, t_end = f32(t0), f32(h0), f32(t1)
    y, n = y0, 0
    while t < t_end and n < max_steps:
        h_min = (t_end - t) / f32(max(max_steps - n, 1))
        h = min(max(h, h_min), t_end - t)
        y_next, err = _tsit5_stages(fn, y, torch.tensor(t, dtype=torch.float32, device=y.device),
                                    torch.tensor(h, dtype=torch.float32, device=y.device))
        scale = atol + rtol * torch.maximum(y.abs(), y_next.abs())
        e = f32(torch.sqrt(torch.mean(torch.square(err / scale))).item())
        accept = e <= 1.0 or h <= h_min * f32(1.0 + 1e-6)
        factor = min(max(f32(0.9) * np.power(max(e, f32(1e-10)), f32(-0.2)), f32(0.2)),
                     f32(5.0))
        if accept:
            t, y = f32(t + h), y_next
        h = f32(h * factor)
        n += 1
    return y, n
