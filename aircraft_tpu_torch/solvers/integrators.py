"""Fixed-step integration of the 6-DoF plant: RK4, or implicit Euler
solved by Newton's method inside the step.

Quaternion-norm strategies:
  * ``normalize="none"``    leave drift to the transcription constraints
  * ``normalize="step"``    renormalise after every (sub)step
  * ``normalize="expmap"``  replace the quaternion block's update by the
                            exact exponential map of the substep's
                            midpoint body rate (norm-preserving)
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from aircraft_tpu_torch.dynamics import base
from aircraft_tpu_torch.dynamics.base import OMEGA, QUAT
from aircraft_tpu_torch.ops import quaternion as quat
from aircraft_tpu_torch.ops.autodiff import batched_jacfwd
from aircraft_tpu_torch.ops.elementwise import scalar_like

NORMALIZE_MODES = ("none", "step", "expmap")
INTEGRATIONS = ("explicit", "implicit")


def rk4_step(f: Callable, x: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
    """Classic RK4 with zero-order-hold control; ``dt`` a scalar or a
    tensor with x's batch axes.  The step's arithmetic runs in x's dtype:
    a Python dt is rounded to it first, so dt / 6 rounds as it would on a
    tensor dt."""
    dt = scalar_like(x, dt)[..., None]
    half = 0.5 * dt
    k1 = f(x, u)
    k2 = f(x + half * k1, u)
    k3 = f(x + half * k2, u)
    k4 = f(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def _apply_norm_mode(x_next: torch.Tensor, x_prev: torch.Tensor, dt,
                     normalize: str) -> torch.Tensor:
    if normalize == "none":
        return x_next
    if normalize == "step":
        return base.normalize_quaternion_state(x_next)
    omega_mid = 0.5 * (x_prev[..., OMEGA] + x_next[..., OMEGA])
    q_next = quat.integrate_expmap(x_prev[..., QUAT], omega_mid, dt)
    return torch.cat([x_next[..., :6], q_next, x_next[..., OMEGA]], dim=-1)


def _check_normalize(normalize: str):
    if normalize not in NORMALIZE_MODES:
        raise ValueError(f"normalize must be one of {NORMALIZE_MODES}, "
                         f"got {normalize!r}")


def _plant(params, derivative_fn):
    """The plant's derivative: ``derivative_fn``, else the one registered
    for the type of ``params`` (``base.state_derivative``)."""
    return (derivative_fn if derivative_fn is not None
            else partial(base.state_derivative, params))


def step(params, x: torch.Tensor, u: torch.Tensor, dt, *, substeps: int = 1,
         normalize: str = "none",
         derivative_fn: Callable | None = None) -> torch.Tensor:
    """One control interval: ``substeps`` RK4 steps of dt/substeps each."""
    _check_normalize(normalize)
    f = _plant(params, derivative_fn)
    dt_i = dt / substeps
    for _ in range(substeps):
        x_prev = x
        x = rk4_step(f, x, u, dt_i)
        x = _apply_norm_mode(x, x_prev, dt_i, normalize)
    return x


def implicit_euler_step(f: Callable, x: torch.Tensor, u: torch.Tensor, dt,
                        *, newton_iters: int = 3) -> torch.Tensor:
    """Implicit Euler x⁺ = x + dt f(x⁺, u) by ``newton_iters`` full Newton
    iterations on g(y) = y − x − dt f(y, u) from the explicit predictor.

    Newton, not fixed-point: the glider's rotational modes reach ~100 s⁻¹,
    so the fixed-point iteration diverges for dt ≳ 0.01.  Each iteration
    takes one 13x13 Jacobian per row (``batched_jacfwd``, never one over
    the whole batch) and solves with ``solve_ex``: a singular J gives
    non-finite states, as the reference's solve does, without the error
    check that would synchronise the stream.  The fixed trip count lets
    an outer forward-mode derivative pass through every iteration."""
    shape, n = x.shape, x.shape[-1]
    x = x.reshape(-1, n)                     # rows: every leading axis
    u = u.reshape(-1, u.shape[-1]).expand(x.shape[0], -1)
    dt = scalar_like(x, dt).reshape(-1, 1)   # (1, 1) or one per row
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    y = x + dt * f(x, u)
    for _ in range(newton_iters):
        g = y - x - dt * f(y, u)
        J = eye - dt[..., None] * batched_jacfwd(lambda yy: f(yy, u), y)
        y = y - torch.linalg.solve_ex(J, g[..., None])[0][..., 0]
    return y.reshape(shape)


def step_implicit(params, x: torch.Tensor, u: torch.Tensor, dt, *,
                  substeps: int = 1, normalize: str = "none",
                  derivative_fn: Callable | None = None,
                  newton_iters: int = 3) -> torch.Tensor:
    """Implicit-Euler control interval with substeps (mirror of ``step``)."""
    _check_normalize(normalize)
    f = _plant(params, derivative_fn)
    dt_i = dt / substeps
    for _ in range(substeps):
        x_prev = x
        x = implicit_euler_step(f, x, u, dt_i, newton_iters=newton_iters)
        x = _apply_norm_mode(x, x_prev, dt_i, normalize)
    return x


def make_step_fn(params, *, substeps: int = 1, normalize: str = "none",
                 derivative_fn: Callable | None = None,
                 integration: str = "explicit") -> Callable:
    """Bind integrator options; returns ``step(x, u, dt) -> x_next``.
    ``derivative_fn(x, u)`` replaces the plant's state derivative (a
    wind field, for one); ``integration`` is 'explicit' (RK4) or
    'implicit' (implicit Euler with its Newton solve)."""
    if integration not in INTEGRATIONS:
        raise ValueError(f"integration must be one of {INTEGRATIONS}, "
                         f"got {integration!r}")
    _check_normalize(normalize)
    fn = step if integration == "explicit" else step_implicit

    def bound(x, u, dt):
        return fn(params, x, u, dt, substeps=substeps, normalize=normalize,
                  derivative_fn=derivative_fn)

    return bound
