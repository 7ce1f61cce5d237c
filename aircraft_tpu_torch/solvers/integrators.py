"""Fixed-step RK4 integration of the 6-DoF plant.

``normalize="step"`` renormalises the quaternion after every (sub)step;
``"none"`` leaves drift alone.  The reference's exponential-map normalise
mode and its implicit-Euler integration are not ported yet: asking for
either raises NotImplementedError.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from aircraft_tpu_torch.dynamics import aircraft, base
from aircraft_tpu_torch.ops.elementwise import scalar_like

NORMALIZE_MODES = ("none", "step")


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


def step(params, x: torch.Tensor, u: torch.Tensor, dt, *, substeps: int = 1,
         normalize: str = "none",
         derivative_fn: Callable | None = None) -> torch.Tensor:
    """One control interval: ``substeps`` RK4 steps of dt/substeps each."""
    if normalize not in NORMALIZE_MODES:
        raise NotImplementedError(f"normalize={normalize!r} is not ported")
    f = (derivative_fn if derivative_fn is not None
         else partial(aircraft.state_derivative, params))
    dt_i = dt / substeps
    for _ in range(substeps):
        x = rk4_step(f, x, u, dt_i)
        if normalize == "step":
            x = base.normalize_quaternion_state(x)
    return x


INTEGRATIONS = ("explicit",)


def make_step_fn(params, *, substeps: int = 1, normalize: str = "none",
                 derivative_fn: Callable | None = None,
                 integration: str = "explicit") -> Callable:
    """Bind integrator options; returns ``step(x, u, dt) -> x_next``.
    ``derivative_fn(x, u)`` replaces the plant's state derivative (a
    wind field, for one); ``integration='explicit'`` is RK4."""
    if integration not in INTEGRATIONS:
        raise NotImplementedError(
            f"integration={integration!r} is not ported (implicit Euler "
            "waits for the plant-breadth work)")
    if normalize not in NORMALIZE_MODES:
        raise NotImplementedError(
            f"normalize={normalize!r} is not ported (the exponential map "
            "waits for the plant-breadth work)")

    def fn(x, u, dt):
        return step(params, x, u, dt, substeps=substeps, normalize=normalize,
                    derivative_fn=derivative_fn)

    return fn
