"""Moving-horizon estimation of the wind from a window of measurements.

Given the last W measured states and the applied controls, find the
constant wind vector whose one-step predictions best explain the
measurements: a small Levenberg-damped Gauss-Newton least-squares over
the plant's own step, a fixed number of iterations with no host read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from aircraft_tpu_torch.device import resolve_device
from aircraft_tpu_torch.dynamics import aircraft as ac
from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
from aircraft_tpu_torch.ops.autodiff import batched_jacfwd
from aircraft_tpu_torch.solvers import integrators


class MHEResult(NamedTuple):
    wind: torch.Tensor        # (3,) estimated NED wind
    residual: torch.Tensor    # RMS one-step prediction error at the optimum
    converged: torch.Tensor


def estimate_wind(params: AircraftParams, xs_meas, us, dt, substeps: int = 1,
                  iters: int = 8, device="cuda") -> MHEResult:
    """Gauss-Newton fit of a constant wind to the one-step prediction
    residuals of xs_meas (W+1, 13) under us (W, 7): each step predicts
    x̂_{k+1} = F(x_k, u_k; wind), and the residual stacks its velocity and
    body-rate errors (positions are integrals; the velocity errors carry
    the wind)."""
    dev = resolve_device(device)
    if params.device != dev:
        params = params.to(dev)
    xs_meas = torch.as_tensor(xs_meas, dtype=torch.float32, device=dev)
    us = torch.as_tensor(us, dtype=torch.float32, device=dev)

    def residuals(wind):
        """(1, 3) wind -> (1, 6W) stacked residuals."""
        pred = integrators.step(
            params, xs_meas[:-1], us, dt, substeps=substeps,
            normalize="step",
            derivative_fn=lambda xx, uu: ac.state_derivative(
                params, xx, uu, wind=wind))
        err = torch.cat([pred[:, 3:6] - xs_meas[1:, 3:6],
                         pred[:, 10:13] - xs_meas[1:, 10:13]], dim=-1)
        return err.reshape(1, -1)

    eye = torch.eye(3, dtype=xs_meas.dtype, device=dev)
    wind = xs_meas.new_zeros(1, 3)
    lam = torch.tensor(1e-4, dtype=xs_meas.dtype, device=dev)
    for _ in range(iters):
        r = residuals(wind)[0]
        J = batched_jacfwd(residuals, wind)[0]
        H = J.T @ J + lam * eye
        wind_new = wind - torch.linalg.solve(H, J.T @ r)[None]
        improved = (torch.sum(residuals(wind_new) ** 2)
                    < torch.sum(r * r))
        wind = torch.where(improved, wind_new, wind)
        lam = torch.where(improved, torch.clamp_min(lam * 0.5, 1e-8),
                          lam * 4.0)
    r = residuals(wind)
    rms = torch.sqrt(torch.mean(r * r))
    return MHEResult(wind=wind[0], residual=rms, converged=rms < 1.0)
