"""Flight-data system identification: recover aero coefficient models from
recorded trajectories.

  1. ``extract_coefficients`` inverts the rigid-body dynamics at every
     sample (central-difference accelerations -> body forces/moments ->
     the six aero coefficients), batched over the whole trajectory on
     ``device``.
  2. The fitters (``fit_linear``, ``fit_polynomial``, ``train_mlp``)
     regress a coefficient model on the extracted (inputs, coefficients)
     samples, the same fitters used for wind-tunnel CSVs, so a flight log
     and a tunnel run are interchangeable data sources.

The inversion undoes, in order, everything ``aircraft.forces_moments``
applies on top of the raw model outputs: thrust, the CoM force-moment
cross term, the q̄·S·[1|b,c,b] normalisation, the drag-axis sign flip,
flap increments and stall scaling, so the extracted samples are in the
exact frame the coefficient models are trained in.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from aircraft_tpu_torch.dynamics import aircraft as ac
from aircraft_tpu_torch.dynamics import base
from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
from aircraft_tpu_torch.dynamics.coefficients import (
    _poly_eval,
    mlp_forward,
    model_inputs,
)
from aircraft_tpu_torch.ops import quaternion as quat
from aircraft_tpu_torch.surrogates import models as surrogate_models


class FlightSamples(NamedTuple):
    """Extracted training samples: model inputs and the six coefficients."""

    inputs: np.ndarray        # (n, 5) [qbar, alpha, beta, aileron, elevator]
    coefficients: np.ndarray  # (n, 6) [CX, CY, CZ, Cl, Cm, Cn]
    qbar: np.ndarray          # (n,) for weighting / filtering


class FitReport(NamedTuple):
    params: object            # fitted coefficient-model parameters
    r2: np.ndarray            # (6,) per-coefficient R^2 on the fit data
    samples: FlightSamples


def _extract_one(params: AircraftParams, x, u, v_dot, omega_dot, wind):
    """Invert the Newton-Euler + aero pipeline at samples x (..., 13),
    u (..., n_u) with the measured accelerations v_dot, omega_dot
    (..., 3).  Returns (inputs, coefficients, qbar, alpha, beta)."""
    q = x[..., base.QUAT]
    omega = x[..., base.OMEGA]

    # total body force from measured acceleration (undo gravity + frame)
    f_total = quat.rotate_inv(q, (v_dot - params.gravity) * params.mass)
    f_aero = f_total - u[..., ac.THRUST] if params.thrust_enabled else f_total

    # total moment from measured angular acceleration
    com = ac.effective_com(params, u)
    inertia = base.inertia_about_com(params.static_inertia, params.mass, com)
    J_omega = torch.einsum("...ij,...j->...i", inertia, omega)
    m_total = (torch.einsum("...ij,...j->...i", inertia, omega_dot)
               + torch.linalg.cross(omega, J_omega, dim=-1))
    # the forward plant's CoM moment arm acts on the TOTAL body force
    # including thrust (forces_moments: m_aero + com x f), so the
    # inversion subtracts com x f_total, not com x f_aero
    m_aero = m_total - torch.linalg.cross(*torch.broadcast_tensors(
        com, f_total), dim=-1)

    aero = ac.aero_state(params, x, u, wind)
    denom_f = aero.qbar * params.S
    denom_m = denom_f[..., None] * torch.stack(
        [params.b, params.c, params.b], dim=-1)

    cf = f_aero / denom_f[..., None]
    cm = m_aero / denom_m

    # undo the drag-axis sign flip (forces_moments: f_x *= sign(u_rel))
    u_rel = ac.v_frd_rel(params, x, u, wind)[..., 0]
    cols = list(torch.cat([cf, cm], dim=-1).unbind(-1))
    cols[0] = cols[0] * torch.sign(u_rel)

    # undo the rudder yaw correction every fitted model's apply function
    # re-adds at plant-eval time: the training target is the RAW 5-input
    # model output without that term, or the fit absorbs it through
    # correlated inputs and the plugged-back model double-counts it
    cn_rudder = getattr(params.coeff, "Cn_rudder", -0.1)
    cols[5] = cols[5] + (-cn_rudder * 6.0 * u[..., ac.RUDDER]
                         * np.deg2rad(1.0))

    # undo flap increments
    flaps = u[..., ac.FLAPS]
    cols[0] = cols[0] + (-ac.C_D_FLAPS * flaps)
    cols[2] = cols[2] + (-ac.C_Z_FLAPS * flaps)

    # undo stall scaling (well-conditioned inside the envelope; the scale
    # only approaches 0 beyond +-30deg alpha/beta, which the caller masks)
    if params.stall_scaling:
        stall_angle = float(np.deg2rad(30.0))
        steepness = 10.0
        alpha_scale = torch.sigmoid(
            -steepness * (torch.abs(aero.alpha) - stall_angle))
        beta_scale = torch.sigmoid(
            -steepness * (torch.abs(aero.beta) - stall_angle))
        cols[2] = cols[2] / torch.clamp_min(alpha_scale * beta_scale, 1e-3)
        cols[4] = cols[4] / torch.clamp_min(alpha_scale, 1e-3)

    inp = model_inputs(aero, u[..., ac.AILERON], u[..., ac.ELEVATOR])
    return inp, torch.stack(cols, dim=-1), aero.qbar, aero.alpha, aero.beta


def extract_coefficients(
    params: AircraftParams,
    xs: np.ndarray,
    us: np.ndarray,
    dt: float,
    wind=None,
    min_qbar: float = 10.0,
    max_angle_rad: float = np.deg2rad(25.0),
) -> FlightSamples:
    """Turn a recorded trajectory into coefficient-model training samples,
    on ``params``' device.

    xs: (T, 13) states sampled at `dt`; us: (T, n_u) or (T-1, n_u)
    controls.  Accelerations come from central differences, so samples
    cover the interior points 1..T-2.  Samples outside the aero-model
    envelope (near-zero dynamic pressure, post-stall angles where the
    stall-scaling inversion is ill-conditioned) are dropped.
    """
    dev = params.device
    xs = torch.tensor(np.asarray(xs, np.float32), device=dev)
    us = torch.tensor(np.asarray(us, np.float32), device=dev)
    if us.shape[0] == xs.shape[0] - 1:
        us = torch.cat([us, us[-1:]], dim=0)

    v = xs[:, base.VEL]
    om = xs[:, base.OMEGA]
    v_dot = (v[2:] - v[:-2]) / (2.0 * dt)
    omega_dot = (om[2:] - om[:-2]) / (2.0 * dt)
    x_mid, u_mid = xs[1:-1], us[1:-1]

    inp, coeffs, qbar, alpha, beta = (
        t.cpu().numpy() for t in _extract_one(params, x_mid, u_mid, v_dot,
                                              omega_dot, wind))
    inp = inp.astype(np.float64)
    coeffs = coeffs.astype(np.float64)
    qbar = qbar.astype(np.float64)
    keep = (
        (qbar > min_qbar)
        & (np.abs(alpha) < max_angle_rad)
        & (np.abs(beta) < max_angle_rad)
        & np.all(np.isfinite(inp), axis=-1)
        & np.all(np.isfinite(coeffs), axis=-1)
    )
    return FlightSamples(inputs=inp[keep].astype(np.float32),
                         coefficients=coeffs[keep].astype(np.float32),
                         qbar=qbar[keep].astype(np.float32))


def _r2(pred: np.ndarray, target: np.ndarray) -> np.ndarray:
    ss_res = ((pred - target) ** 2).sum(axis=0)
    ss_tot = ((target - target.mean(axis=0)) ** 2).sum(axis=0)
    return 1.0 - ss_res / np.maximum(ss_tot, 1e-12)


def identify(
    params: AircraftParams,
    xs: np.ndarray,
    us: np.ndarray,
    dt: float,
    model: str = "linear",
    wind=None,
    **fit_kwargs,
) -> FitReport:
    """End-to-end sysid: trajectory -> samples -> fitted coefficient model
    on ``params``' device.

    `model` is 'linear', 'poly', or 'nn' (the plant's coefficient-model
    registry keys, so the fitted params drop straight into
    ``replace(params, coeff=...)``).
    """
    samples = extract_coefficients(params, xs, us, dt, wind=wind)
    x, y = samples.inputs, samples.coefficients
    if x.shape[0] < 16:
        raise ValueError(
            f"only {x.shape[0]} usable samples after envelope filtering")

    dev = params.device
    if model == "linear":
        fitted = surrogate_models.fit_linear(x, y, device=dev)
        M = fitted.matrix.cpu().numpy()
        pred = x @ M.T[:5] + M[:, 5]
    elif model == "poly":
        fitted = surrogate_models.fit_polynomial(x, y, device=dev,
                                                 **fit_kwargs)
        pred = _poly_eval(fitted, torch.as_tensor(x, device=dev))
        pred = pred.cpu().numpy()
    elif model == "nn":
        result = surrogate_models.train_mlp(x, y, device=dev, **fit_kwargs)
        fitted = result.params
        with torch.no_grad():
            pred = mlp_forward(fitted, torch.as_tensor(x, device=dev))
        pred = pred.cpu().numpy()
    else:
        raise ValueError(f"unknown model '{model}'")

    return FitReport(params=fitted, r2=_r2(pred, y), samples=samples)


__all__ = ["FlightSamples", "FitReport", "extract_coefficients", "identify"]
