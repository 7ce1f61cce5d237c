"""Fixed-wing aircraft dynamics as batched PyTorch functions.

Control layout: u = [aileron, elevator, rudder, thrust(3), flaps] (7);
the trim variant appends the CoM offset (10).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from aircraft_tpu_torch.config import RHO, AircraftConfig
from aircraft_tpu_torch.device import resolve_device
from aircraft_tpu_torch.dynamics import base
from aircraft_tpu_torch.dynamics.base import OMEGA, QUAT, VEL
from aircraft_tpu_torch.dynamics.coefficients import (
    AeroState,
    DefaultCoeffParams,
    apply_coefficients,
)
from aircraft_tpu_torch.ops import quaternion as quat
from aircraft_tpu_torch.ops.elementwise import clip

CONTROL_DIM = 7
TRIM_CONTROL_DIM = 10
AILERON, ELEVATOR, RUDDER = 0, 1, 2
THRUST = slice(3, 6)
FLAPS = 6
COM = slice(7, 10)

# flap increments
C_Z_FLAPS = -0.6
C_D_FLAPS = -0.1

_TENSOR_FIELDS = ("mass", "S", "b", "c", "com", "static_inertia",
                  "rudder_moment_arm", "gravity")


@dataclass(frozen=True)
class AircraftParams:
    """Geometry, inertia and aero-model parameters of the glider plant.
    ``com_in_moments``: moments about the CoM include com × F."""

    mass: torch.Tensor
    S: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    com: torch.Tensor
    static_inertia: torch.Tensor
    rudder_moment_arm: torch.Tensor
    gravity: torch.Tensor
    coeff: object
    epsilon: float = 1e-6
    stall_scaling: bool = False
    thrust_enabled: bool = False
    com_in_control: bool = False
    com_in_moments: bool = True

    @classmethod
    def from_config(cls, config: AircraftConfig, coeff=None, *,
                    device="cuda", **switches) -> "AircraftParams":
        return cls.from_numpy(dict(
            mass=config.mass, S=config.reference_area, b=config.span,
            c=config.chord, com=config.aero_centre_offset,
            static_inertia=config.static_inertia,
            rudder_moment_arm=config.rudder_moment_arm,
            gravity=base.GRAVITY.numpy()), coeff=coeff, device=device,
            **switches)

    @classmethod
    def from_numpy(cls, arrays: dict, coeff=None, *, device="cuda",
                   **switches) -> "AircraftParams":
        """Parameters from numpy values keyed like the fields (the form a
        test extracts from the reference's params)."""
        dev = resolve_device(device)
        kw = {k: torch.as_tensor(np.array(arrays[k], np.float32),
                                 device=dev) for k in _TENSOR_FIELDS}
        if "epsilon" in arrays:
            kw["epsilon"] = float(arrays["epsilon"])
        coeff = DefaultCoeffParams() if coeff is None else coeff.to(dev)
        return cls(coeff=coeff, **kw, **switches)

    def to(self, device) -> "AircraftParams":
        return replace(self, coeff=self.coeff.to(device),
                       **{k: getattr(self, k).to(device)
                          for k in _TENSOR_FIELDS})

    @property
    def device(self) -> torch.device:
        return self.mass.device

    @property
    def control_dim(self) -> int:
        return TRIM_CONTROL_DIM if self.com_in_control else CONTROL_DIM


def effective_com(params: AircraftParams, u: torch.Tensor) -> torch.Tensor:
    if params.com_in_control:
        return u[..., COM]
    return params.com.expand(u.shape[:-1] + (3,))


def v_frd_rel(params: AircraftParams, x, u, wind=None) -> torch.Tensor:
    """Wind-relative body-frame velocity (+ epsilon per component)."""
    vel = x[..., VEL]
    if wind is not None:
        vel = vel + wind
    return quat.rotate_inv(x[..., QUAT], vel) + params.epsilon


def aero_state(params: AircraftParams, x, u, wind=None) -> AeroState:
    """All flow quantities feeding the coefficient models."""
    eps = params.epsilon
    v_rel = v_frd_rel(params, x, u, wind)
    uu, vv, ww = v_rel[..., 0], v_rel[..., 1], v_rel[..., 2]
    omega = x[..., OMEGA]
    p, q, r = omega[..., 0], omega[..., 1], omega[..., 2]

    airspeed = torch.sqrt(uu * uu + vv * vv + ww * ww + eps)
    alpha = torch.atan2(ww, uu + eps)
    beta = torch.asin(clip(vv / airspeed, -1.0, 1.0))
    qbar = 0.5 * RHO * (uu * uu + vv * vv + ww * ww)

    arm = params.rudder_moment_arm
    elevator_alpha = torch.atan2(ww + arm * q, uu + eps)
    left_wing_alpha = torch.atan2(ww - params.b * p / 4.0, uu + eps)
    right_wing_alpha = torch.atan2(ww + params.b * p / 4.0, uu + eps)
    v_rud = vv - arm * r
    airspeed_rud = torch.sqrt(uu * uu + v_rud * v_rud + ww * ww + eps)
    rudder_beta = torch.asin(clip(v_rud / airspeed_rud, -1.0, 1.0))
    u_wing = uu + params.b * r / 4.0
    wing_qbar = 0.5 * RHO * u_wing * u_wing
    return AeroState(qbar=qbar, alpha=alpha, beta=beta, omega=omega,
                     elevator_alpha=elevator_alpha,
                     left_wing_alpha=left_wing_alpha,
                     right_wing_alpha=right_wing_alpha,
                     left_wing_qbar=wing_qbar, right_wing_qbar=wing_qbar,
                     rudder_beta=rudder_beta)


def _coefficients(params: AircraftParams, aero: AeroState, u):
    """[CX, CY, CZ, Cl, Cm, Cn] after stall scaling and flap increments."""
    out = apply_coefficients(params.coeff, aero, u[..., AILERON],
                             u[..., ELEVATOR], u[..., RUDDER])
    cols = list(out.unbind(-1))
    if params.stall_scaling:
        stall_angle = float(np.deg2rad(30.0))
        a_s = torch.sigmoid(-10.0 * (torch.abs(aero.alpha) - stall_angle))
        b_s = torch.sigmoid(-10.0 * (torch.abs(aero.beta) - stall_angle))
        cols[2] = cols[2] * (a_s * b_s)
        cols[4] = cols[4] * a_s
    flaps = u[..., FLAPS]
    cols[0] = cols[0] + C_D_FLAPS * flaps
    cols[2] = cols[2] + C_Z_FLAPS * flaps
    return torch.stack(cols, dim=-1)


def coefficients(params: AircraftParams, x, u, wind=None) -> torch.Tensor:
    """The six aero coefficients [CX, CY, CZ, Cl, Cm, Cn] at (x, u)."""
    return _coefficients(params, aero_state(params, x, u, wind), u)


def forces_frd(params: AircraftParams, x, u, wind=None) -> torch.Tensor:
    """Body-frame aero forces (``forces_moments``' first half)."""
    return forces_moments(params, x, u, wind)[0]


def moments_frd(params: AircraftParams, x, u, wind=None) -> torch.Tensor:
    """Body-frame moments about the CoM (``forces_moments``' second half)."""
    return forces_moments(params, x, u, wind)[1]


def forces_moments(params: AircraftParams, x, u, wind=None):
    """Body-frame aero forces (drag anti-aligned to the relative flow) and
    moments C q̄ S [b, c, b] (+ com × F), from one flow evaluation."""
    aero = aero_state(params, x, u, wind)
    coeffs = _coefficients(params, aero, u)
    qS = aero.qbar * params.S
    f = coeffs[..., :3] * qS[..., None]
    u_rel = v_frd_rel(params, x, u, wind)[..., 0]
    f = torch.cat([(f[..., 0] * torch.sign(u_rel))[..., None], f[..., 1:]],
                  dim=-1)
    if params.thrust_enabled:
        f = f + u[..., THRUST]
    m = coeffs[..., 3:] * (qS[..., None] * torch.stack(
        [params.b, params.c, params.b]))
    if params.com_in_moments:
        com, fb = torch.broadcast_tensors(effective_com(params, u), f)
        m = m + torch.linalg.cross(com, fb, dim=-1)
    return f, m


def state_derivative(params: AircraftParams, x, u, wind=None) -> torch.Tensor:
    """Full 13-state derivative."""
    f, m = forces_moments(params, x, u, wind)
    inertia = base.inertia_about_com(params.static_inertia, params.mass,
                                     effective_com(params, u))
    return base.rigid_body_derivative(x, f, m, params.mass, inertia,
                                      params.gravity)


base.state_derivative.register(
    AircraftParams, lambda p, x, u: state_derivative(p, x, u))
base.control_dim.register(AircraftParams, lambda p: p.control_dim)

__all__ = ["AircraftParams", "aero_state", "coefficients", "forces_frd",
           "forces_moments", "moments_frd", "state_derivative"]
