"""Aerodynamic reference frames and rotating-Earth fictitious
accelerations.

The stability and wind frames are rotations of the body frame by alpha
(about body y) and beta (about the stability z axis).  The rotating-Earth
terms are the standard rotating NED-frame kinematics,

    a_fict = -2 Ω×v  -  Ω×(Ω×(r_e + p))

with Ω the Earth-rate vector in local NED at geodetic latitude λ:
Ω = ω_e [cos λ, 0, -sin λ] (z down).  At glider speeds this is a ~1e-3
m/s² correction; the main plant leaves it out.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from aircraft_tpu_torch.device import resolve_device
from aircraft_tpu_torch.dynamics import base

OMEGA_EARTH = 7.292115e-5  # rad/s (WGS-84 nominal Earth rate)
R_EARTH = 6.371e6          # m (mean radius; spherical-Earth centrifugal arm)


def _rot_y(angle: torch.Tensor) -> torch.Tensor:
    """Rotation matrix about body y by ``angle`` (batched)."""
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, s], dim=-1),
                        torch.stack([z, o, z], dim=-1),
                        torch.stack([-s, z, c], dim=-1)], dim=-2)


def _rot_z(angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z], dim=-1),
                        torch.stack([s, c, z], dim=-1),
                        torch.stack([z, z, o], dim=-1)], dim=-2)


def _apply(R: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", R, vec)


def body_to_stability(vec: torch.Tensor, alpha) -> torch.Tensor:
    """Body (FRD) -> stability frame, R_y(+alpha): the stability x axis is
    the body x axis tilted by alpha toward body z, so
    x_s = u cos(alpha) + w sin(alpha) = V cos(beta)."""
    return _apply(_rot_y(torch.as_tensor(alpha, dtype=vec.dtype,
                                         device=vec.device)), vec)


def stability_to_body(vec: torch.Tensor, alpha) -> torch.Tensor:
    return _apply(_rot_y(-torch.as_tensor(alpha, dtype=vec.dtype,
                                          device=vec.device)), vec)


def body_to_wind(vec: torch.Tensor, alpha, beta) -> torch.Tensor:
    """Body -> wind frame (x along the relative airflow): the stability
    resolution by alpha, then beta about the stability z axis."""
    beta = torch.as_tensor(beta, dtype=vec.dtype, device=vec.device)
    return _apply(_rot_z(-beta), body_to_stability(vec, alpha))


def wind_to_body(vec: torch.Tensor, alpha, beta) -> torch.Tensor:
    beta = torch.as_tensor(beta, dtype=vec.dtype, device=vec.device)
    return stability_to_body(_apply(_rot_z(beta), vec), alpha)


def body_to_rdf(vec: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """Body -> reference-datum frame: a translation by ``offset`` (the
    aero-centre and control-surface stations)."""
    return vec + offset


@dataclass(frozen=True)
class EarthRotationParams:
    """Local-NED Earth-rotation model at a fixed geodetic latitude."""

    latitude_rad: torch.Tensor
    omega_earth: torch.Tensor
    r_earth: torch.Tensor

    @classmethod
    def at_latitude(cls, latitude_deg: float, dtype=torch.float32,
                    device="cuda") -> "EarthRotationParams":
        dev = resolve_device(device)
        t = lambda v: torch.tensor(v, dtype=dtype, device=dev)
        return cls(latitude_rad=t(float(np.deg2rad(latitude_deg))),
                   omega_earth=t(OMEGA_EARTH), r_earth=t(R_EARTH))

    @property
    def rate_ned(self) -> torch.Tensor:
        """Earth-rate vector in local NED: ω_e [cos λ, 0, -sin λ]."""
        lam = self.latitude_rad
        return self.omega_earth * torch.stack(
            [torch.cos(lam), torch.zeros_like(lam), -torch.sin(lam)], dim=-1)


def coriolis_acceleration(earth: EarthRotationParams,
                          v_ned: torch.Tensor) -> torch.Tensor:
    """-2 Ω × v, the Coriolis acceleration in the rotating NED frame."""
    omega = earth.rate_ned.expand(v_ned.shape)
    return -2.0 * torch.linalg.cross(omega, v_ned, dim=-1)


def centrifugal_acceleration(earth: EarthRotationParams,
                             p_ned: torch.Tensor) -> torch.Tensor:
    """-Ω × (Ω × r), r the position about the Earth's axis: the local
    vertical arm R_e (up, -z in NED) plus the NED offset."""
    r = torch.cat([p_ned[..., :2], (p_ned[..., 2] - earth.r_earth)[..., None]],
                  dim=-1)
    omega = earth.rate_ned.expand(p_ned.shape)
    return -torch.linalg.cross(omega, torch.linalg.cross(omega, r, dim=-1),
                               dim=-1)


def fictitious_acceleration(earth: EarthRotationParams, p_ned: torch.Tensor,
                            v_ned: torch.Tensor) -> torch.Tensor:
    """The whole rotating-frame correction to v̇ in NED."""
    return (coriolis_acceleration(earth, v_ned)
            + centrifugal_acceleration(earth, p_ned))


def with_earth_rotation(derivative_fn, earth: EarthRotationParams,
                        include_centrifugal: bool = False):
    """Wrap a plant derivative ``f(params, x, u, ...) -> xdot`` so its
    velocity block includes the rotating-Earth terms.

    By default only the Coriolis term is added: the plant's 9.81 m/s² is
    standard (measured) gravity, which already holds the centrifugal
    relief; adding -Ω×(Ω×r) on top would count it twice.  Pass
    ``include_centrifugal=True`` only for a plant whose gravity is pure
    gravitation."""

    def wrapped(params, x, u, *args, **kwargs):
        xdot = derivative_fn(params, x, u, *args, **kwargs)
        if include_centrifugal:
            a = fictitious_acceleration(earth, x[..., base.POS],
                                        x[..., base.VEL])
        else:
            a = coriolis_acceleration(earth, x[..., base.VEL])
        return torch.cat([xdot[..., base.POS], xdot[..., base.VEL] + a,
                          xdot[..., 6:]], dim=-1)

    return wrapped
