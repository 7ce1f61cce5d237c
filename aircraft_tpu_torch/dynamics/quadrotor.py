"""Quadrotor plant (the time-optimal simplification): unit mass,
identity inertia, four thrusts summed along body z, fixed mixer moments.
A cheap plant that exercises the OCP stack without aero data."""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from aircraft_tpu_torch.device import resolve_device
from aircraft_tpu_torch.dynamics import base

CONTROL_DIM = 4
_FIELDS = ("mass", "inertia", "gravity")


@dataclass(frozen=True)
class QuadrotorParams:
    mass: torch.Tensor
    inertia: torch.Tensor
    gravity: torch.Tensor

    @classmethod
    def default(cls, device="cuda") -> "QuadrotorParams":
        return cls.from_numpy({"mass": 1.0, "inertia": np.eye(3),
                               "gravity": [0.0, 0.0, 9.81]}, device=device)

    @classmethod
    def from_numpy(cls, arrays: dict, device="cuda") -> "QuadrotorParams":
        """Parameters from numpy values keyed like the fields."""
        dev = resolve_device(device)
        return cls(**{k: torch.as_tensor(np.array(arrays[k], np.float32),
                                         device=dev) for k in _FIELDS})

    def to(self, device) -> "QuadrotorParams":
        return replace(self, **{k: getattr(self, k).to(device)
                                for k in _FIELDS})

    @property
    def device(self) -> torch.device:
        return self.mass.device


def quadrotor_from_numpy(arrays: dict, device="cuda") -> QuadrotorParams:
    """The port's quadrotor parameters from the reference's fields as
    numpy arrays (mass, inertia, gravity)."""
    return QuadrotorParams.from_numpy(arrays, device)


def forces_frd(params: QuadrotorParams, x, u) -> torch.Tensor:
    total = torch.sum(u, dim=-1)
    zeros = torch.zeros_like(total)
    return torch.stack([zeros, zeros, total], dim=-1)


def moments_frd(params: QuadrotorParams, x, u) -> torch.Tensor:
    t0, t1, t2, t3 = u[..., 0], u[..., 1], u[..., 2], u[..., 3]
    return torch.stack([t0 - t1 - t2 + t3, -t0 - t1 + t2 + t3,
                        0.5 * (t0 - t1 + t2 - t3)], dim=-1)


def state_derivative(params: QuadrotorParams, x, u) -> torch.Tensor:
    return base.rigid_body_derivative(x, forces_frd(params, x, u),
                                      moments_frd(params, x, u), params.mass,
                                      params.inertia, params.gravity)


base.state_derivative.register(QuadrotorParams, state_derivative)
base.control_dim.register(QuadrotorParams, lambda p: CONTROL_DIM)
