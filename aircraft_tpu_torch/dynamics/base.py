"""Generic 6-DoF rigid-body pieces.

State layout: x = [p_ned(3), v_ned(3), q_frd_ned(4, xyzw), omega_frd(3)]
(13).  NED frame: z is down, gravity = [0, 0, +9.81].

Every plant registers its parameter type with ``state_derivative`` and
``control_dim``, the one entry point the integrators and the controllers
call for any plant.
"""

from __future__ import annotations

from functools import singledispatch
from typing import Any

import torch

from aircraft_tpu_torch.ops import quaternion as quat

STATE_DIM = 13
POS = slice(0, 3)
VEL = slice(3, 6)
QUAT = slice(6, 10)
OMEGA = slice(10, 13)

# NED gravity [m/s²], a host constant: a plant moves it to its device
GRAVITY = torch.tensor([0.0, 0.0, 9.81])


def position(x: torch.Tensor) -> torch.Tensor:
    return x[..., POS]


def velocity(x: torch.Tensor) -> torch.Tensor:
    return x[..., VEL]


def orientation(x: torch.Tensor) -> torch.Tensor:
    return x[..., QUAT]


def angular_velocity(x: torch.Tensor) -> torch.Tensor:
    return x[..., OMEGA]


def pack_state(p, v, q, omega) -> torch.Tensor:
    return torch.cat([p, v, q, omega], dim=-1)


def normalize_quaternion_state(x: torch.Tensor) -> torch.Tensor:
    """Renormalise the quaternion block of a state vector."""
    q = quat.normalize(x[..., QUAT])
    return torch.cat([x[..., POS], x[..., VEL], q, x[..., OMEGA]], dim=-1)


def inertia_about_com(static_inertia: torch.Tensor, mass,
                      com: torch.Tensor) -> torch.Tensor:
    """Parallel-axis inertia J = J_static + m (|r|² I - r rᵀ)."""
    r2 = torch.sum(com * com, dim=-1)
    eye = torch.eye(3, dtype=com.dtype, device=com.device)
    return static_inertia + mass * (r2[..., None, None] * eye
                                    - com[..., :, None] * com[..., None, :])


def rigid_body_derivative(x: torch.Tensor, forces_frd: torch.Tensor,
                          moments_frd: torch.Tensor, mass,
                          inertia: torch.Tensor,
                          gravity: torch.Tensor) -> torch.Tensor:
    """Newton–Euler: ṗ = v, v̇ = R(q) F / m + g, q̇ = ½ q ⊗ (ω, 0),
    ω̇ = J⁻¹ (M − ω × J ω)."""
    q = x[..., QUAT]
    omega = x[..., OMEGA]
    v_dot = quat.rotate(q, forces_frd) / mass + gravity
    q_dot = quat.derivative(q, omega)
    J_omega = torch.einsum("...ij,...j->...i", inertia, omega)
    omega_b, J_omega = torch.broadcast_tensors(omega, J_omega)
    torque = moments_frd - torch.linalg.cross(omega_b, J_omega, dim=-1)
    omega_dot = solve3(inertia, torque)
    return torch.cat([x[..., VEL], v_dot, q_dot, omega_dot], dim=-1)


def solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A⁻¹ b for 3x3 A by cofactors: elementwise ops only, so it batches,
    differentiates and runs on the card without a solver call."""
    a = [[A[..., i, j] for j in range(3)] for i in range(3)]
    c00 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c01 = a[1][2] * a[2][0] - a[1][0] * a[2][2]
    c02 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c00 + a[0][1] * c01 + a[0][2] * c02
    inv = [[c00, a[0][2] * a[2][1] - a[0][1] * a[2][2],
            a[0][1] * a[1][2] - a[0][2] * a[1][1]],
           [c01, a[0][0] * a[2][2] - a[0][2] * a[2][0],
            a[0][2] * a[1][0] - a[0][0] * a[1][2]],
           [c02, a[0][1] * a[2][0] - a[0][0] * a[2][1],
            a[0][0] * a[1][1] - a[0][1] * a[1][0]]]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([(inv[i][0] * b0 + inv[i][1] * b1 + inv[i][2] * b2)
                        / det for i in range(3)], dim=-1)


@singledispatch
def state_derivative(params: Any, x: torch.Tensor,
                     u: torch.Tensor) -> torch.Tensor:
    """ẋ = f(x, u; params), registered per plant-parameter type."""
    raise TypeError(f"no dynamics registered for {type(params)}")


@singledispatch
def control_dim(params: Any) -> int:
    raise TypeError(f"no control dimension registered for {type(params)}")
