"""Quaternion algebra in xyzw (scalar-last) storage, Hamilton product.

Every function works on the last axis and broadcasts over leading batch
axes.  ``rotate(q, v)`` maps body-frame (FRD) vectors into NED for
q = q_frd_ned; ``rotate_inv`` is the inverse sandwich.
"""

from __future__ import annotations

import torch

from aircraft_tpu_torch.ops.elementwise import clip, scalar_like


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    """The identity rotation [0, 0, 0, 1]."""
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


def multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 ⊗ q2."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def conjugate(q: torch.Tensor) -> torch.Tensor:
    """[-x, -y, -z, w]."""
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def inverse(q: torch.Tensor) -> torch.Tensor:
    """conj(q) / |q|² (the conjugate for a unit q)."""
    return conjugate(q) / torch.sum(q * q, dim=-1, keepdim=True)


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Project onto the unit sphere."""
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q ⊗ (v, 0) ⊗ q⁻¹ in the expanded Rodrigues form
    v' = v + 2 w (u × v) + 2 u × (u × v), u = q.xyz."""
    u = q[..., :3]
    w = q[..., 3:4]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q⁻¹ ⊗ (v, 0) ⊗ q (world -> body)."""
    return rotate(conjugate(q), v)


def to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """The 3x3 R with R @ v == rotate(q, v)."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def derivative(q: torch.Tensor, omega_body: torch.Tensor) -> torch.Tensor:
    """q̇ = ½ q ⊗ (ω, 0) with ω in the body frame."""
    omega_q = torch.cat([omega_body, torch.zeros_like(omega_body[..., :1])],
                        dim=-1)
    return 0.5 * multiply(q, omega_q)


def from_axis_angle(axis: torch.Tensor, angle) -> torch.Tensor:
    """The unit quaternion of a rotation by ``angle`` radians about the
    unit ``axis``; ``angle`` carries axis's batch axes, or one more
    trailing axis of size 1."""
    angle = scalar_like(axis, angle)
    half = 0.5 * (angle[..., None] if angle.dim() == axis.dim() - 1
                  else angle)
    half = half.expand(axis[..., :1].shape)
    return torch.cat([axis * torch.sin(half), torch.cos(half)], dim=-1)


def expmap(phi: torch.Tensor) -> torch.Tensor:
    """so(3) -> S3 exponential map, series-safe near zero."""
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(theta_sq + 1e-24)
    half = 0.5 * theta
    small = theta_sq < 1e-12
    k = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(half) / theta)
    return torch.cat([k * phi, torch.cos(half)], dim=-1)


def logmap(q: torch.Tensor) -> torch.Tensor:
    """S3 -> so(3) log map (shortest rotation), series-safe near identity."""
    w0 = q[..., 3:4]
    q = q * torch.sign(torch.where(w0 == 0.0, torch.ones_like(w0), w0))
    vec = q[..., :3]
    w = q[..., 3:4]
    n_sq = torch.sum(vec * vec, dim=-1, keepdim=True)
    n = torch.sqrt(n_sq + 1e-24)
    theta = 2.0 * torch.atan2(n, w)
    small = n_sq < 1e-12
    w_safe = torch.clamp(w, min=1e-6)
    k = torch.where(small,
                    2.0 / w_safe * (1.0 - n_sq / (3.0 * w_safe * w_safe)),
                    theta / n)
    return k * vec


def integrate_expmap(q: torch.Tensor, omega_body: torch.Tensor,
                     dt) -> torch.Tensor:
    """q⁺ = exp(ω dt) ⊗ q, norm-preserving by construction; ``dt`` a
    number, a 0-dim tensor or one with omega's batch axes."""
    dt = scalar_like(omega_body, dt)
    if dt.dim() < omega_body.dim():
        dt = dt[..., None]
    return multiply(expmap(omega_body * dt), q)


def to_euler(q: torch.Tensor) -> torch.Tensor:
    """ZYX Euler angles [phi, theta, psi] of an xyzw quaternion."""
    x, y, z, w = q.unbind(-1)
    phi = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    theta = torch.asin(clip(2 * (w * y - z * x), -1.0, 1.0))
    psi = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return torch.stack([phi, theta, psi], dim=-1)


def from_euler(phi, theta, psi) -> torch.Tensor:
    """xyzw quaternion from ZYX Euler angles (roll, pitch, yaw)."""
    hphi, hth, hpsi = 0.5 * phi, 0.5 * theta, 0.5 * psi
    cphi, sphi = torch.cos(hphi), torch.sin(hphi)
    cth, sth = torch.cos(hth), torch.sin(hth)
    cpsi, spsi = torch.cos(hpsi), torch.sin(hpsi)
    return torch.stack([
        sphi * cth * cpsi - cphi * sth * spsi,
        cphi * sth * cpsi + sphi * cth * spsi,
        cphi * cth * spsi - sphi * sth * cpsi,
        cphi * cth * cpsi + sphi * sth * spsi,
    ], dim=-1)


def slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical linear interpolation between unit quaternions, a lerp
    where they are nearly parallel."""
    t = scalar_like(q0, t)
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.abs(dot)
    theta = torch.acos(clip(dot, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    near = sin_theta < 1e-5
    denom = torch.where(near, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta) / denom)
    w1 = torch.where(near, t, torch.sin(t * theta) / denom)
    return normalize(w0 * q0 + w1 * q1)
