"""Quaternion algebra in xyzw (scalar-last) storage, Hamilton product.

Every function works on the last axis and broadcasts over leading batch
axes.  ``rotate(q, v)`` maps body-frame (FRD) vectors into NED for
q = q_frd_ned; ``rotate_inv`` is the inverse sandwich.
"""

from __future__ import annotations

import torch


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


def derivative(q: torch.Tensor, omega_body: torch.Tensor) -> torch.Tensor:
    """q̇ = ½ q ⊗ (ω, 0) with ω in the body frame."""
    omega_q = torch.cat([omega_body, torch.zeros_like(omega_body[..., :1])],
                        dim=-1)
    return 0.5 * multiply(q, omega_q)


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
