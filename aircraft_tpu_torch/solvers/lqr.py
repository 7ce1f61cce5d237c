"""Infinite-horizon LQR about a trim point, on the error-state manifold.

A raw 13-state design cannot work for a quaternion plant: the unit-norm
direction is an uncontrollable neutral mode the Riccati equation cannot
stabilise.  The design works in the 12-dimensional tangent space instead,

    xi = [dp, dv, dtheta, domega],   q = exp(dtheta) ⊗ q_ref,

linearises the error-step map by forward-mode AD (A: 12x12, B: 12xn_u),
and solves the discrete Riccati equation by a fixed-trip-count
structure-preserving doubling iteration: small dense matrix products,
batched over leading axes, no data-dependent control flow.  A scipy CARE
path is kept for the continuous-time design.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from aircraft_tpu_torch.device import resolve_device
from aircraft_tpu_torch.dynamics import base
from aircraft_tpu_torch.ops import quaternion as quat
from aircraft_tpu_torch.ops.autodiff import batched_jacfwd
from aircraft_tpu_torch.solvers import integrators

TANGENT_DIM = 12


def inject(x_ref: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """x = x_ref ⊕ xi: a tangent-space error applied to a reference state;
    the attitude perturbs multiplicatively, q = exp(dtheta) ⊗ q_ref, so
    the result holds a unit quaternion."""
    p = x_ref[..., base.POS] + xi[..., 0:3]
    v = x_ref[..., base.VEL] + xi[..., 3:6]
    q = quat.multiply(quat.expmap(xi[..., 6:9]), x_ref[..., base.QUAT])
    om = x_ref[..., base.OMEGA] + xi[..., 9:12]
    p, v, q, om = (torch.broadcast_to(t, xi.shape[:-1] + t.shape[-1:])
                   for t in (p, v, q, om))
    return base.pack_state(p, v, q, om)


def retract(x: torch.Tensor, x_ref: torch.Tensor) -> torch.Tensor:
    """xi = x ⊖ x_ref: the tangent-space error between two states."""
    dq = quat.multiply(x[..., base.QUAT], quat.inverse(x_ref[..., base.QUAT]))
    return torch.cat([x[..., base.POS] - x_ref[..., base.POS],
                      x[..., base.VEL] - x_ref[..., base.VEL],
                      quat.logmap(dq),
                      x[..., base.OMEGA] - x_ref[..., base.OMEGA]], dim=-1)


def error_jacobians(params, x_ref: torch.Tensor, u_ref: torch.Tensor, dt,
                    substeps: int = 1):
    """A (..., 12, 12), B (..., 12, n_u) of the discrete error-step map
    xi⁺ = F(x_ref ⊕ xi, u_ref + du) ⊖ F(x_ref, u_ref) at xi = du = 0,
    over the leading axes of x_ref and u_ref."""
    lead = torch.broadcast_shapes(x_ref.shape[:-1], u_ref.shape[:-1])
    xr = x_ref.expand(lead + x_ref.shape[-1:]).reshape(
        -1, x_ref.shape[-1]).clone()
    ur = u_ref.expand(lead + u_ref.shape[-1:]).reshape(
        -1, u_ref.shape[-1]).clone()

    def step(x, u):
        return integrators.step(params, x, u, dt, substeps=substeps,
                                normalize="step")

    x_next_ref = step(xr, ur)

    def err_step(xi, du):
        return retract(step(inject(xr, xi), ur + du), x_next_ref)

    J = batched_jacfwd(err_step, xr.new_zeros(xr.shape[0], TANGENT_DIM),
                       torch.zeros_like(ur))
    J = J.reshape(lead + J.shape[1:])
    return J[..., :TANGENT_DIM], J[..., TANGENT_DIM:]


def _t(M):
    return M.transpose(-1, -2)


def solve_dare(A: torch.Tensor, B: torch.Tensor, Q: torch.Tensor,
               R: torch.Tensor, iters: int = 60) -> torch.Tensor:
    """The discrete algebraic Riccati equation by the structure-preserving
    doubling algorithm: with A0 = A, G0 = B R⁻¹ Bᵀ, H0 = Q,
        A_{k+1} = A_k (I + G_k H_k)⁻¹ A_k
        G_{k+1} = G_k + A_k (I + G_k H_k)⁻¹ G_k A_kᵀ
        H_{k+1} = H_k + A_kᵀ H_k (I + G_k H_k)⁻¹ A_k
    H_k → P quadratically; ~20 doublings reach float precision and 60 is
    margin.  Batches over leading axes."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    Ak, Gk, Hk = A, B @ torch.linalg.solve(R, _t(B)), Q
    for _ in range(iters):
        W = eye + Gk @ Hk
        WinvA = torch.linalg.solve(W, Ak)
        WinvG = torch.linalg.solve(W, Gk)
        Ak, Gk, Hk = (Ak @ WinvA, Gk + Ak @ WinvG @ _t(Ak),
                      Hk + _t(Ak) @ Hk @ WinvA)
    return 0.5 * (Hk + _t(Hk))


def dare_gain(A, B, Q, R, iters: int = 60):
    """(K, P): u = -K xi minimises the infinite-horizon discrete cost."""
    P = solve_dare(A, B, Q, R, iters)
    K = torch.linalg.solve(R + _t(B) @ P @ B, _t(B) @ P @ A)
    return K, P


def continuous_lqr(A: np.ndarray, B: np.ndarray, Q: np.ndarray,
                   R: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Continuous-time LQR on the host through scipy's CARE solver."""
    from scipy.linalg import solve_continuous_are

    P = solve_continuous_are(A, B, Q, R)
    return np.linalg.solve(R, B.T @ P), P


class LQRController(NamedTuple):
    x_ref: torch.Tensor
    u_ref: torch.Tensor
    K: torch.Tensor      # (n_u, 12)
    P: torch.Tensor      # (12, 12) value matrix
    A: torch.Tensor
    B: torch.Tensor


def design(params, x_ref, u_ref, dt: float, Q=None, R=None,
           substeps: int = 1, device="cuda") -> LQRController:
    """An error-state LQR about (x_ref, u_ref).  The default weights hold
    velocity, attitude and rates and leave position free (an unpowered
    glider cannot hold station; it can hold attitude)."""
    dev = resolve_device(device)
    if params.device != dev:
        params = params.to(dev)
    x_ref = torch.as_tensor(x_ref, dtype=torch.float32, device=dev)
    u_ref = torch.as_tensor(u_ref, dtype=torch.float32, device=dev)
    if Q is None:
        Q = torch.diag(torch.tensor([0.0, 0.0, 0.0, 1.0, 1.0, 1.0,
                                     50.0, 50.0, 50.0, 5.0, 5.0, 5.0],
                                    device=dev))
    if R is None:
        R = torch.eye(u_ref.shape[-1], device=dev)
    Q = torch.as_tensor(Q, dtype=torch.float32, device=dev)
    R = torch.as_tensor(R, dtype=torch.float32, device=dev)
    A, B = error_jacobians(params, x_ref, u_ref, dt, substeps=substeps)
    K, P = dare_gain(A, B, Q, R)
    return LQRController(x_ref=x_ref, u_ref=u_ref, K=K, P=P, A=A, B=B)


def control(ctrl: LQRController, x: torch.Tensor) -> torch.Tensor:
    """u = u_ref - K (x ⊖ x_ref), over the leading axes of x."""
    return ctrl.u_ref - retract(x, ctrl.x_ref) @ _t(ctrl.K)


def closed_loop_step(params, ctrl: LQRController, dt: float,
                     substeps: int = 1) -> Callable:
    """One closed-loop step x -> (F(x, lqr(x)), the same), the carry and
    the output of a scan over steps.  It regulates to the fixed point
    (x_ref, u_ref); to track a trim trajectory, advance x_ref with it."""

    def step(x, _=None):
        x_next = integrators.step(params, x, control(ctrl, x), dt,
                                  substeps=substeps, normalize="step")
        return x_next, x_next

    return step
