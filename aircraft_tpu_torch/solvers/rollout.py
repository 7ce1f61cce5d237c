"""Trajectory rollouts and linearisation along a trajectory.

Every function takes leading batch axes: x0 (..., n), us (..., N, m), and
returns the batch axes first.  ``step_fn(x, u, dt) -> x_next`` is
``integrators.make_step_fn``'s form; ``dt`` is a scalar or per-knot (N,).
``batch_rollout`` is the plain version the rollout kernel
(``kernels/rollout.py``) is held against.
"""

from __future__ import annotations

from typing import Callable

import torch

from aircraft_tpu_torch.ops.autodiff import batched_jacfwd


def _dts(dt, N, like):
    return torch.broadcast_to(torch.as_tensor(dt, dtype=like.dtype,
                                              device=like.device), (N,))


def rollout(step_fn: Callable, x0: torch.Tensor, us: torch.Tensor,
            dt) -> torch.Tensor:
    """Open-loop rollout x_{k+1} = step(x_k, u_k, dt_k): (..., N+1, n),
    x0 included."""
    N = us.shape[-2]
    dts = _dts(dt, N, x0)
    xs = [x0]
    for k in range(N):
        xs.append(step_fn(xs[-1], us[..., k, :], dts[k]))
    return torch.stack(xs, dim=-2)


def closed_loop_rollout(step_fn: Callable, x0: torch.Tensor,
                        us_ref: torch.Tensor, xs_ref: torch.Tensor, gains,
                        dt, alpha: float = 1.0):
    """Feedback rollout u_k = u_ref_k + α k_k + K_k (x_k − x_ref_k) with
    gains (K (..., N, m, n), k (..., N, m)); returns (xs, us)."""
    N = us_ref.shape[-2]
    dts = _dts(dt, N, x0)
    K, kff = gains
    xs, us = [x0], []
    for k in range(N):
        x = xs[-1]
        u = (us_ref[..., k, :] + alpha * kff[..., k, :]
             + (K[..., k, :, :] @ (x - xs_ref[..., k, :])[..., None])[..., 0])
        xs.append(step_fn(x, u, dts[k]))
        us.append(u)
    return torch.stack(xs, dim=-2), torch.stack(us, dim=-2)


def linearize_along(step_fn: Callable, xs: torch.Tensor, us: torch.Tensor,
                    dt):
    """Per-knot Jacobians A_k = ∂step/∂x (..., N, n, n) and
    B_k = ∂step/∂u (..., N, n, m), all knots in one forward-mode pass."""
    n, m = xs.shape[-1], us.shape[-1]
    N = us.shape[-2]
    lead = us.shape[:-2]
    X = xs[..., :-1, :].reshape(-1, n)
    U = us.reshape(-1, m)
    dts = _dts(dt, N, xs).expand(lead + (N,)).reshape(-1)
    J = batched_jacfwd(lambda x, u: step_fn(x, u, dts), X, U)
    J = J.reshape(lead + (N, n, n + m))
    return J[..., :n], J[..., n:]


def batch_rollout(step_fn: Callable, x0s: torch.Tensor, uss: torch.Tensor,
                  dt) -> torch.Tensor:
    """Rollout of a scenario batch: (B, n), (B, N, m) -> (B, N+1, n)."""
    return rollout(step_fn, x0s, uss, dt)
