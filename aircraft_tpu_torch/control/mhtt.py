"""Moving-horizon trajectory tracking (MHTT): the window OCP.

Track progress s in [0, 1] is an augmented state with dynamics
ṡ = v·t̂(s)/L (+ a position-error correction), so one window is one smooth
iLQR problem over z = [x(13), s] (+ wind(3) when ``wind_channels``).
The receding-horizon ``MHTT`` class is not ported yet; the bench chains
the windows itself.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from aircraft_tpu_torch.config import TrajectoryConfig
from aircraft_tpu_torch.control.aircraft import envelope_ineq
from aircraft_tpu_torch.control.initialisation import (
    catmull_rom_eval,
    catmull_rom_tangent,
)
from aircraft_tpu_torch.dynamics import aircraft as ac
from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
from aircraft_tpu_torch.ops.elementwise import clip
from aircraft_tpu_torch.solvers import integrators
from aircraft_tpu_torch.solvers.ocp import OCPFunctions, squash_controls

# loss weights
W_TRACKING = 10.0
W_PROGRESS = 5.0
W_PROGRESS_RATE = 2.0
W_BACKWARD = 50.0
W_TERMINAL_ALIGN = 20.0
W_LOW_VELOCITY = 10.0
W_CONTROL = 100.0 / 100.0


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def build_mhtt_ocp(params: AircraftParams, config: TrajectoryConfig,
                   track_points: torch.Tensor, track_length: float, *,
                   dt: float, substeps: int = 1,
                   progress_correction: float = 0.05,
                   wind_channels: bool = False,
                   track_dims: tuple = (0, 1, 2), v_ref: float = 0.0,
                   w_speed: float = 0.0, w_rate: float = 0.0,
                   alpha_guard_deg: float = 0.0, beta_guard_deg: float = 0.0,
                   envelope_overrides: Optional[dict] = None,
                   stall_guard: tuple = (2.0, 10.0), squash_box: bool = False,
                   tail_damp: Optional[tuple] = None,
                   spec_out: Optional[dict] = None) -> OCPFunctions:
    """The window OCP over z = [x(13), s].  ``track_dims`` restricts the
    tracking error and the progress tangent to the declared objective
    dimensions; ``w_speed`` adds a speed hold at ``v_ref`` plus a stall
    guard; ``w_rate`` damps body rates; the alpha/beta guards add soft
    margins inside the hard envelope rows; ``squash_box`` enforces the
    control box through the tanh reparameterisation; ``tail_damp`` =
    (knot, factor) damps the progress reward past a knot.  ``spec_out``
    receives the resolved formulation constants the window kernels read."""
    dev = params.device
    track_points = torch.as_tensor(track_points, dtype=torch.float32,
                                   device=dev)
    dim_mask = torch.zeros(3, dtype=torch.float32, device=dev)
    dim_mask[list(track_dims)] = 1.0
    step13 = integrators.make_step_fn(params, substeps=substeps,
                                      normalize="step")
    L = float(track_length)
    env_overrides = dict(envelope_overrides or {})
    if squash_box:
        env_overrides["include_control_box"] = False
    env = envelope_ineq(params, config.state, config.control, **env_overrides)

    def progress_rate(z):
        x, s = z[..., :13], z[..., 13]
        tangent = catmull_rom_tangent(track_points, s) / L * dim_mask
        tnorm = _norm(tangent)
        tdir = tangent / torch.where(tnorm > 1e-3, tnorm,
                                     torch.ones_like(tnorm))[..., None]
        s_dot = torch.sum(x[..., 3:6] * tdir, dim=-1) / L
        pos_err = (x[..., 0:3] - catmull_rom_eval(track_points, s)) * dim_mask
        corr = torch.sum(pos_err * tdir, dim=-1) / L
        return s_dot, corr, pos_err

    def step(z, u, k):
        x, s = z[..., :13], z[..., 13]
        s_dot, corr, _ = progress_rate(z)
        # the upper clip sits above 1 so the terminal progress reward keeps
        # a live gradient through s = 1
        s_next = clip(s + s_dot * dt + progress_correction * corr, 0.0, 1.05)
        if wind_channels:
            w = z[..., 14:17]
            x_next = integrators.step(
                params, x, u, dt, substeps=substeps, normalize="step",
                derivative_fn=lambda xx, uu: ac.state_derivative(
                    params, xx, uu, wind=w))
            return torch.cat([x_next, s_next[..., None], w], dim=-1)
        return torch.cat([step13(x, u, dt), s_next[..., None]], dim=-1)

    def stage_residuals(z, u, k):
        """Least-squares part of the stage cost: r with cost 0.5·‖r‖²."""
        x = z[..., :13]
        s_dot, _, pos_err = progress_rate(z)
        speed = _norm(x[..., 3:6])
        zero = torch.zeros_like(speed)
        parts = [
            np.sqrt(2.0 * W_TRACKING) * pos_err,
            (np.sqrt(2.0 * W_BACKWARD) * torch.maximum(zero, -s_dot))[..., None],
            (np.sqrt(2.0 * W_LOW_VELOCITY)
             * torch.maximum(0.1 - speed, zero))[..., None],
            np.sqrt(2.0 * W_CONTROL) * u,
            (np.sqrt(2.0) * torch.maximum(speed - 110.0, zero))[..., None],
        ]
        if w_speed > 0.0:
            parts.append((np.sqrt(2.0 * w_speed) * (speed - v_ref))[..., None])
            parts.append((np.sqrt(2.0 * stall_guard[1] * w_speed)
                          * torch.maximum((v_ref - stall_guard[0]) - speed,
                                          zero))[..., None])
        if w_rate > 0.0:
            parts.append(np.sqrt(2.0 * w_rate) * x[..., 10:13])
        if alpha_guard_deg > 0.0 or beta_guard_deg > 0.0:
            aero = ac.aero_state(params, x, u)
            if alpha_guard_deg > 0.0:
                a_lim = float(np.deg2rad(alpha_guard_deg))
                parts.append((np.sqrt(20.0) * torch.maximum(
                    torch.abs(aero.alpha) - a_lim, zero))[..., None])
            if beta_guard_deg > 0.0:
                b_lim = float(np.deg2rad(beta_guard_deg))
                parts.append((np.sqrt(20.0) * torch.maximum(
                    torch.abs(aero.beta) - b_lim, zero))[..., None])
        return torch.cat(parts, dim=-1)

    def stage_rest(z, u, k):
        """Progress rewards: exact gradient in the Gauss-Newton expansion,
        curvature dropped."""
        s = z[..., 13]
        s_dot, _, _ = progress_rate(z)
        rate_reward = 0.5 * torch.tanh(s_dot / 0.5)
        rest = -W_PROGRESS * s - W_PROGRESS_RATE * rate_reward
        if tail_damp is not None:
            kt = torch.as_tensor(k, device=s.device)
            rest = rest * torch.where(kt >= tail_damp[0],
                                      torch.as_tensor(float(tail_damp[1]),
                                                      device=s.device),
                                      torch.as_tensor(1.0, device=s.device))
        return rest

    def stage_cost(z, u, k):
        r = stage_residuals(z, u, k)
        return 0.5 * torch.sum(r * r, dim=-1) + stage_rest(z, u, k)

    def terminal_cost(z):
        # align to the track point at the terminal progress achieved
        x, s = z[..., :13], z[..., 13]
        goal = catmull_rom_eval(track_points, s)
        align = _norm((x[..., :3] - goal) * dim_mask + 1e-9)
        return W_TERMINAL_ALIGN * align - W_PROGRESS * 10.0 * s

    def ineq(z, u, k):
        return env(z[..., :13], u, k)

    built = OCPFunctions(step=step, stage_cost=stage_cost,
                         terminal_cost=terminal_cost, ineq=ineq,
                         stage_residuals=stage_residuals,
                         stage_rest=stage_rest)
    if squash_box:
        lb, ub = config.control.bounds(7)
        built, _, _ = squash_controls(built, lb, ub, device=dev)
    if spec_out is not None:
        spec_out.update(
            params=params, track_points=track_points, track_length=L, dt=dt,
            substeps=substeps, progress_correction=progress_correction,
            track_dims=tuple(track_dims), v_ref=v_ref, w_speed=w_speed,
            w_rate=w_rate, alpha_guard_deg=alpha_guard_deg,
            beta_guard_deg=beta_guard_deg, stall_guard=tuple(stall_guard),
            tail_damp=tail_damp, wind_channels=wind_channels,
            envelope=env.resolved, squash_box=squash_box,
            squash_bounds=(config.control.bounds(7) if squash_box else None))
    return built
