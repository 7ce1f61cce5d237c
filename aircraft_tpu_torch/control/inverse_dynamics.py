"""Inverse-dynamics OCP: body forces and moments as decision variables.

The integrator consumes decision-variable body-frame forces and moments
while equality rows tie them to the aero model, which takes the stiff
aerodynamics out of the integration:

    control  v = [u(7), F_frd(3), M_frd(3)]      (13 inputs)
    dynamics x⁺ = rigid_body(x, F_v, M_v)        (no aero in the rollout)
    eq       F_v − F_aero(x, u) = 0,  M_v − M_aero(x, u) = 0
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from aircraft_tpu_torch.config import SolverConfig, TrajectoryConfig
from aircraft_tpu_torch.control.aircraft import (REFERENCE_ENVELOPE,
                                                 envelope_ineq)
from aircraft_tpu_torch.device import resolve_device
from aircraft_tpu_torch.dynamics import aircraft as ac
from aircraft_tpu_torch.dynamics import base
from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
from aircraft_tpu_torch.solvers import ilqr, integrators
from aircraft_tpu_torch.solvers.ocp import OCPFunctions

FORCE = slice(7, 10)
MOMENT = slice(10, 13)


def build_inverse_dynamics_ocp(params: AircraftParams,
                               config: TrajectoryConfig, *, dt: float,
                               stage_cost: Callable, terminal_cost: Callable,
                               substeps: int = 1, force_scale: float = 100.0,
                               moment_scale: float = 10.0) -> OCPFunctions:
    """``stage_cost(x, u7, k)`` and ``terminal_cost(x)`` see the plain
    aircraft state and control; the force and moment matching rows are
    added here."""
    inertia = base.inertia_about_com(params.static_inertia, params.mass,
                                     params.com)

    def rigid_step_derivative(x, v):
        return base.rigid_body_derivative(
            x, v[..., FORCE] * force_scale, v[..., MOMENT] * moment_scale,
            params.mass, inertia, params.gravity)

    def step(x, v, k):
        return integrators.step(params, x, v, dt, substeps=substeps,
                                normalize="step",
                                derivative_fn=rigid_step_derivative)

    env = envelope_ineq(params, config.state, config.control,
                        **REFERENCE_ENVELOPE)

    def eq(x, v, k):
        f_model, m_model = ac.forces_moments(params, x, v[..., :7])
        return torch.cat(
            [(v[..., FORCE] * force_scale - f_model) / force_scale,
             (v[..., MOMENT] * moment_scale - m_model) / moment_scale],
            dim=-1)

    return OCPFunctions(
        step=step, stage_cost=lambda x, v, k: stage_cost(x, v[..., :7], k),
        terminal_cost=terminal_cost, ineq=lambda x, v, k: env(x, v[..., :7], k),
        eq=eq)


def solve_inverse_dynamics(params: AircraftParams, config: TrajectoryConfig,
                           goal, *, num_nodes: int = 50, dt: float = 0.05,
                           substeps: int = 5,
                           solver_config: Optional[SolverConfig] = None,
                           cuda_chol: bool = False,
                           device="cuda") -> ilqr.ILQRSolution:
    """Point-to-point solve in the inverse-dynamics formulation, from the
    configured initial state, force and moment channels seeded with the
    model's values there.  ``cuda_chol`` as ``ilqr.solve``."""
    dev = resolve_device(device)
    if params.device != dev:
        params = params.to(dev)
    goal = torch.as_tensor(goal, dtype=torch.float32, device=dev)

    def stage_cost(x, u, k):
        return 1e-3 * torch.sum(u[..., :3] ** 2, dim=-1)

    def terminal_cost(x):
        return 1e-2 * torch.sum((x[..., :3] - goal) ** 2, dim=-1)

    ocp = build_inverse_dynamics_ocp(params, config, dt=dt, substeps=substeps,
                                     stage_cost=stage_cost,
                                     terminal_cost=terminal_cost)
    x0 = torch.tensor(config.waypoints.initial_state, dtype=torch.float32,
                      device=dev)
    f0, m0 = ac.forces_moments(params, x0, torch.zeros(7, device=dev))
    v0 = torch.cat([torch.zeros(7, device=dev), f0 / 100.0, m0 / 10.0])
    v0 = v0.expand(num_nodes, 13).contiguous()
    cfg = solver_config or SolverConfig(max_al_iters=6, max_inner_iters=20)
    return ilqr.solve(ocp, x0, v0, cfg, cuda_chol=cuda_chol)
