"""The glider's optimal-control problem: flight-envelope inequality rows
g(x, u, k) <= 0, the point-to-point losses, and the whole-trajectory OCP
(``build_aircraft_ocp``) with the reference's quaternion options."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from aircraft_tpu_torch.config import (RHO, ControlEnvelope, StateEnvelope,
                                       TrajectoryConfig)
from aircraft_tpu_torch.device import resolve_device
from aircraft_tpu_torch.dynamics import aircraft as ac
from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
from aircraft_tpu_torch.solvers import integrators
from aircraft_tpu_torch.solvers.ocp import OCPFunctions

REFERENCE_ENVELOPE = {
    # the reference OCP's hard-coded envelope (airspeed in [20, 100] m/s,
    # |alpha| <= 20 deg, |beta| <= 10 deg); controllers that mirror it pass
    # these overrides, otherwise the declared state envelope applies
    "speed_bounds": (20.0, 100.0),
    "alpha_limit_deg": 20.0,
    "beta_limit_deg": 10.0,
}


def envelope_ineq(params: AircraftParams, state_env: StateEnvelope,
                  control_env: ControlEnvelope, *,
                  speed_bounds: Optional[tuple[float, float]] = None,
                  alpha_limit_deg: Optional[float] = None,
                  beta_limit_deg: Optional[float] = None,
                  unit_scales: bool = False,
                  include_control_box: bool = True) -> Callable:
    """Stage inequality rows, in order: [u - ub (7), lb - u (7)] when
    ``include_control_box``, then airspeed² floor and ceiling, ±beta,
    ±alpha, and z (NED altitude floor).  ``unit_scales`` divides the
    squared-speed rows by their boundary gradient 2·v so every row reads
    in physical units.  The resolved row constants are attached as
    ``.resolved`` for the window kernels."""
    lb_np, ub_np = control_env.bounds(7)
    dev = params.device
    lb = torch.as_tensor(lb_np, dtype=torch.float32, device=dev)
    ub = torch.as_tensor(ub_np, dtype=torch.float32, device=dev)
    if speed_bounds is None:
        speed_bounds = (float(state_env.airspeed[0]),
                        float(state_env.airspeed[1]))
    if alpha_limit_deg is None:
        alpha_limit_deg = float(max(abs(state_env.alpha[0]),
                                    abs(state_env.alpha[1])))
    if beta_limit_deg is None:
        beta_limit_deg = float(max(abs(state_env.beta[0]),
                                   abs(state_env.beta[1])))
    alpha_lim = float(np.deg2rad(alpha_limit_deg))
    beta_lim = float(np.deg2rad(beta_limit_deg))
    lo2, hi2 = speed_bounds[0] ** 2, speed_bounds[1] ** 2
    lo_scale = 1.0 / (2.0 * speed_bounds[0]) if unit_scales else 1.0
    hi_scale = 1.0 / (2.0 * speed_bounds[1]) if unit_scales else 1.0

    def ineq(x, u, k):
        aero = ac.aero_state(params, x, u)
        v2 = 2.0 * aero.qbar / RHO
        rows = [(lo2 - v2) * lo_scale, (v2 - hi2) * hi_scale,
                aero.beta - beta_lim, -beta_lim - aero.beta,
                aero.alpha - alpha_lim, -alpha_lim - aero.alpha, x[..., 2]]
        env = torch.stack(rows, dim=-1)
        if not include_control_box:
            return env
        return torch.cat([u - ub, lb - u, env], dim=-1)

    ineq.resolved = {
        "speed_bounds": (float(speed_bounds[0]), float(speed_bounds[1])),
        "alpha_lim": alpha_lim,
        "beta_lim": beta_lim,
        "lo_scale": float(lo_scale),
        "hi_scale": float(hi_scale),
        "include_control_box": include_control_box,
        "lb": np.asarray(lb_np, np.float32),
        "ub": np.asarray(ub_np, np.float32),
    }
    return ineq


def envelope_registry(n_controls: int = 7, *,
                      include_control_box: bool = True):
    """``ConstraintRegistry`` of ``envelope_ineq``'s row layout, mapping a
    violation row back to its meaning.  ``include_control_box`` must
    mirror the ``envelope_ineq`` that built the OCP: without the 14 box
    rows (the tanh squash) a registry that still listed them would
    mislabel every envelope row."""
    from aircraft_tpu_torch.observability import ConstraintRegistry

    names = ["aileron", "elevator", "rudder", "thrust_x", "thrust_y",
             "thrust_z", "flaps"][:n_controls]
    reg = ConstraintRegistry()
    if include_control_box:
        for n in names:
            reg.register(f"{n}_upper", 1)
        for n in names:
            reg.register(f"{n}_lower", 1)
    reg.register("airspeed_floor", 1)    # lo² − v²  [m²/s²]
    reg.register("airspeed_ceiling", 1)  # v² − hi²  [m²/s²]
    reg.register("beta_upper", 1)        # [rad]
    reg.register("beta_lower", 1)
    reg.register("alpha_upper", 1)
    reg.register("alpha_lower", 1)
    reg.register("altitude_floor", 1)    # z < 0 (NED)
    return reg


def goal_cost(goal, *, w_goal: float = 1.0, w_control: float = 0.01,
              w_rate: float = 0.0, device="cuda") -> tuple[Callable, Callable]:
    """Point-to-point losses in the style of the flagship controller:
    (stage, terminal), the control effort on the surfaces and the
    terminal goal distance, batch-leading.  ``goal`` (3,) is placed on
    ``device``; ``w_rate`` is accepted and unused, as in the reference."""
    goal = torch.as_tensor(goal, dtype=torch.float32,
                           device=resolve_device(device))

    def stage(x, u, k):
        return w_control * torch.sum((u[..., :3] / 10.0) ** 2, dim=-1)

    def terminal(x):
        return w_goal * torch.sum((x[..., :3] - goal) ** 2, dim=-1)

    return stage, terminal


QUATERNION_NORMALIZE = {
    "integration": "step",
    "expmap": "expmap",
    "constraint": "none",
    "baumgarte": "none",
    "": "none",
}


def build_aircraft_ocp(params: AircraftParams, config: TrajectoryConfig, *,
                       dt: float, stage_cost: Callable,
                       terminal_cost: Callable, substeps: int = 1,
                       quaternion: str = "integration",
                       integration: str = "explicit", wind=None,
                       extra_ineq: Optional[Callable] = None,
                       terminal_ineq: Optional[Callable] = None,
                       terminal_eq: Optional[Callable] = None
                       ) -> OCPFunctions:
    """The glider OCP: steps of ``dt`` (``substeps`` each; RK4, or
    implicit Euler with ``integration='implicit'``) under the reference
    envelope, with the caller's costs.

    ``quaternion`` follows the reference's option axis:
      'integration'  renormalise inside the integrator (the default)
      'expmap'       the exact exponential-map quaternion update
      'constraint'   leave the norm to the equality |q|² − 1 = 0
      'baumgarte'    the Baumgarte-stabilised norm equality
                     2αφ̇ + β²φ = 0, φ = |q|² − 1, α = β = 2
      ''             nothing (drift allowed)
    ``wind`` (3,) enters the plant's derivative; ``extra_ineq`` rows
    follow the envelope's."""
    if quaternion not in QUATERNION_NORMALIZE:
        raise ValueError(f"quaternion={quaternion!r}: expected one of "
                         f"{sorted(QUATERNION_NORMALIZE)}")
    deriv = ((lambda x, u: ac.state_derivative(params, x, u, wind))
             if wind is not None else None)
    step = integrators.make_step_fn(
        params, substeps=substeps, normalize=QUATERNION_NORMALIZE[quaternion],
        derivative_fn=deriv, integration=integration)
    env_ineq = envelope_ineq(params, config.state, config.control,
                             **REFERENCE_ENVELOPE)

    def ineq(x, u, k):
        g = env_ineq(x, u, k)
        if extra_ineq is not None:
            g = torch.cat([g, extra_ineq(x, u, k)], dim=-1)
        return g

    if quaternion == "constraint":
        def eq(x, u, k):
            return torch.sum(x[..., 6:10] ** 2, dim=-1, keepdim=True) - 1.0
    elif quaternion == "baumgarte":
        alpha_b, beta_b = 2.0, 2.0

        def eq(x, u, k):
            xdot = ac.state_derivative(params, x, u, wind)
            phi = torch.sum(x[..., 6:10] ** 2, dim=-1, keepdim=True) - 1.0
            phi_dot = 2.0 * torch.sum(x[..., 6:10] * xdot[..., 6:10], dim=-1,
                                      keepdim=True)
            return 2.0 * alpha_b * phi_dot + beta_b ** 2 * phi
    else:
        eq = OCPFunctions.eq

    kwargs = {}
    if terminal_ineq is not None:
        kwargs["terminal_ineq"] = terminal_ineq
    if terminal_eq is not None:
        kwargs["terminal_eq"] = terminal_eq
    return OCPFunctions(step=lambda x, u, k: step(x, u, dt),
                        stage_cost=stage_cost, terminal_cost=terminal_cost,
                        ineq=ineq, eq=eq, **kwargs)
