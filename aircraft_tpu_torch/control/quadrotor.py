"""Quadrotor point-to-point optimal control.

The quadrotor OCP: goal-distance loss, thrusts bounded to
[0, thrust_max], a terminal pull onto the target.  Three constructors:

  * ``build_quadrotor_ocp(target, ...)``: the target fixed in the
    closure;
  * ``build_quadrotor_ocp_dynamic(...)``: the target rides the augmented
    state's tail (constant under the dynamics), so one solve serves any
    batch of goals;
  * ``build_quadrotor_ocp_variable_time(target, ...)``: a free time step
    per knot, dt_k = ν² with ν a fifth control.

``solve_quadrotor_control`` solves one goal; ``solve_quadrotor_time_optimal``
solves a ladder of fixed uniform time steps, takes the fastest feasible
one and refines it with the per-knot free-time formulation.  Every solve
goes through ``ilqr.solve``; ``cuda_chol`` sends its Quu solves to the
batched-Cholesky kernel (one m = 4 or m = 5 system per knot).
"""

from __future__ import annotations

from typing import Optional

import torch

from aircraft_tpu_torch.config import SolverConfig
from aircraft_tpu_torch.device import resolve_device
from aircraft_tpu_torch.dynamics.quadrotor import QuadrotorParams
from aircraft_tpu_torch.solvers import ilqr, integrators
from aircraft_tpu_torch.solvers import ocp as ocp_mod
from aircraft_tpu_torch.solvers.ocp import OCPFunctions

# 1000·goal distance + 0.1·effort; the terminal split below keeps the same
# stationary point with a per-stage goal pull that conditions the solve
W_EFFORT = 0.1
W_STAGE_GOAL = 1e-4
W_TERMINAL_GOAL = 100.0
W_TERMINAL_VEL = 10.0
HOVER = 9.81 / 4.0


def _sq(t):
    return torch.sum(t * t, dim=-1)


def _losses(dt: float):
    def stage_cost(x, tgt, u):
        return W_EFFORT * dt * _sq(u) + W_STAGE_GOAL * _sq(x[..., :3] - tgt)

    def terminal_cost(x, tgt):
        return (W_TERMINAL_GOAL * _sq(x[..., :3] - tgt)
                + W_TERMINAL_VEL * _sq(x[..., 3:6]))

    return stage_cost, terminal_cost


def _params(params: Optional[QuadrotorParams], device) -> QuadrotorParams:
    dev = resolve_device(device)
    if params is None:
        return QuadrotorParams.default(dev)
    return params if params.device == dev else params.to(dev)


def _thrust_box(u, thrust_max):
    return torch.cat([u - thrust_max, -u], dim=-1)


def build_quadrotor_ocp(target, *, dt: float, thrust_max: float = 10.0,
                        params: Optional[QuadrotorParams] = None,
                        substeps: int = 1, device="cuda") -> OCPFunctions:
    """Point-to-point OCP over the plain 13-state with the target closed
    over; thrusts in [0, thrust_max]."""
    params = _params(params, device)
    step = integrators.make_step_fn(params, substeps=substeps,
                                    normalize="step")
    target = torch.as_tensor(target, dtype=torch.float32, device=params.device)
    stage_l, term_l = _losses(dt)
    return OCPFunctions(
        step=lambda x, u, k: step(x, u, dt),
        stage_cost=lambda x, u, k: stage_l(x, target, u),
        terminal_cost=lambda x: term_l(x, target),
        ineq=lambda x, u, k: _thrust_box(u, thrust_max))


def build_quadrotor_ocp_dynamic(*, dt: float, thrust_max: float = 10.0,
                                params: Optional[QuadrotorParams] = None,
                                substeps: int = 1,
                                device="cuda") -> OCPFunctions:
    """The OCP over z = [x(13), target(3)]: the target channels stay
    constant, so one solve handles a batch of goals."""
    params = _params(params, device)
    step13 = integrators.make_step_fn(params, substeps=substeps,
                                      normalize="step")
    stage_l, term_l = _losses(dt)

    def step(z, u, k):
        return torch.cat([step13(z[..., :13], u, dt), z[..., 13:]], dim=-1)

    return OCPFunctions(
        step=step,
        stage_cost=lambda z, u, k: stage_l(z[..., :13], z[..., 13:], u),
        terminal_cost=lambda z: term_l(z[..., :13], z[..., 13:]),
        ineq=lambda z, u, k: _thrust_box(u, thrust_max))


def initial_state_inverted(device="cuda") -> torch.Tensor:
    """The hover-capable start: the plant's thrust acts along body +z, so
    the vehicle starts rolled 180° (q = [1, 0, 0, 0], xyzw) for body +z to
    oppose NED gravity."""
    x0 = torch.zeros(13, device=resolve_device(device))
    x0[6] = 1.0
    return x0


def solve_quadrotor_control(target, *, num_nodes: int = 60, dt: float = 0.05,
                            thrust_max: float = 10.0, x0=None,
                            solver_config: Optional[SolverConfig] = None,
                            params: Optional[QuadrotorParams] = None,
                            cuda_chol: bool = False,
                            device="cuda") -> ilqr.ILQRSolution:
    """One point-to-point solve from hover thrusts (any N and target)."""
    dev = resolve_device(device)
    ocp = build_quadrotor_ocp(target, dt=dt, thrust_max=thrust_max,
                              params=params, device=dev)
    x0 = (initial_state_inverted(dev) if x0 is None
          else torch.as_tensor(x0, dtype=torch.float32, device=dev))
    us0 = torch.full((num_nodes, 4), HOVER, device=dev)
    cfg = solver_config or SolverConfig(max_al_iters=6, max_inner_iters=25)
    return ilqr.solve(ocp, x0, us0, cfg, cuda_chol=cuda_chol)


def build_quadrotor_ocp_variable_time(
        target, *, dt_bounds: tuple, thrust_max: float = 10.0,
        params: Optional[QuadrotorParams] = None, substeps: int = 1,
        w_time: float = 5.0, device="cuda") -> OCPFunctions:
    """Per-knot free time: control v = [thrusts(4), ν], dt_k = ν².  It
    minimises Σ dt_k with the point-to-point losses; ν is bounded into
    ``dt_bounds`` and takes feedforward only (state feedback on the time
    step would warp the whole schedule with every rollout deviation)."""
    params = _params(params, device)
    step13 = integrators.make_step_fn(params, substeps=substeps,
                                      normalize="step")
    target = torch.as_tensor(target, dtype=torch.float32, device=params.device)
    lo, hi = float(dt_bounds[0]) ** 0.5, float(dt_bounds[1]) ** 0.5

    def stage_cost(x, v, k):
        u, dt_k = v[..., :4], v[..., 4] * v[..., 4]
        return (W_EFFORT * dt_k * _sq(u)
                + W_STAGE_GOAL * _sq(x[..., :3] - target) + w_time * dt_k)

    def terminal_cost(x):
        return (W_TERMINAL_GOAL * _sq(x[..., :3] - target)
                + W_TERMINAL_VEL * _sq(x[..., 3:6]))

    def step(x, v, k):
        return step13(x, v[..., :4], v[..., 4] * v[..., 4])

    def ineq(x, v, k):
        nu = v[..., 4:5]
        return torch.cat([_thrust_box(v[..., :4], thrust_max), lo - nu,
                          nu - hi], dim=-1)

    return OCPFunctions(step=step, stage_cost=stage_cost,
                        terminal_cost=terminal_cost, ineq=ineq,
                        feedback_mask=(1, 1, 1, 1, 0))


def _summary(ocp, sol, target):
    """(miss, defect, finite) of an unbatched solution, read on the host."""
    miss = float(torch.linalg.norm(sol.xs[-1, :3] - target))
    defect = float(ocp_mod.rollout_defect(ocp, sol.xs[None], sol.us[None])[0])
    return miss, defect, bool(torch.all(torch.isfinite(sol.xs)))


def solve_quadrotor_time_optimal(
        target, *, num_nodes: int = 60, dt_nominal: float = 0.1,
        scales=(0.5, 0.6, 0.7, 0.8, 0.9, 1.0), goal_tol: float = 2.0,
        thrust_max: float = 10.0,
        solver_config: Optional[SolverConfig] = None, refine: bool = True,
        params: Optional[QuadrotorParams] = None, cuda_chol: bool = False,
        device="cuda") -> dict:
    """Free-time point-to-point: fixed-time solves at a ladder of uniform
    time steps (each scale its own solve), the fastest feasible schedule
    wins, then the per-knot free-time formulation refines around it; it
    also runs alone from the slack nominal (the largest scale).  On a goal
    reachable in about half the nominal time, the returned schedule must
    be strictly faster."""
    dev = resolve_device(device)
    params = _params(params, dev)
    cfg = solver_config or SolverConfig(max_al_iters=6, max_inner_iters=25,
                                        hessian="gauss_newton")
    x0 = initial_state_inverted(dev)
    tgt = torch.as_tensor(target, dtype=torch.float32, device=dev)
    rows, sols = [], {}
    for s in scales:
        dt_i = float(s) * dt_nominal
        ocp_i = build_quadrotor_ocp(target, dt=dt_i, thrust_max=thrust_max,
                                    params=params, device=dev)
        us0 = torch.full((num_nodes, 4), HOVER, device=dev)
        sol = ilqr.solve(ocp_i, x0, us0, cfg, cuda_chol=cuda_chol)
        miss, defect, finite = _summary(ocp_i, sol, tgt)
        viol = float(sol.violation)
        rows.append({"dt": dt_i, "T": dt_i * num_nodes, "miss": miss,
                     "violation": viol, "defect": defect,
                     "feasible": (miss < goal_tol and viol < 1e-2
                                  and defect < 1e-3 and finite)})
        sols[dt_i] = sol
    feas = [r for r in rows if r["feasible"]]
    best = min(feas, key=lambda r: r["T"]) if feas else rows[-1]
    dt_b = best["dt"]
    sol_b = sols[dt_b]
    out = {"candidates": rows, "dt_uniform": dt_b, "T_uniform": best["T"],
           "T_nominal": dt_nominal * num_nodes, "miss_uniform": best["miss"]}
    if not refine:
        out["solution"] = sol_b
        out["T_final"] = best["T"]
        return out

    def refine_from(sol0, dt0, dt_bounds, w_time):
        ocp_v = build_quadrotor_ocp_variable_time(
            target, dt_bounds=dt_bounds, thrust_max=thrust_max,
            params=params, w_time=w_time, device=dev)
        vs = torch.cat([sol0.us, torch.full((num_nodes, 1), dt0 ** 0.5,
                                            device=dev)], dim=1)
        sol_v = ilqr.solve(ocp_v, x0, vs, cfg, None, sol0.xs,
                           cuda_chol=cuda_chol)
        T_v = float(torch.sum(sol_v.us[:, 4] ** 2))
        return (sol_v, T_v) + _summary(ocp_v, sol_v, tgt)

    sol_v, T_v, miss_v, defect_v, fin_v = refine_from(
        sol_b, dt_b, (0.25 * dt_b, 1.5 * dt_b), 5.0)
    ok = (miss_v < goal_tol and defect_v < 1e-3 and fin_v
          and T_v <= best["T"])
    out.update(T_variable=T_v, miss_variable=miss_v,
               defect_variable=defect_v, variable_accepted=bool(ok))
    out["solution"] = sol_v if ok else sol_b
    out["T_final"] = T_v if ok else best["T"]
    # the free-time formulation alone, from the slack nominal, under a
    # stronger time weight: its time steps must buy time by themselves
    dt_n = float(scales[-1]) * dt_nominal
    _, T_vn, miss_vn, defect_vn, fin_vn = refine_from(
        sols[dt_n], dt_n, (0.25 * dt_nominal, 1.2 * dt_nominal), 20.0)
    ok_n = miss_vn < goal_tol and defect_vn < 1e-3 and fin_vn
    out.update(T_variable_from_nominal=T_vn if ok_n else None,
               miss_variable_from_nominal=miss_vn)
    return out
