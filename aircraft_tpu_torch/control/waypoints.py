"""Waypoint traversal through complementarity progress variables, and the
time-optimal planners built on it.

The port of ``aircraft_tpu/control/waypoints.py``: the Foehn et al.
time-optimal progress scheme mapped onto the AL-iLQR solver.

* Per-waypoint progress λ_j is an augmented state with dynamics
  λ⁺ = λ − μ, and the passage impulse μ_j an augmented control.
* Complementarity μ_j · (‖p − w_j‖² − tol²) ≤ 0 is a stage inequality
  under the augmented Lagrangian; ordering λ_j ≤ λ_{j+1} and the
  boundary conditions λ(0) = 1, λ(T) = 0 are stage and terminal rows.
* ``time_mode`` makes the timestep free: 'progress' (dt = 1/ν²),
  'variable' and 'adaptive' (dt = ν², the latter with a truncation-error
  bound), or 'sweep' (dt rides a constant state channel).

Every function is batch-leading, as the port's ``OCPFunctions`` are.  A
fixed ``dt`` may be a tensor of shape (B,), one timestep per scenario:
the solver hands ``step`` its rows scenario-major (B·N knots, B·A
line-search candidates or B initial states), so row r belongs to scenario
r // (rows / B).  ``_uniform_candidate_sweep`` solves all its candidates
in one batch that way, where the reference builds one problem per traced
dt under ``vmap``.

The planners take ``device`` (``cuda`` unless the caller asks for the
CPU) and ``cuda_chol``: the batched solves (the candidate sweep, the
free-time ladder) then take the batched-Cholesky kernel in their Riccati
sweeps, as the reference's vmapped solves reach its Pallas kernel under
``enable_pallas_chol``, and so does the fixed-time racing solve of
``solve_waypoint_racing(cuda_chol=True)`` (one system per knot, as
``examples/waypoint_racing.py --cuda-chol`` runs it).  The other single
solves (the warm starts, the time-optimal sweep's nominal) keep the
reference route.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from aircraft_tpu_torch.config import SolverConfig, TrajectoryConfig
from aircraft_tpu_torch.control.aircraft import (REFERENCE_ENVELOPE,
                                                 envelope_ineq)
from aircraft_tpu_torch.device import resolve_device
from aircraft_tpu_torch.dynamics import aircraft as ac
from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
from aircraft_tpu_torch.solvers import ilqr, integrators
from aircraft_tpu_torch.solvers import ocp as ocp_mod
from aircraft_tpu_torch.solvers.ocp import ALState, OCPFunctions
from aircraft_tpu_torch.solvers.rollout import rollout

TIME_MODES = ("fixed", "progress", "variable", "adaptive", "sweep")


def _per_row(dt: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """A per-scenario dt (B,) expanded to z's leading rows, scenario-major,
    shaped to broadcast against z's batch axes z.shape[:-1]."""
    rows = z.shape[0]
    if rows % dt.shape[0]:
        raise ValueError(f"{rows} rows do not split into {dt.shape[0]} "
                         "scenarios")
    dt = dt.repeat_interleave(rows // dt.shape[0])
    return dt.reshape((rows,) + (1,) * (z.ndim - 2))


def build_waypoint_ocp(params: AircraftParams, config: TrajectoryConfig, *,
                       dt, num_nodes: int, substeps: int = 1,
                       time_mode: str = "fixed",
                       dt_bounds: tuple = (1e-3, 5e-2),
                       adaptive_tol: float = 1e-2,
                       adaptive_alpha: float = 1e-2, w_effort: float = 0.05,
                       w_time: float = 1.0, w_mu: float = 1e-3
                       ) -> OCPFunctions:
    """The augmented OCP: state z = [x(13), λ(n_wp)] (+ the dt channel in
    'sweep'), control v = [u(7), μ(n_wp)] (+ ν in the free-time modes).
    ``dt`` is a number or, one per scenario, a tensor (B,)."""
    if time_mode not in TIME_MODES:
        raise ValueError(f"time_mode={time_mode!r}: expected one of "
                         f"{TIME_MODES}")
    dev = params.device
    wps = torch.as_tensor(config.waypoints.array(), dtype=torch.float32,
                          device=dev)                          # (n_wp, 3)
    n_wp = wps.shape[0]
    wp_idx = list(config.waypoints.waypoint_indices)
    tol2 = float(np.float32(config.waypoints.tolerance ** 2))
    comp_scale = max(tol2, 1.0)
    step13 = integrators.make_step_fn(params, substeps=substeps,
                                      normalize="step")
    env = envelope_ineq(params, config.state, config.control,
                        **REFERENCE_ENVELOPE)
    progress_time = time_mode in ("progress", "variable", "adaptive")
    sweep_time = time_mode == "sweep"
    dt_rows = torch.is_tensor(dt) and dt.ndim == 1
    if dt_rows:
        dt = dt.to(device=dev, dtype=torch.float32)

    def split(z, v):
        x, lam = z[..., :13], z[..., 13:13 + n_wp]
        u, mu = v[..., :7], v[..., 7:7 + n_wp]
        if time_mode == "progress":
            nu = v[..., 7 + n_wp]
            dt_k = 1.0 / (nu * nu + 1e-9)
        elif time_mode in ("variable", "adaptive"):
            nu = v[..., 7 + n_wp]
            dt_k = nu * nu
        elif sweep_time:
            dt_k = z[..., 13 + n_wp]
        else:
            dt_k = None             # the fixed dt: only the step reads it
        return x, lam, u, mu, dt_k

    def wp_dist2(x):
        diff = (x[..., None, :3] - wps)[..., wp_idx]    # declared dims only
        return torch.sum(diff * diff, dim=-1)           # (..., n_wp)

    def step(z, v, k):
        x, lam, u, mu, dt_k = split(z, v)
        if dt_k is None:
            dt_k = _per_row(dt, z) if dt_rows else dt
        parts = [step13(x, u, dt_k), lam - mu]
        if sweep_time:
            parts.append(z[..., 13 + n_wp:14 + n_wp])   # dt stays constant
        return torch.cat(parts, dim=-1)

    def stage_cost(z, v, k):
        x, lam, u, mu, dt_k = split(z, v)
        c = (w_effort * torch.sum(u[..., :3] * u[..., :3], dim=-1)
             + w_mu * torch.sum(mu * mu, dim=-1))
        if progress_time or sweep_time:
            c = c + w_time * dt_k                       # total time
        return c

    def terminal_cost(z):
        return z.new_zeros(z.shape[:-1])

    def ineq(z, v, k):
        x, lam, u, mu, dt_k = split(z, v)
        # complementarity (≤ 0 under AL), scaled by tol² so the penalty
        # stays in a float32-friendly range for far waypoints
        comp = mu * (wp_dist2(x) - tol2) / comp_scale
        parts = [env(x, u, k), -mu, -lam, lam - 1.0,
                 lam[..., :-1] - lam[..., 1:], comp]
        if progress_time:
            nu = v[..., 7 + n_wp]
            if time_mode == "progress":
                lo = 1.0 / np.sqrt(dt_bounds[1])
                hi = 1.0 / np.sqrt(dt_bounds[0])
            else:
                lo, hi = np.sqrt(dt_bounds[0]), np.sqrt(dt_bounds[1])
            parts.append(torch.stack([lo - nu, nu - hi], dim=-1))
        if time_mode == "adaptive":
            # local-truncation-error surrogate α dt² |(Jf)ᵀ J (Jf)| ≤ tol,
            # the Jacobian-vector products by forward mode (|·| because J
            # is not positive semi-definite)
            f = lambda xx: ac.state_derivative(params, xx, u)
            _, Jf = torch.func.jvp(f, (x,), (f(x),))
            _, JJf = torch.func.jvp(f, (x,), (Jf,))
            err = (adaptive_alpha * dt_k * dt_k
                   * torch.abs(torch.sum(Jf * JJf, dim=-1)))
            parts.append((err - adaptive_tol)[..., None])
        return torch.cat(parts, dim=-1)

    def terminal_eq(z):
        return z[..., 13:13 + n_wp]         # every waypoint consumed: λ(T) = 0

    # feedback only on the physical surfaces: feedback on the μ impulses
    # or the per-knot timestep turns small rollout deviations into
    # trajectory-wide time warps that diverge every line-search candidate
    mask = [1] * 7 + [0] * n_wp + ([0] if progress_time else [])
    return OCPFunctions(step=step, stage_cost=stage_cost,
                        terminal_cost=terminal_cost, ineq=ineq,
                        terminal_eq=terminal_eq, feedback_mask=tuple(mask))


def initial_guess(config: TrajectoryConfig, num_nodes: int, *,
                  time_mode: str = "fixed", dt: float = 0.01,
                  device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """(z0 (13 + n_wp,), vs_init (N, m)): λ₀ = 1, and μ spikes at the
    switching knots estimated from the cumulative waypoint distances."""
    dev = resolve_device(device)
    n_wp = len(config.waypoints.waypoints)
    x0 = np.asarray(config.waypoints.initial_state, dtype=np.float32)
    z0 = np.concatenate([x0, np.ones(n_wp, dtype=np.float32)])
    cum = config.waypoints.cumulative_distances()
    i_switch = np.minimum(
        (num_nodes * cum[1:] / max(cum[-1], 1e-9)).astype(int), num_nodes - 1)
    free_time = time_mode in ("progress", "variable", "adaptive")
    m = 7 + n_wp + (1 if free_time else 0)
    vs = np.zeros((num_nodes, m), dtype=np.float32)
    for j, i in enumerate(i_switch):
        vs[i, 7 + j] = 1.0
    if time_mode == "progress":
        vs[:, -1] = 1.0 / np.sqrt(dt)
    elif free_time:
        vs[:, -1] = np.sqrt(dt)
    return torch.as_tensor(z0, device=dev), torch.as_tensor(vs, device=dev)


def _place_mu_numpy(vs: np.ndarray, xs: np.ndarray, wps: np.ndarray):
    """The μ passage impulses moved to the trajectory's closest-approach
    knots, in passage order (all three coordinates), in place."""
    n_wp = wps.shape[0]
    vs[:, 7:7 + n_wp] = 0.0
    prev = 0
    for j in range(n_wp):
        d = np.linalg.norm(xs[:-1, :3] - wps[j], axis=1)
        d[:prev] = np.inf                  # keep passage order
        i = int(np.argmin(d))
        vs[i, 7 + j] = 1.0
        prev = i
    return vs


def _place_mu_impulses(vs: torch.Tensor, xs: torch.Tensor,
                       wps: torch.Tensor, wp_idx, n_wp: int) -> torch.Tensor:
    """The μ passage impulses of vs (N, m) re-placed at the closest-approach
    knots of xs (N+1, n) over the declared dimensions ``wp_idx``, keeping
    passage order; on the device, no host read."""
    N = vs.shape[0]
    ks = torch.arange(N, device=vs.device)
    vs = vs.clone()
    vs[:, 7:7 + n_wp] = 0.0
    diff = (xs[:-1, None, :3] - wps[None])[..., list(wp_idx)]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1))         # (N, n_wp)
    prev = torch.zeros((), dtype=torch.int64, device=vs.device)
    for j in range(n_wp):
        d = torch.where(ks < prev, torch.full_like(dist[:, j], np.inf),
                        dist[:, j])
        i = torch.argmin(d)
        vs[i, 7 + j] = 1.0
        prev = i
    return vs


def tracking_warm_start(params: AircraftParams, config: TrajectoryConfig, *,
                        num_nodes: int, dt: float, substeps: int = 1,
                        trim_control=None,
                        solver_config: Optional[SolverConfig] = None,
                        device="cuda") -> torch.Tensor:
    """Stage-A solve: smooth path-following onto the Dubins reference
    positions; its controls (N, 7) become the warm start."""
    from aircraft_tpu_torch.control.initialisation import DubinsInitialiser

    dev = resolve_device(device)
    if params.device != dev:
        params = params.to(dev)
    ref = torch.as_tensor(DubinsInitialiser(config).state_guess(num_nodes),
                          device=dev)                          # (N+1, 13)
    step13 = integrators.make_step_fn(params, substeps=substeps,
                                      normalize="step")

    def stage_cost(x, u, k):
        r = ref[k + 1]
        pos = torch.sum((x[..., :3] - r[..., :3]) ** 2, dim=-1)
        vel = torch.sum((x[..., 3:6] - r[..., 3:6]) ** 2, dim=-1)
        return 1e-2 * pos + 1e-2 * vel + 1e-3 * torch.sum(u[..., :3] ** 2,
                                                          dim=-1)

    ocp = OCPFunctions(
        step=lambda x, u, k: step13(x, u, dt), stage_cost=stage_cost,
        terminal_cost=lambda x: torch.sum((x[..., :3] - ref[-1, :3]) ** 2,
                                          dim=-1) * 1e-2)
    x0 = torch.as_tensor(config.waypoints.initial_state, dtype=torch.float32,
                         device=dev)
    if trim_control is None:
        us0 = torch.zeros((num_nodes, 7), device=dev)
    else:
        u_trim = torch.as_tensor(trim_control, dtype=torch.float32,
                                 device=dev)[:7]
        us0 = u_trim[None].repeat(num_nodes, 1)
    cfg = solver_config or SolverConfig(max_al_iters=1, max_inner_iters=30)
    return ilqr.solve(ocp, x0, us0, cfg).us


def receding_warm_start(params: AircraftParams, config: TrajectoryConfig, *,
                        num_nodes: int, dt: float, substeps: int = 1,
                        window: int = 30, overlap: int = 20,
                        solver_config: Optional[SolverConfig] = None,
                        device="cuda") -> torch.Tensor:
    """Closed-loop MHTT flight along the Dubins track as the warm start for
    long horizons: one whole-horizon tracking solve cannot stabilise the
    open-loop-unstable plant over hundreds of knots, the receding-horizon
    controller replanning every ``window - overlap`` knots can.  ``MHTT``
    runs its pipelined loop, on the window kernels on ``cuda``.  Returns
    (num_nodes, 7) controls, cut or held to length."""
    from aircraft_tpu_torch.control.initialisation import DubinsInitialiser
    from aircraft_tpu_torch.control.mhtt import MHTT

    dev = resolve_device(device)
    mhtt = MHTT(params, config, DubinsInitialiser(config), num_nodes=window,
                dt=dt, overlap=overlap, substeps=substeps,
                solver_config=solver_config or SolverConfig(
                    max_al_iters=2, max_inner_iters=10,
                    hessian="gauss_newton"),
                device=dev)
    x0 = np.asarray(config.waypoints.initial_state, dtype=np.float32)
    max_windows = num_nodes // max(window - overlap, 1) + 2
    out = mhtt.run(x0, max_windows=max_windows, progress_target=0.995)
    us = np.asarray(out["controls"], dtype=np.float32)
    if us.shape[0] >= num_nodes:
        us = us[:num_nodes]
    elif us.shape[0] > 0:
        us = np.concatenate(
            [us, np.tile(us[-1:], (num_nodes - us.shape[0], 1))], axis=0)
    else:
        us = np.zeros((num_nodes, 7), np.float32)
    return torch.as_tensor(us, device=dev)


def _trim_control(params, config, generator, z0s):
    """The racing warm start's trim, of the plant as flown, from the start
    cloud ``z0s`` or 32 draws of ``generator`` (a seed-0 CPU generator by
    default; the reference draws from ``PRNGKey(0)``, which torch cannot
    replay)."""
    from aircraft_tpu_torch.solvers.trim import multistart_trim

    if z0s is None and generator is None:
        generator = torch.Generator().manual_seed(0)
    trim = multistart_trim(
        params, z0s, n_starts=32,
        target_airspeed=float(config.waypoints.default_velocity),
        generator=generator)
    return trim.control


def solve_waypoint_racing(params: AircraftParams, config: TrajectoryConfig,
                          *, num_nodes: int = 100, dt: float = 0.02,
                          substeps: int = 1, time_mode: str = "fixed",
                          dt_bounds: Optional[tuple] = None,
                          solver_config: Optional[SolverConfig] = None,
                          warm_start: bool = True,
                          warm_start_mode: str = "tracking",
                          report_out: Optional[dict] = None,
                          generator: Optional[torch.Generator] = None,
                          z0s: Optional[torch.Tensor] = None,
                          warm_start_config: Optional[SolverConfig] = None,
                          cuda_chol: bool = False,
                          device="cuda") -> ilqr.ILQRSolution:
    """End-to-end waypoint traversal: the tracking (or receding) warm
    start, then the complementarity OCP, one unbatched solve.

    Free-time modes are staged: the fixed-time solve first, then
    ``_refine_free_time`` frees the timesteps around it.  ``generator`` or
    ``z0s`` give the trim start cloud (see ``_trim_control``);
    ``warm_start_config`` replaces the warm start's own budget (1 x 30
    tracking, 2 x 10 receding)."""
    dev = resolve_device(device)
    if params.device != dev:
        params = params.to(dev)
    if dt_bounds is None:
        # the nominal dt strictly inside the free-time box
        dt_bounds = (dt / 10.0, dt * 4.0)
    if time_mode in ("progress", "variable", "adaptive"):
        sol_fixed = solve_waypoint_racing(
            params, config, num_nodes=num_nodes, dt=dt, substeps=substeps,
            time_mode="fixed", solver_config=solver_config,
            warm_start=warm_start, warm_start_mode=warm_start_mode,
            generator=generator, z0s=z0s,
            warm_start_config=warm_start_config, device=dev)
        return _refine_free_time(
            params, config, sol_fixed, num_nodes=num_nodes, dt=dt,
            substeps=substeps, time_mode=time_mode, dt_bounds=dt_bounds,
            solver_config=solver_config, report_out=report_out,
            cuda_chol=cuda_chol, device=dev)
    ocp = build_waypoint_ocp(params, config, dt=dt, num_nodes=num_nodes,
                             substeps=substeps, time_mode=time_mode,
                             dt_bounds=dt_bounds)
    z0, vs = initial_guess(config, num_nodes, time_mode=time_mode, dt=dt,
                           device=dev)
    if warm_start:
        trim_control = _trim_control(params, config, generator, z0s)
        if warm_start_mode == "receding":
            us_track = receding_warm_start(
                params, config, num_nodes=num_nodes, dt=dt,
                substeps=substeps, solver_config=warm_start_config,
                device=dev)
        else:
            us_track = tracking_warm_start(
                params, config, num_nodes=num_nodes, dt=dt,
                substeps=substeps, trim_control=trim_control,
                solver_config=warm_start_config, device=dev)
        # the μ passage impulses at the tracked flight's closest approaches
        step13 = integrators.make_step_fn(params, substeps=substeps,
                                          normalize="step")
        xs_track = rollout(step13, z0[:13], us_track, dt)
        vs_np = vs.cpu().numpy()
        vs_np[:, :7] = us_track.cpu().numpy()
        vs = torch.as_tensor(_place_mu_numpy(
            vs_np, xs_track.cpu().numpy(), config.waypoints.array()),
            device=dev)
    cfg = solver_config or SolverConfig(max_al_iters=8, max_inner_iters=25)
    return ilqr.solve(ocp, z0, vs, cfg, cuda_chol=cuda_chol)


def _uniform_candidate_sweep(params: AircraftParams, config: TrajectoryConfig,
                             sol_nominal: ilqr.ILQRSolution,
                             dt_nominal: float, dts, *, num_nodes: int,
                             substeps: int, solver_config: SolverConfig,
                             cuda_chol: bool = False) -> ilqr.ILQRSolution:
    """The fixed-time racing problem at each uniform dt of ``dts`` (C,),
    all C candidates as one batch-leading ``solve_impl``, each seeded with
    the nominal solution's controls (with its solved μ distribution) and,
    as ``xs_init``, its trajectory time-warped to the candidate's rate
    (velocities and body rates scaled by dt_nominal / dt_i, so position
    rows agree with the candidate's dynamics by construction).  Returns
    the batch's solution.

    A candidate whose solve never accepted a rollout hands its seed back:
    callers gate every candidate on ``ocp.rollout_defect``."""
    dev = params.device
    dts = torch.as_tensor(np.asarray(dts, np.float32), device=dev)
    C = dts.shape[0]
    z0, _ = initial_guess(config, num_nodes, time_mode="fixed",
                          dt=float(dts[0]), device=dev)
    us_nom = torch.as_tensor(sol_nominal.us, device=dev)
    xs_nom = torch.as_tensor(sol_nominal.xs, device=dev)
    scale = (torch.tensor(dt_nominal, dtype=torch.float32, device=dev)
             / dts)[:, None, None]
    xs_init = xs_nom[None].repeat(C, 1, 1)
    xs_init[..., 3:6] *= scale
    xs_init[..., 10:13] *= scale
    ocp = build_waypoint_ocp(params, config, dt=dts, num_nodes=num_nodes,
                             substeps=substeps, time_mode="fixed")
    return ilqr.solve_impl(ocp, z0[None].expand(C, -1).contiguous(),
                           us_nom[None].expand(C, -1, -1).contiguous(),
                           solver_config, xs_init=xs_init,
                           cuda_chol=cuda_chol)


def _batched_defects(params, config, dts, xs, us, *, num_nodes, substeps):
    """``rollout_defect`` of each candidate at its own dt, (C,) numpy."""
    ocp = build_waypoint_ocp(
        params, config,
        dt=torch.as_tensor(np.asarray(dts, np.float32), device=params.device),
        num_nodes=num_nodes, substeps=substeps, time_mode="fixed")
    return ocp_mod.rollout_defect(ocp, xs, us).cpu().numpy()


def _refine_free_time(params: AircraftParams, config: TrajectoryConfig,
                      sol_fixed: ilqr.ILQRSolution, *, num_nodes: int,
                      dt: float, substeps: int, time_mode: str,
                      dt_bounds: tuple,
                      solver_config: Optional[SolverConfig],
                      report_out: Optional[dict] = None,
                      cuda_chol: bool = False,
                      device="cuda") -> ilqr.ILQRSolution:
    """Stage B of the free-time solve.

    B0, uniform contraction: the fixed-time problem re-solved at a ladder
    of sub-nominal uniform dts (one batch of 5, seeded from the
    incumbent), and the fastest feasible schedule taken.  B1, per-knot
    refinement around the B0 winner in the mode's own formulation, inside
    a trust-region dt box.  Returns the best of {incumbent, B0 winner, B1}
    by feasibility, then total time.  ``report_out`` receives the
    reference's ``b0_ladder``, ``b0_winner_scale`` and ``b1`` records."""
    dev = resolve_device(device)
    if params.device != dev:
        params = params.to(dev)
    cfg = solver_config or SolverConfig(max_al_iters=8, max_inner_iters=25)
    tol = float(config.waypoints.tolerance)
    wps = np.asarray(config.waypoints.array())

    def miss_of(xs):
        xs = np.asarray(xs)
        return max(float(np.linalg.norm(xs[:, :3] - w, axis=1).min())
                   for w in wps)

    # B0: uniform contraction ladder (sub-nominal and the nominal)
    scales = np.asarray([0.70, 0.78, 0.86, 0.93, 1.0], np.float32)
    dts_u = np.maximum(scales * dt, dt_bounds[0])
    sweep = _uniform_candidate_sweep(
        params, config, sol_fixed, dt, dts_u, num_nodes=num_nodes,
        substeps=substeps, solver_config=cfg, cuda_chol=cuda_chol)
    xs_u = sweep.xs.cpu().numpy()
    miss_u = np.asarray([miss_of(xs_u[i]) for i in range(len(dts_u))])
    fin_u = np.isfinite(xs_u).all(axis=(1, 2))
    # a candidate that kept its time-warped seed is no flyable schedule
    defects = _batched_defects(params, config, dts_u, sweep.xs, sweep.us,
                               num_nodes=num_nodes, substeps=substeps)
    feas_u = (miss_u <= tol) & fin_u & (defects < 1e-2)
    best_u = None
    for i in np.argsort(dts_u):
        if feas_u[i]:
            best_u = int(i)
            break
    if report_out is not None:
        report_out["b0_ladder"] = [
            {"scale": round(float(dts_u[i] / dt), 3),
             "dt": round(float(dts_u[i]), 5),
             "total_time_s": round(float(dts_u[i]) * num_nodes, 3),
             "max_waypoint_miss_m": round(float(miss_u[i]), 2),
             "rollout_defect": round(float(defects[i]), 5),
             "finite": bool(fin_u[i]),
             "feasible": bool(feas_u[i])}
            for i in range(len(dts_u))]
        report_out["b0_winner_scale"] = (
            round(float(dts_u[best_u] / dt), 3) if best_u is not None
            else None)

    if best_u is not None and dts_u[best_u] < dt:
        dt_b = float(dts_u[best_u])
        sol_b = ilqr.take(sweep, best_u)
    else:
        dt_b, sol_b = dt, sol_fixed
    us_b, xs_b = sol_b.us, sol_b.xs

    # B1: per-knot refinement in the mode's own formulation
    tr = (max(dt_bounds[0], 0.5 * dt_b), min(dt_bounds[1], 2.0 * dt_b))
    ocp = build_waypoint_ocp(params, config, dt=dt_b, num_nodes=num_nodes,
                             substeps=substeps, time_mode=time_mode,
                             dt_bounds=tr)
    z0, _ = initial_guess(config, num_nodes, time_mode=time_mode, dt=dt_b,
                          device=dev)
    nu0 = (1.0 / np.sqrt(dt_b)) if time_mode == "progress" else np.sqrt(dt_b)
    vs = torch.cat([us_b, torch.full((num_nodes, 1), float(nu0),
                                     device=dev)], dim=1)
    # trajectory-seeded: replaying the winner's controls open-loop can
    # diverge through chaotic regimes
    sol = ilqr.solve(ocp, z0, vs, cfg, None, xs_b)

    def timed_metrics(xs, vss):
        nu = vss.cpu().numpy()[:, -1]
        dts = (1.0 / (nu ** 2 + 1e-9)) if time_mode == "progress" else nu ** 2
        xs = xs.cpu().numpy()
        return miss_of(xs), float(dts.sum()), bool(np.isfinite(xs).all())

    miss_r, T_r, fin_r = timed_metrics(sol.xs, sol.us)
    miss_i, T_i = miss_of(xs_b.cpu().numpy()), dt_b * num_nodes
    accept = fin_r and ((miss_r <= tol and (miss_i > tol or T_r <= T_i))
                        or (miss_i > tol and miss_r <= miss_i))
    if report_out is not None:
        report_out["b1"] = {
            "mode": time_mode,
            "trust_region_dt": [round(float(t), 5) for t in tr],
            "refined_total_time_s": round(T_r, 3),
            "refined_max_miss_m": round(miss_r, 2),
            "incumbent_total_time_s": round(T_i, 3),
            "incumbent_max_miss_m": round(miss_i, 2),
            "finite": bool(fin_r),
            "accepted": bool(accept),
        }
    if accept:
        return sol
    # outer rejection: the B0 winner lifted into the free-time variables
    viol = ocp_mod.max_violation(ocp, xs_b[None], vs[None])[0]
    return ilqr.ILQRSolution(xs=xs_b, us=vs, cost=sol_b.cost, violation=viol,
                             converged=sol_b.converged,
                             iterations=sol_b.iterations,
                             grad_norm=sol_b.grad_norm, al=None)


def solve_time_optimal(params: AircraftParams, config: TrajectoryConfig, *,
                       num_nodes: int = 70, dt_nominal: float = 0.1,
                       substeps: int = 1, n_candidates: int = 8,
                       dt_span: tuple = (0.6, 1.4),
                       solver_config: Optional[SolverConfig] = None,
                       per_candidate_warm_start: bool = True,
                       generator: Optional[torch.Generator] = None,
                       z0s: Optional[torch.Tensor] = None,
                       warm_start_config: Optional[SolverConfig] = None,
                       cuda_chol: bool = False, device="cuda") -> dict:
    """Time-optimal waypoint racing by a batched time-scale sweep: the
    nominal fixed-time racing problem is solved first, then
    ``n_candidates`` uniform dts across ``dt_span`` × ``dt_nominal`` in
    one batch, each warm-started from the nominal solution
    (``_uniform_candidate_sweep``), and the nominal joins the candidates.
    The shortest schedule whose waypoints pass within tolerance as a true
    rollout (defect < 1e-2) wins; with none, the smallest worst miss.

    ``per_candidate_warm_start=False`` is the reference's legacy branch,
    which reads a ``trim`` it never binds and so raises NameError there;
    here it raises NotImplementedError."""
    if not per_candidate_warm_start:
        raise NotImplementedError(
            "per_candidate_warm_start=False: the reference's legacy shared "
            "warm start reads an unbound `trim` and raises NameError; it "
            "is not ported")
    dev = resolve_device(device)
    if params.device != dev:
        params = params.to(dev)
    dts = np.linspace(dt_span[0] * dt_nominal, dt_span[1] * dt_nominal,
                      n_candidates).astype(np.float32)
    wps_np = np.asarray(config.waypoints.array())
    cfg_s = solver_config or SolverConfig(max_al_iters=6, max_inner_iters=20)

    nominal = solve_waypoint_racing(
        params, config, num_nodes=num_nodes, dt=dt_nominal,
        substeps=substeps, time_mode="fixed", solver_config=cfg_s,
        generator=generator, z0s=z0s, warm_start_config=warm_start_config,
        device=dev)
    sols = _uniform_candidate_sweep(
        params, config, nominal, dt_nominal, dts, num_nodes=num_nodes,
        substeps=substeps, solver_config=cfg_s, cuda_chol=cuda_chol)
    # the nominal solve joins the candidates as the last row
    sols = ilqr.ILQRSolution(
        *(torch.cat([c, n[None]]) for c, n in zip(sols[:-1], nominal[:-1])),
        al=ALState.cat([sols.al, ALState(*(getattr(nominal.al, f)[None]
                                           for f in ocp_mod._AL_FIELDS))]))
    dts = np.concatenate([dts, [np.float32(dt_nominal)]])

    xs = sols.xs.cpu().numpy()
    tol = config.waypoints.tolerance
    dmins = np.stack(
        [np.linalg.norm(xs[:, :, :3] - w, axis=-1).min(axis=1)
         for w in wps_np], axis=-1)
    # feasible: inside the declared tolerance, and a true rollout
    defects = _batched_defects(params, config, dts, sols.xs, sols.us,
                               num_nodes=num_nodes, substeps=substeps)
    feasible = ((dmins < tol).all(axis=-1)
                & np.isfinite(xs).all(axis=(1, 2)) & (defects < 1e-2))
    T = dts * num_nodes
    best = None
    for i in np.argsort(T):
        if feasible[i]:
            best = int(i)
            break
    if best is None:
        best = int(np.argmin(dmins.max(axis=-1)))
    return {
        "solution": ilqr.take(sols, best),
        "dt": float(dts[best]),
        "total_time": float(T[best]),
        "feasible": feasible,
        "dmins": dmins,
        "candidate_times": T,
        "candidate_dts": np.asarray(dts, np.float64),
        "defects": defects,
    }


def solve_waypoint_legs(params: AircraftParams, config: TrajectoryConfig, *,
                        nodes_per_leg: int = 90, dt: float = 0.1,
                        substeps: int = 10,
                        solver_config: Optional[SolverConfig] = None,
                        generator: Optional[torch.Generator] = None,
                        z0s: Optional[torch.Tensor] = None,
                        device="cuda") -> dict:
    """Leg-by-leg waypoint traversal: a short 1-waypoint racing solve to
    each waypoint in turn, every leg starting from the previous leg's
    closest-approach state (the shape of the flagship controller's outer
    loop)."""
    dev = resolve_device(device)
    cfg_s = solver_config or SolverConfig(max_al_iters=6, max_inner_iters=20)
    wps = np.asarray(config.waypoints.array())
    state = np.asarray(config.waypoints.initial_state, np.float32)
    all_states, all_controls, dmins = [state[None, :]], [], []
    for wpt in wps:
        leg_dict = {
            "waypoints": {
                "waypoints": [wpt.tolist()],
                "initial_state": state.tolist(),
                "default_velocity": config.waypoints.default_velocity,
                "waypoint_indices": list(config.waypoints.waypoint_indices),
                "waypoint_tolerance": config.waypoints.tolerance,
            },
            "aircraft": dataclasses.asdict(config.aircraft),
            "state": {
                "alpha": list(config.state.alpha),
                "beta": list(config.state.beta),
                "airspeed": list(config.state.airspeed),
            },
            "control": {
                "aileron_limit": list(config.control.aileron),
                "elevator_limit": list(config.control.elevator),
                "rudder_limit": list(config.control.rudder),
                "throttle_limit": [list(config.control.throttle[0]),
                                   list(config.control.throttle[1])],
                "centre_of_mass_limit": [
                    list(config.control.centre_of_mass[0]),
                    list(config.control.centre_of_mass[1])],
            },
        }
        sol = solve_waypoint_racing(
            params, TrajectoryConfig.from_dict(leg_dict),
            num_nodes=nodes_per_leg, dt=dt, substeps=substeps,
            solver_config=cfg_s, generator=generator, z0s=z0s, device=dev)
        xs = sol.xs.cpu().numpy()
        d = np.linalg.norm(xs[:, :3] - wpt, axis=1)
        k = int(np.argmin(d))
        dmins.append(float(d[k]))
        # commit up to the closest-approach knot, start the next leg there
        all_states.append(xs[1:k + 1, :13])
        all_controls.append(sol.us.cpu().numpy()[:k, :7])
        state = xs[k, :13].astype(np.float32)
    return {
        "states": np.concatenate(all_states, axis=0),
        "controls": (np.concatenate(all_controls, axis=0) if all_controls
                     else np.zeros((0, 7), np.float32)),
        "dmins": dmins,
        "success": all(d < config.waypoints.tolerance for d in dmins),
    }
