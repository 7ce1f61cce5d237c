"""Ablation harness over the transcription option grid: model ×
quaternion strategy × integration × substeps, one single-problem iLQR
solve per case, plus the free-time axis on the short two-waypoint course.

    python -m aircraft_tpu_torch.ablation --device cpu --quick --out DIR
    python -m aircraft_tpu_torch.ablation --models default --ref-moments \\
        --out build/aircraft_tpu_torch/ablation

Each row is a JSON line on stdout; with ``--out`` the rows go to
``DIR/partial_<tag>.json`` and each case's trajectory to
``DIR/traj_*.npz`` (``--merge`` joins the partials into
``summary.json``).  ``--models``, ``--substeps`` and ``--integrations``
run a shard of the grid, each shard with a partial of its own.  Nothing
is written without ``--out``.  A failed case records its error in the
row and the sweep goes on.
"""

from __future__ import annotations

import argparse
import itertools
import json
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from aircraft_tpu_torch.config import (SolverConfig, TrajectoryConfig,
                                       glider_config)
from aircraft_tpu_torch.control.aircraft import build_aircraft_ocp, goal_cost
from aircraft_tpu_torch.device import resolve_device
from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
from aircraft_tpu_torch.dynamics.coefficients import default_artifact_coeff
from aircraft_tpu_torch.observability import solver_metrics
from aircraft_tpu_torch.solvers import ilqr
from aircraft_tpu_torch.solvers.trim import multistart_trim
from aircraft_tpu_torch.utils import TrajectoryData

QUATERNION_MODES = ("integration", "expmap", "")
SUBSTEPS = (1, 5, 10)
MODELS = ("default", "linear", "poly", "nn")
INTEGRATION_MODES = ("explicit", "implicit")
TIME_MODES = ("fixed", "progress", "variable", "adaptive")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_case(config: TrajectoryConfig, *, model: str, quaternion: str,
             substeps: int, num_nodes: int, dt: float, goal,
             solver_config: SolverConfig, integration: str = "explicit",
             start: str = "level", ref_moments: bool = False,
             device="cuda") -> tuple[dict, ilqr.ILQRSolution]:
    """One grid case: the goal-reaching OCP of ``model`` under the
    quaternion strategy and integrator, solved from the trim control
    (``start='trim'`` also starts from the trim state, placed at the
    configured position).  ``ref_moments`` composes moments about the CoM
    without the aero-centre arm, the reference's own convention.
    Returns (row, solution)."""
    dev = resolve_device(device)
    params = AircraftParams.from_config(
        config.aircraft, coeff=default_artifact_coeff(model, device=dev),
        com_in_moments=not ref_moments, device=dev)
    stage, terminal = goal_cost(np.asarray(goal, np.float32), w_goal=1e-2,
                                w_control=1e-2, device=dev)
    ocp = build_aircraft_ocp(params, config, dt=dt, substeps=substeps,
                             quaternion=quaternion, integration=integration,
                             stage_cost=stage, terminal_cost=terminal)
    x0 = np.asarray(config.waypoints.initial_state, np.float32)
    # the trim warm start: from zero controls the open-loop-unstable
    # glider stalls or dives within the horizon
    trim = multistart_trim(params, n_starts=8,
                           target_airspeed=max(float(np.linalg.norm(x0[3:6])),
                                               30.0),
                           generator=torch.Generator().manual_seed(0))
    us0 = trim.control.to(dev, torch.float32)[:7].expand(num_nodes, 7)
    x0 = torch.as_tensor(x0, device=dev)
    if start == "trim":
        x0 = torch.cat([x0[:3], trim.state.to(dev, torch.float32)[3:]])

    _sync(dev)
    t0 = time.time()
    sol = ilqr.solve(ocp, x0, us0.contiguous(), solver_config)
    _sync(dev)
    wall = time.time() - t0

    xs = sol.xs.detach().cpu().numpy()
    m = solver_metrics(sol, wall)
    m.update(
        model=model, quaternion=quaternion or "none", substeps=substeps,
        integration=integration, num_nodes=num_nodes, dt=dt, start=start,
        moments="about_com" if ref_moments else "aero_centre_arm",
        goal_distance=float(np.linalg.norm(xs[-1, :3] - np.asarray(goal))),
        quaternion_drift=float(np.abs(np.linalg.norm(xs[:, 6:10], axis=1)
                                      - 1.0).max()),
        # practical feasibility, apart from the stationarity flag
        feasible=bool(m["primal_inf"] < 0.1),
        wall_s=round(wall, 2),
    )
    return m, sol


def run_ablation(config: Optional[TrajectoryConfig] = None, *,
                 models=MODELS, quaternion_modes=QUATERNION_MODES,
                 substeps_grid=SUBSTEPS, integration_modes=("explicit",),
                 time_modes=(), num_nodes: int = 40, dt: float = 0.05,
                 out_dir: Optional[str] = None,
                 solver_config: Optional[SolverConfig] = None,
                 start: str = "level", ref_moments: bool = False,
                 device="cuda") -> list[dict]:
    """Every case of the grid, then each free-time mode; goal +[120, 20,
    10] m from the configured start.  ``constraint_tol`` 0.1 is the grid's
    own feasibility gate.  Asking for a missing card raises here, before
    the sweep would record it as every case's error."""
    device = resolve_device(device)
    config = config or glider_config()
    solver_config = solver_config or SolverConfig(
        max_al_iters=4, max_inner_iters=25, constraint_tol=0.1)
    init = np.asarray(config.waypoints.initial_state)
    goal = init[:3] + np.array([120.0, 20.0, 10.0])

    rows = []
    for model, qmode, ss, integ in itertools.product(
            models, quaternion_modes, substeps_grid, integration_modes):
        try:
            m, sol = run_case(
                config, model=model, quaternion=qmode, substeps=ss,
                integration=integ, num_nodes=num_nodes, dt=dt, goal=goal,
                solver_config=solver_config, start=start,
                ref_moments=ref_moments, device=device)
            if out_dir:
                Path(out_dir).mkdir(parents=True, exist_ok=True)
                name = f"traj_{model}_{qmode or 'none'}_ss{ss}" + (
                    "" if integ == "explicit" else f"_{integ}")
                TrajectoryData(
                    state=sol.xs.detach().cpu().numpy(),
                    control=sol.us.detach().cpu().numpy(),
                ).save_npz(Path(out_dir) / f"{name}.npz")
        except Exception as e:  # a failed case must not end the sweep
            m = {"model": model, "quaternion": qmode or "none",
                 "substeps": ss, "integration": integ, "error": repr(e)}
        rows.append(m)
        print(json.dumps(m), flush=True)

    for tmode in time_modes:
        try:
            m = run_time_mode_case(config, time_mode=tmode,
                                   solver_config=solver_config,
                                   device=device)
        except Exception as e:
            m = {"time": tmode, "error": repr(e)}
        rows.append(m)
        print(json.dumps(m), flush=True)
    return rows


def time_mode_course(config: TrajectoryConfig) -> TrajectoryConfig:
    """The short two-waypoint course every time-axis row solves."""
    init = np.asarray(config.waypoints.initial_state)
    return TrajectoryConfig.from_dict({
        "waypoints": {
            "waypoints": [list(init[:3] + [120.0, 10.0, 5.0]),
                          list(init[:3] + [240.0, -10.0, 10.0])],
            "initial_state": list(init),
            "default_velocity": 45,
            "waypoint_indices": [0, 1, 2],
            "waypoint_tolerance": 10.0,
        },
        "aircraft": config.aircraft.__dict__,
        "state": config.state.__dict__,
        "control": {
            "aileron_limit": list(config.control.aileron),
            "elevator_limit": list(config.control.elevator),
            "rudder_limit": list(config.control.rudder),
            "throttle_limit": [list(t) for t in config.control.throttle],
            "centre_of_mass_limit": [list(c)
                                     for c in config.control.centre_of_mass],
        },
    })


def run_time_mode_case(config: TrajectoryConfig, *, time_mode: str,
                       num_nodes: int = 70, dt: float = 0.1,
                       substeps: int = 10,
                       solver_config: Optional[SolverConfig] = None,
                       device="cuda") -> dict:
    """One free-time case (time ∈ {fixed, progress, variable, adaptive})
    on the short two-waypoint course; success is passage of every
    waypoint within the course's tolerance."""
    from aircraft_tpu_torch.control import waypoints as wp

    dev = resolve_device(device)
    solver_config = solver_config or SolverConfig(max_al_iters=5,
                                                  max_inner_iters=15)
    params = AircraftParams.from_config(config.aircraft, device=dev)
    small = time_mode_course(config)
    _sync(dev)
    t0 = time.time()
    probe_report: dict = {}
    sol = wp.solve_waypoint_racing(
        params, small, num_nodes=num_nodes, dt=dt, substeps=substeps,
        time_mode=time_mode, solver_config=solver_config,
        report_out=probe_report, device=dev)
    _sync(dev)
    wall = time.time() - t0
    m = solver_metrics(sol, wall)
    xs = sol.xs.detach().cpu().numpy()
    misses = [float(np.linalg.norm(xs[:, :3] - w, axis=1).min())
              for w in np.asarray(small.waypoints.array())]
    tol = float(small.waypoints.tolerance)
    passed = bool(max(misses) < tol)
    # flight time from the solution's own timestep schedule: free-time
    # modes carry ν in the last control column ('progress': dt = 1/ν²,
    # the others dt = ν²)
    if time_mode == "fixed":
        flight_time = num_nodes * dt
    else:
        nu = sol.us.detach().cpu().numpy()[:, -1]
        dts = (1.0 / (nu ** 2 + 1e-9)) if time_mode == "progress" else nu ** 2
        flight_time = float(dts.sum())
    m.update(
        time=time_mode, num_nodes=num_nodes,
        waypoint_misses=[round(x, 2) for x in misses],
        passed=passed,
        flight_time_s=round(flight_time, 3),
        nominal_time_s=round(num_nodes * dt, 3),
        time_saved_s=round(num_nodes * dt - flight_time, 3),
        wall_s=round(wall, 2),
    )
    # passage, not the AL residual: complementarity rows carry
    # squared-distance scale
    m["success_rate"] = float(passed)
    m["passed_criterion"] = f"max_waypoint_miss < {tol} m"
    m["al_residual_converged"] = bool(m.get("primal_inf", np.inf) < 0.1)
    if probe_report:
        m["free_time_probes"] = probe_report
    return m


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="small grid")
    ap.add_argument("--out", default=None)
    ap.add_argument("--models", default=None,
                    help="comma-separated subset of the model axis")
    ap.add_argument("--time-only", action="store_true",
                    help="run only the free-time-mode rows")
    ap.add_argument("--merge", action="store_true",
                    help="merge partial_*.json in --out into summary.json")
    ap.add_argument("--trim-start", action="store_true",
                    help="start each case from the model's own trim state "
                         "(recorded per row as start='trim')")
    ap.add_argument("--ref-moments", action="store_true",
                    help="reference moment convention (coefficients about "
                         "the CoM, no aero-centre arm; recorded per row)")
    ap.add_argument("--substeps", default=None,
                    help="comma-separated subset of the substeps axis")
    ap.add_argument("--integrations", default=None,
                    help="comma-separated subset of the integration axis")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.merge:
        rows = []
        for p in sorted(Path(args.out).glob("partial_*.json")):
            rows.extend(json.loads(p.read_text()))
        summary = Path(args.out) / "summary.json"
        summary.write_text(json.dumps(rows, indent=1))
        print(f"merged {len(rows)} rows -> {summary}")
        return
    if args.quick:
        rows = run_ablation(
            models=("default",), quaternion_modes=("integration", ""),
            substeps_grid=(1, 5), integration_modes=("explicit", "implicit"),
            time_modes=("fixed", "progress"),
            num_nodes=20, dt=0.05, out_dir=args.out,
            solver_config=SolverConfig(max_al_iters=2, max_inner_iters=8),
            device=args.device)
        tag = "quick"
    elif args.time_only:
        rows = run_ablation(models=(), quaternion_modes=(),
                            substeps_grid=(), integration_modes=(),
                            time_modes=TIME_MODES, out_dir=args.out,
                            device=args.device)
        tag = "time"
    else:
        models = tuple(args.models.split(",")) if args.models else MODELS
        substeps = (tuple(int(v) for v in args.substeps.split(","))
                    if args.substeps else SUBSTEPS)
        integrations = (tuple(args.integrations.split(","))
                        if args.integrations else INTEGRATION_MODES)
        rows = run_ablation(
            models=models, substeps_grid=substeps,
            integration_modes=integrations, time_modes=(), out_dir=args.out,
            start="trim" if args.trim_start else "level",
            ref_moments=args.ref_moments, device=args.device)
        tag = "_".join(models) + ("_refmom" if args.ref_moments else "")
        if args.substeps or args.integrations:
            # a shard of the grid gets a partial of its own
            tag += "_ss" + "-".join(map(str, substeps)) + "_" + "-".join(
                integrations)
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        part = Path(args.out) / f"partial_{tag}.json"
        part.write_text(json.dumps(rows, indent=1))
        print(f"wrote {part}")


if __name__ == "__main__":
    main()
