"""Static-dt probe ladder on the glider's short two-waypoint course: the
time-optimal sweep (``waypoints.solve_time_optimal``) over uniformly
contracted schedules, each candidate warm-started from the solved nominal
racing solution and defect-gated, with the waypoint miss, the rollout
defect and the failure mode recorded per scale.

    python -m aircraft_tpu_torch.examples.glider_time_probe [--cuda-chol]
        [--device cuda] [--out build/aircraft_tpu_torch/glider_time_probe.json]

The course, N=70, dt=0.1, 10 substeps, 8 candidates over 0.6-0.95 of the
nominal schedule, 6 AL rounds x 20 inner iterations, as the reference's
``examples/glider_time_probe.py``; ``--num-nodes``, ``--substeps``,
``--candidates``, ``--al-iters`` and ``--inner-iters`` cut it down.
``--cuda-chol`` puts the candidate sweep's Riccati solves on the
batched-Cholesky kernel; the record counts its launches and fallbacks
(``kernel_launches``).  Writes the record (the reference's keys,
``device`` holding the card's name and power limit) to ``--out`` and
prints it without the ladder; each ladder row goes to stderr as it is
made.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from aircraft_tpu_torch.config import SolverConfig, TrajectoryConfig

DEFAULT_OUT = (Path(__file__).resolve().parents[2] / "build"
               / "aircraft_tpu_torch" / "glider_time_probe.json")

SHORT_COURSE = {
    "waypoints": {
        "waypoints": [[120.0, 10.0, -195.0], [240.0, -10.0, -190.0]],
        "initial_state": [0, 0, -200, 50, 0, 0, 0, 0, 0, 1, 0, 0, 0],
        "default_velocity": 45,
        "waypoint_indices": [0, 1, 2],
        "waypoint_tolerance": 10.0,
    },
    "aircraft": dict(
        mass=4.0, span=2.0, length=1.2, chord=0.124605,
        reference_area=0.238, aero_centre_offset=[0.133, 0, 0.003],
        Ixx=0.155, Iyy=0.114, Izz=0.262, Ixz=0.01,
        glide_ratio=3.0, r_min=1.0,
    ),
    "state": {"alpha": [-15, 15], "beta": [-15, 15], "airspeed": [30, 100]},
    "control": {
        "aileron_limit": [-10, 10],
        "elevator_limit": [-10, 10],
        "rudder_limit": [-10, 10],
        "throttle_limit": [[0, 0, 0], [0, 0, 0]],
        "centre_of_mass_limit": [[-0.5, -0.1, -0.1], [0.5, 0.1, 0.1]],
    },
}


def short_course_config() -> TrajectoryConfig:
    """The two-waypoint short course the reference's controller tests
    solve."""
    return TrajectoryConfig.from_dict(SHORT_COURSE)


def run_probe_ladder(*, num_nodes: int = 70, dt: float = 0.1,
                     substeps: int = 10, n_candidates: int = 8,
                     al_iters: int = 6, inner_iters: int = 20,
                     cuda_chol: bool = False, device="cuda") -> dict:
    from aircraft_tpu_torch.bench import _card, kernel_launches
    from aircraft_tpu_torch.control import waypoints as wp
    from aircraft_tpu_torch.device import resolve_device
    from aircraft_tpu_torch.dynamics.aircraft import AircraftParams

    dev = resolve_device(device)
    course = short_course_config()
    params = AircraftParams.from_config(course.aircraft, device=dev)
    solver_config = SolverConfig(max_al_iters=al_iters,
                                 max_inner_iters=inner_iters)
    tol = float(course.waypoints.tolerance)
    t0 = time.perf_counter()
    res = wp.solve_time_optimal(
        params, course, num_nodes=num_nodes, dt_nominal=dt,
        substeps=substeps, n_candidates=n_candidates, dt_span=(0.6, 0.95),
        solver_config=solver_config, cuda_chol=cuda_chol, device=dev)
    wall = time.perf_counter() - t0
    rows = []
    for i in range(len(res["candidate_dts"])):
        dt_i = float(res["candidate_dts"][i])
        miss = float(np.max(res["dmins"][i]))
        defect = float(res["defects"][i])
        feas = bool(res["feasible"][i])
        rows.append({
            "scale": round(dt_i / dt, 4),
            "dt": round(dt_i, 5),
            "total_time_s": round(dt_i * num_nodes, 3),
            "max_waypoint_miss_m": round(miss, 2),
            "rollout_defect": (round(defect, 6) if np.isfinite(defect)
                               else "nan"),
            "feasible": feas,
            "failure_mode": (None if feas else
                             ("miss" if (miss > tol and defect < 1e-2)
                              else "defect_gate")),
        })
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    feasible_scales = [r["scale"] for r in rows if r["feasible"]]
    sub = [r for r in rows if r["scale"] < 0.999]
    return {
        "metric": "glider_static_dt_probe_min_feasible_scale",
        "value": (min(feasible_scales) if feasible_scales else None),
        "unit": "fraction_of_nominal_schedule",
        "course": "short two-waypoint course (tests short_course_config)",
        "num_nodes": num_nodes,
        "dt_nominal": dt,
        "substeps": substeps,
        "tolerance_m": tol,
        "selected_total_time_s": round(float(res["total_time"]), 3),
        "nominal_total_time_s": round(num_nodes * dt, 3),
        "n_subnominal_feasible": sum(r["feasible"] for r in sub),
        "sweep_wall_s": round(wall, 1),
        "solver": {"al": solver_config.max_al_iters,
                   "inner": solver_config.max_inner_iters},
        "ladder": rows,
        "device": _card(dev),
        "cuda_chol": cuda_chol,
        "kernel_launches": kernel_launches(),
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--cuda-chol", action="store_true",
                   help="the candidate sweep's Quu solves on the "
                   "batched-Cholesky kernel")
    p.add_argument("--out", default=str(DEFAULT_OUT))
    p.add_argument("--num-nodes", type=int, default=70)
    p.add_argument("--substeps", type=int, default=10)
    p.add_argument("--candidates", type=int, default=8)
    p.add_argument("--al-iters", type=int, default=6)
    p.add_argument("--inner-iters", type=int, default=20)
    a = p.parse_args(argv)
    out = run_probe_ladder(num_nodes=a.num_nodes, substeps=a.substeps,
                           n_candidates=a.candidates, al_iters=a.al_iters,
                           inner_iters=a.inner_iters, cuda_chol=a.cuda_chol,
                           device=a.device)
    path = Path(a.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(json.dumps({k: v for k, v in out.items() if k != "ladder"}))
    print(f"wrote {path}", file=sys.stderr)


if __name__ == "__main__":
    main()
