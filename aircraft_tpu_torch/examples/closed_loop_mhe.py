"""Closed-loop MPC with moving-horizon wind estimation.

The receding-horizon tracking controller flies the short two-waypoint
course while a constant wind, unknown to it, pushes the true plant; after
each window the estimator fits the wind to the last measurements
(``control.mhe.estimate_wind``) and the controller's model takes the
estimate through its wind channels, z = [x(13), s, wind(3)].  N=25,
dt 0.02, 2 substeps, 15 knots of overlap, 2 AL rounds x 10 inner
iterations, 8 windows.

    python -m aircraft_tpu_torch.examples.closed_loop_mhe [--cuda-chol]
        [--device cuda] [--windows 8]
        [--out build/aircraft_tpu_torch/closed_loop_mhe.json]

Prints each window's progress and estimate to stderr, writes the record
(``device`` holding the card's name and power limit) to ``--out`` and
prints it; the exit code is 1 when the final estimate misses the wind by
1 m/s or more.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

DEFAULT_OUT = (Path(__file__).resolve().parents[2] / "build"
               / "aircraft_tpu_torch" / "closed_loop_mhe.json")
TRUE_WIND = [4.0, -3.0, 0.0]


def course():
    from aircraft_tpu_torch.config import TrajectoryConfig, glider_config

    base = glider_config()
    return TrajectoryConfig.from_dict({
        "waypoints": {
            "waypoints": [[120.0, 10.0, -195.0], [240.0, -10.0, -190.0]],
            "initial_state": [0, 0, -200, 50, 0, 0, 0, 0, 0, 1, 0, 0, 0],
            "default_velocity": 45,
            "waypoint_indices": [0, 1, 2],
            "waypoint_tolerance": 10.0,
        },
        "aircraft": base.aircraft.__dict__,
        "state": {"alpha": [-15, 15], "beta": [-15, 15],
                  "airspeed": [30, 100]},
        "control": {
            "aileron_limit": [-10, 10],
            "elevator_limit": [-10, 10],
            "rudder_limit": [-10, 10],
            "throttle_limit": [[0, 0, 0], [0, 0, 0]],
            "centre_of_mass_limit": [[-0.5, -0.1, -0.1], [0.5, 0.1, 0.1]],
        },
    })


def run(*, windows=8, cuda_chol=False, device="cuda") -> dict:
    import torch

    from aircraft_tpu_torch.bench import _card, kernel_launches
    from aircraft_tpu_torch.config import SolverConfig
    from aircraft_tpu_torch.control.initialisation import DubinsInitialiser
    from aircraft_tpu_torch.control.mhe import estimate_wind
    from aircraft_tpu_torch.control.mhtt import build_mhtt_ocp
    from aircraft_tpu_torch.device import resolve_device
    from aircraft_tpu_torch.dynamics import aircraft as ac
    from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
    from aircraft_tpu_torch.solvers import ilqr, integrators

    dev = resolve_device(device)
    cfg = course()
    params = AircraftParams.from_config(cfg.aircraft, device=dev)
    true_wind = torch.tensor(TRUE_WIND, device=dev)
    dt, substeps, N, overlap = 0.02, 2, 25, 15
    commit = N - overlap
    true_step = integrators.make_step_fn(
        params, substeps=substeps, normalize="step",
        derivative_fn=lambda x, u: ac.state_derivative(params, x, u,
                                                       wind=true_wind))
    track = DubinsInitialiser(cfg)
    ocp = build_mhtt_ocp(params, cfg, track.track_points.to(dev),
                         track.length(), dt=dt, substeps=substeps,
                         wind_channels=True)
    scfg = SolverConfig(max_al_iters=2, max_inner_iters=10,
                        hessian="gauss_newton")
    x = torch.tensor(cfg.waypoints.initial_state, dtype=torch.float32,
                     device=dev)
    s = torch.zeros(1, device=dev)
    us_warm = torch.zeros((N, 7), device=dev)
    wind_est = torch.zeros(3, device=dev)
    meas_x, meas_u, rows = [x], [], []
    t0 = time.perf_counter()
    for window in range(windows):
        t_w = time.perf_counter()
        sol = ilqr.solve(ocp, torch.cat([x, s, wind_est]), us_warm, scfg,
                         cuda_chol=cuda_chol)
        for k in range(commit):
            meas_u.append(sol.us[k])
            x = true_step(x, sol.us[k], dt)
            meas_x.append(x)
        s = sol.xs[commit, 13:14]
        us_warm = torch.cat([sol.us[commit:],
                             sol.us[-1:].expand(commit, -1)], dim=0)
        W = min(len(meas_u), 20)
        est = estimate_wind(params, torch.stack(meas_x[-(W + 1):]),
                            torch.stack(meas_u[-W:]), dt, substeps, 8,
                            device=dev)
        wind_est = est.wind
        err = float(torch.linalg.norm(wind_est - true_wind))
        rows.append({"window": window, "progress": float(s),
                     "wind_est": wind_est.cpu().numpy().round(4).tolist(),
                     "wind_err_m_s": err,
                     "mhe_residual": float(est.residual),
                     "solve_violation": float(sol.violation),
                     "wall_s": round(time.perf_counter() - t_w, 3)})
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    return {"experiment": "closed_loop_mhe", "device": _card(dev),
            "true_wind": TRUE_WIND, "windows": rows,
            "final_wind_err_m_s": rows[-1]["wind_err_m_s"],
            "wind_identified": rows[-1]["wind_err_m_s"] < 1.0,
            "cuda_chol": cuda_chol,
            "wall_s": round(time.perf_counter() - t0, 2),
            "kernel_launches": kernel_launches()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--cuda-chol", action="store_true",
                   help="the window solves' Quu solves on the "
                   "batched-Cholesky kernel")
    p.add_argument("--windows", type=int, default=8)
    p.add_argument("--out", default=str(DEFAULT_OUT))
    a = p.parse_args(argv)
    rec = run(windows=a.windows, cuda_chol=a.cuda_chol, device=a.device)
    path = Path(a.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1))
    print(json.dumps({k: v for k, v in rec.items() if k != "windows"}))
    print(f"wrote {path}", file=sys.stderr)
    return 0 if rec["wind_identified"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
