"""End to end on a compact two-waypoint course: trim, stability, waypoint
racing, the dashboard.

The glider is trimmed at 45 m/s (``multistart_trim``, 64 starts from a
generator seeded 0) and its continuous-time modes printed
(``stability_eigenvalues``); then ``solve_waypoint_racing`` flies the
two waypoints of ``CFG`` at N=70, dt 0.1, 10 substeps, 6 AL x 20 inner
iterations (the tracking warm start at its own 1 x 30), and each
waypoint's closest approach is reported.

    python -m aircraft_tpu_torch.examples.waypoint_racing [--device cuda]
        [--cuda-chol] [--num-nodes 70] [--al-iters 6] [--inner-iters 20]
        [--warm-iters AL,INNER] [--out build/aircraft_tpu_torch/visualisation]

``--cuda-chol`` puts the racing solve's Quu solves on the
batched-Cholesky kernel (one system per knot, m = 9: the seven
controls and a progress impulse per waypoint; N launches per backward
pass); the record counts its launches and fallbacks.  ``run``
returns the record and arrays; ``main`` writes the record
(``waypoint_racing.json``), the trajectory (npz) and, where matplotlib
is installed, the dashboard.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from aircraft_tpu_torch.config import GLIDER_PROBLEM, TrajectoryConfig

DEFAULT_OUT = (Path(__file__).resolve().parents[2] / "build"
               / "aircraft_tpu_torch" / "visualisation")

# a compact two-waypoint course (the full there-and-back problem of
# data/glider/problem_definition.json needs a longer horizon)
CFG = TrajectoryConfig.from_dict({
    "waypoints": {
        "waypoints": [[120.0, 10.0, -195.0], [240.0, -10.0, -190.0]],
        "initial_state": [0, 0, -200, 50, 0, 0, 0, 0, 0, 1, 0, 0, 0],
        "default_velocity": 45,
        "waypoint_indices": [0, 1, 2],
        "waypoint_tolerance": 10.0,
    },
    "aircraft": GLIDER_PROBLEM["aircraft"],
    "state": {"alpha": [-15, 15], "beta": [-15, 15], "airspeed": [30, 100]},
    "control": {
        "aileron_limit": [-10, 10],
        "elevator_limit": [-10, 10],
        "rudder_limit": [-10, 10],
        "throttle_limit": [[0, 0, 0], [0, 0, 0]],
        "centre_of_mass_limit": [[-0.5, -0.1, -0.1], [0.5, 0.1, 0.1]],
    },
})


def run(*, num_nodes=70, dt=0.1, substeps=10, al_iters=6, inner_iters=20,
        warm_iters=None, cuda_chol=False, device="cuda"):
    """(record, arrays): the trim, its spectrum, the racing solve and each
    waypoint's closest approach; ``warm_iters`` (AL, inner) replaces the
    tracking warm start's 1 x 30."""
    import torch

    from aircraft_tpu_torch.bench import _card, kernel_launches
    from aircraft_tpu_torch.config import SolverConfig
    from aircraft_tpu_torch.control import waypoints as wp
    from aircraft_tpu_torch.device import resolve_device
    from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
    from aircraft_tpu_torch.kernels import cholesky
    from aircraft_tpu_torch.solvers import riccati
    from aircraft_tpu_torch.solvers.trim import (multistart_trim,
                                                 stability_eigenvalues)

    dev = resolve_device(device)
    params = AircraftParams.from_config(CFG.aircraft, device=dev)
    t0 = time.perf_counter()
    trim = multistart_trim(params, n_starts=64, target_airspeed=45.0,
                           generator=torch.Generator().manual_seed(0))
    trim_s = time.perf_counter() - t0
    eig = stability_eigenvalues(params, trim.state, trim.control)

    warm = (None if warm_iters is None else SolverConfig(
        max_al_iters=warm_iters[0], max_inner_iters=warm_iters[1]))
    launches0 = cholesky.batched_cholesky_solve.launches
    fallbacks0 = riccati.read_fallbacks()
    t0 = time.perf_counter()
    sol = wp.solve_waypoint_racing(
        params, CFG, num_nodes=num_nodes, dt=dt, substeps=substeps,
        solver_config=SolverConfig(max_al_iters=al_iters,
                                   max_inner_iters=inner_iters),
        warm_start_config=warm, cuda_chol=cuda_chol, device=dev)
    xs = sol.xs.cpu().numpy()
    solve_s = time.perf_counter() - t0
    approaches = []
    for w in CFG.waypoints.array():
        d = np.linalg.norm(xs[:, :3] - w, axis=1)
        approaches.append({"closest_m": float(d.min()),
                           "node": int(d.argmin())})
    rec = {
        "experiment": "waypoint_racing",
        "device": _card(dev),
        "num_nodes": num_nodes, "dt": dt, "substeps": substeps,
        "solver": {"al": al_iters, "inner": inner_iters},
        "warm_start": list(warm_iters) if warm_iters else [1, 30],
        "cuda_chol": cuda_chol,
        "trim_residual": float(trim.residual),
        "trim_elevator": float(trim.control[1]),
        "trim_s": trim_s,
        "max_real_eig": float(np.max(eig.real)),
        "cost": float(sol.cost), "violation": float(sol.violation),
        "iterations": int(sol.iterations),
        "finite": bool(np.isfinite(xs).all()),
        "closest_approaches": approaches,
        "tolerance_m": float(CFG.waypoints.tolerance),
        "solve_s": solve_s,
        "cholesky_launches": (cholesky.batched_cholesky_solve.launches
                              - launches0),
        "chol_fallbacks": riccati.read_fallbacks() - fallbacks0,
        "kernel_launches": kernel_launches(),
    }
    return rec, {"xs": xs, "us": sol.us.cpu().numpy(), "trim": trim,
                 "eigenvalues": eig}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--cuda-chol", action="store_true",
                   help="the racing solve's Quu solves on the "
                        "batched-Cholesky kernel")
    p.add_argument("--num-nodes", type=int, default=70)
    p.add_argument("--al-iters", type=int, default=6)
    p.add_argument("--inner-iters", type=int, default=20)
    p.add_argument("--warm-iters", default=None,
                   help="AL,INNER of the tracking warm start (1,30)")
    p.add_argument("--out", default=str(DEFAULT_OUT))
    a = p.parse_args(argv)

    from aircraft_tpu_torch.plotting import TrajectoryPlotter
    from aircraft_tpu_torch.utils import TrajectoryData, missing_packages

    warm = (None if a.warm_iters is None
            else tuple(int(v) for v in a.warm_iters.split(",")))
    rec, arr = run(num_nodes=a.num_nodes, al_iters=a.al_iters,
                   inner_iters=a.inner_iters, warm_iters=warm,
                   cuda_chol=a.cuda_chol, device=a.device)
    print(f"trim: residual={rec['trim_residual']:.2e} "
          f"elevator={rec['trim_elevator']:.3f} [{rec['trim_s']:.1f}s]",
          file=sys.stderr)
    print(f"stability: max Re(eig) = {rec['max_real_eig']:.3f}",
          file=sys.stderr)
    for j, r in enumerate(rec["closest_approaches"]):
        print(f"  wp{j}: closest approach {r['closest_m']:.1f} m at node "
              f"{r['node']} (tolerance {rec['tolerance_m']})",
              file=sys.stderr)
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    stem = "waypoint_racing" + ("_cuda_chol" if a.cuda_chol else "")
    xs = arr["xs"]
    data = TrajectoryData(state=xs[:, :13], control=arr["us"][:, :7],
                          lam=xs[:, 13:])
    data.save_npz(out / f"{stem}.npz")
    if missing_packages("matplotlib"):
        print("not installed here: matplotlib; skipped the dashboard",
              file=sys.stderr)
    else:
        TrajectoryPlotter(waypoints=CFG.waypoints.array(), dt=0.1,
                          device=a.device).save(data, out / f"{stem}.png")
    (out / f"{stem}.json").write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
