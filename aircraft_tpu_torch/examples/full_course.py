"""Fly the glider problem's whole there-and-back waypoint course closed
loop, within its declared 10 m xy tolerance.

``control/course.py::solve_full_course`` on ``data/glider/problem_definition.json``
(or ``PROBLEM_JSON``): trim, the Dubins glide track, receding-horizon
MHTT windows (on the card the window kernels, 6 warm starts per window
as one batch), the waypoint misses.  The environment knobs are the
reference example's:

* ``PROBLEM_JSON``: the problem file;
* ``COURSE_DUAL_CARRY=0``: fly without the gated dual carry (on by
  default);
* ``COURSE_INNER`` (and ``COURSE_AL``, default 4): the window solve's
  inner (and AL) budget, Gauss-Newton; unset, the course's own.

    python -m aircraft_tpu_torch.examples.full_course [--device cuda]
        [--max-windows 400] [--out build/aircraft_tpu_torch]

Writes the trajectory (npz) and, where matplotlib is installed, its
dashboard under ``<out>/visualisation/``, and the run's report (the
reference example's keys, plus the kernels' launch counts) as
``<out>/runs/course_<cuda|cpu>[_carry][_i<inner>].json``.  The exit code
is 1 when a waypoint is missed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
DEFAULT_OUT = ROOT / "build" / "aircraft_tpu_torch"
DT = 0.05           # the course's window step
COMMIT_BUDGET_S = 0.5


def knobs() -> dict:
    """The environment knobs, read."""
    inner = os.environ.get("COURSE_INNER")
    return {"problem": os.environ.get(
                "PROBLEM_JSON", str(ROOT / "data" / "glider"
                                    / "problem_definition.json")),
            "dual_carry": os.environ.get("COURSE_DUAL_CARRY", "1") == "1",
            "inner": int(inner) if inner else None,
            "al": int(os.environ.get("COURSE_AL", "4"))}


def run(*, max_windows: int = 400, device="cuda", verbose: bool = True):
    """(report, flight): the flight of ``solve_full_course`` under the
    environment knobs and its report."""
    import torch

    from aircraft_tpu_torch.bench import _card, kernel_launches
    from aircraft_tpu_torch.config import SolverConfig, TrajectoryConfig
    from aircraft_tpu_torch.control.course import solve_full_course
    from aircraft_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    k = knobs()
    cfg = TrajectoryConfig.from_json(k["problem"])
    solver_config = None
    if k["inner"] is not None:
        solver_config = SolverConfig(max_al_iters=k["al"],
                                     max_inner_iters=k["inner"],
                                     hessian="gauss_newton")
    before = kernel_launches()
    t0 = time.perf_counter()
    out = solve_full_course(cfg, verbose=verbose, dual_carry=k["dual_carry"],
                            solver_config=solver_config,
                            max_windows=max_windows, device=dev)
    wall = time.perf_counter() - t0
    after = kernel_launches()
    states = out["states"]
    rnd = lambda v, d: None if v is None else round(v, d)
    report = {
        "experiment": "full_course",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "card": _card(dev),
        "dual_carry": k["dual_carry"],
        "misses_m": [round(m, 2) for m in out["misses"]],
        "tolerance_m": out["tolerance"],
        "success": out["success"],
        "mpc_healthy": out["mpc_healthy"],
        "windows": out["windows"],
        "abort_reason": out["abort_reason"],
        "retries": out["retries"],
        "simulated_s": round(states.shape[0] * DT, 1),
        "wall_s": round(wall, 1),
        "first_window_wall_s": rnd(out["first_window_wall_s"], 2),
        "p50_window_wall_s": rnd(out["p50_window_wall_s"], 4),
        "p90_window_wall_s": rnd(out["p90_window_wall_s"], 4),
        "commit_budget_s": COMMIT_BUDGET_S,
        # the port keeps no compile cache between runs
        "compile_cache_entries_at_start": 0,
        "speed_range_ms": [round(s, 1) for s in out["speed_range"]],
        "final_altitude_m": round(out["final_altitude"], 1),
        "max_windows": max_windows,
        "solver": (None if solver_config is None
                   else {"al": k["al"], "inner": k["inner"]}),
        "kernel_launches": {name: after[name] - before[name]
                            for name in after},
    }
    return report, out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--max-windows", type=int, default=400)
    p.add_argument("--out", default=str(DEFAULT_OUT))
    a = p.parse_args(argv)

    from aircraft_tpu_torch.config import TrajectoryConfig
    from aircraft_tpu_torch.plotting import TrajectoryPlotter
    from aircraft_tpu_torch.utils import TrajectoryData, missing_packages

    k = knobs()
    cfg = TrajectoryConfig.from_json(k["problem"])
    wps = np.asarray(cfg.waypoints.array())
    print(f"course: {len(wps)} waypoints, tolerance "
          f"{cfg.waypoints.tolerance} m over dims "
          f"{list(cfg.waypoints.waypoint_indices)}", file=sys.stderr)
    report, out = run(max_windows=a.max_windows, device=a.device)
    states = out["states"]
    for j, m in enumerate(out["misses"]):
        ok = "PASS" if m < out["tolerance"] else "MISS"
        print(f"  wp{j} {wps[j][:2]}: closest approach {m:.1f} m  [{ok}]",
              file=sys.stderr)

    root = Path(a.out)
    visu, runs = root / "visualisation", root / "runs"
    visu.mkdir(parents=True, exist_ok=True)
    runs.mkdir(parents=True, exist_ok=True)
    data = TrajectoryData(state=states[:, :13],
                          control=out["controls"][:, :7])
    data.save_npz(visu / "full_course.npz")
    if missing_packages("matplotlib"):
        print("not installed here: matplotlib; skipped the dashboard",
              file=sys.stderr)
    else:
        TrajectoryPlotter(waypoints=wps, dt=DT, device=a.device).save(
            data, visu / "full_course.png")
    tag = ("course_" + ("cuda" if report["device"] != "cpu" else "cpu")
           + ("_carry" if report["dual_carry"] else "")
           + (f"_i{k['inner']}" if k["inner"] is not None else ""))
    path = runs / f"{tag}.json"
    path.write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    print(f"saved {path}", file=sys.stderr)
    return 0 if out["success"] else 1


if __name__ == "__main__":
    sys.exit(main())
