"""Free-time point-to-point on the quadrotor: the time the time axis buys.

A goal reachable in about 3 s is solved at a deliberately slack 6 s
nominal schedule (N=60, dt 0.1); the ladder of fixed uniform time steps
(scales 0.5-1.0 of the nominal) finds the fastest feasible schedule, and
the per-knot free-time formulation refines it
(``control.quadrotor.solve_quadrotor_time_optimal``, 6 AL rounds x 25
inner iterations, Gauss-Newton).

    python -m aircraft_tpu_torch.examples.time_optimal_quad [--cuda-chol]
        [--device cuda] [--out build/aircraft_tpu_torch/quad_time_optimal.json]

``--cuda-chol`` puts every solve's Quu solves on the batched-Cholesky
kernel (one m = 4 system per knot in the ladder, m = 5 in the free-time
solves); the record counts its launches and fallbacks.  ``--num-nodes``,
``--al-iters`` and ``--inner-iters`` cut it down.  Writes the record
(``device`` holding the card's name and power limit) to ``--out`` and
prints it; the exit code is 1 when no time was bought.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

DEFAULT_OUT = (Path(__file__).resolve().parents[2] / "build"
               / "aircraft_tpu_torch" / "quad_time_optimal.json")
TARGET = [30.0, 20.0, -15.0]


def run(*, num_nodes=60, al_iters=6, inner_iters=25, cuda_chol=False,
        device="cuda") -> dict:
    from aircraft_tpu_torch.bench import _card, kernel_launches
    from aircraft_tpu_torch.config import SolverConfig
    from aircraft_tpu_torch.control.quadrotor import (
        solve_quadrotor_time_optimal)
    from aircraft_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    cfg = SolverConfig(max_al_iters=al_iters, max_inner_iters=inner_iters,
                       hessian="gauss_newton")
    t0 = time.perf_counter()
    out = solve_quadrotor_time_optimal(TARGET, num_nodes=num_nodes,
                                       solver_config=cfg, cuda_chol=cuda_chol,
                                       device=dev)
    wall = time.perf_counter() - t0
    saved = out["T_nominal"] - out["T_final"]
    return {
        "experiment": "quad_time_optimal",
        "device": _card(dev),
        "target": TARGET,
        "num_nodes": num_nodes,
        "solver": {"al": al_iters, "inner": inner_iters},
        "cuda_chol": cuda_chol,
        "T_nominal_s": out["T_nominal"],
        "T_uniform_s": out["T_uniform"],
        "T_variable_s": out["T_variable"],
        "variable_accepted": out["variable_accepted"],
        "T_variable_from_nominal_s": out.get("T_variable_from_nominal"),
        "T_final_s": out["T_final"],
        "time_saved_s": round(saved, 3),
        "miss_final_m": out["miss_uniform"],
        "candidates": out["candidates"],
        "wall_s": round(wall, 1),
        "kernel_launches": kernel_launches(),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--cuda-chol", action="store_true",
                   help="Quu solves on the batched-Cholesky kernel")
    p.add_argument("--out", default=str(DEFAULT_OUT))
    p.add_argument("--num-nodes", type=int, default=60)
    p.add_argument("--al-iters", type=int, default=6)
    p.add_argument("--inner-iters", type=int, default=25)
    a = p.parse_args(argv)
    rec = run(num_nodes=a.num_nodes, al_iters=a.al_iters,
              inner_iters=a.inner_iters, cuda_chol=a.cuda_chol,
              device=a.device)
    for r in rec["candidates"]:
        print(f"  dt={r['dt']:.3f}  T={r['T']:.2f}s  miss={r['miss']:.4f} m "
              f"defect={r['defect']:.1e}  "
              f"{'FEASIBLE' if r['feasible'] else 'infeasible'}",
              file=sys.stderr)
    path = Path(a.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec))
    print(f"wrote {path}", file=sys.stderr)
    return 0 if rec["time_saved_s"] > 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
