"""Open-loop simulation of the glider under a bang-bang roll script.

The default-aero glider is trimmed at 50 m/s (``multistart_trim``, 64
starts from a generator seeded 0); the trim controls are flown for 500
steps of dt 0.01 (RK4, 5 substeps, the quaternion renormalised each
step) from the problem's initial state, with +2 on the aileron over
steps 100-149 and -2 over 150-199.  The run reports the first non-finite
step and the elevator column of the step's control Jacobian at the
start, and saves the trajectory (HDF5, the reference's layout) and its
dashboard.

    python -m aircraft_tpu_torch.examples.openloop_sim [--device cuda]
        [--steps 500] [--out build/aircraft_tpu_torch/visualisation]

``run`` returns the arrays; ``main`` does the IO.  Where ``h5py`` or
``matplotlib`` is not installed, the file it would write is skipped and
one line says so.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

DT = 0.01
SUBSTEPS = 5
DEFAULT_OUT = (Path(__file__).resolve().parents[2] / "build"
               / "aircraft_tpu_torch" / "visualisation")


def roll_script(u_trim, T: int) -> np.ndarray:
    """(T, 7) controls: the trim, +2 aileron over steps 100-149 and -2
    over 150-199."""
    us = np.tile(np.asarray(u_trim, np.float32)[None, :7], (T, 1))
    us[100:150, 0] += 2.0
    us[150:200, 0] -= 2.0
    return us


def run(*, T: int = 500, u_trim=None, device="cuda") -> dict:
    """The rollout and its diagnostics.  ``u_trim`` (7,) replaces the
    trim search.  Returns xs (T+1, 13), us (T, 7), the trim residual
    (None when given ``u_trim``), the first non-finite step (None when
    every state is finite), the elevator column (13,) of ∂step/∂u at the
    initial state and the walls."""
    import torch

    from aircraft_tpu_torch.config import glider_config
    from aircraft_tpu_torch.device import resolve_device
    from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
    from aircraft_tpu_torch.ops.autodiff import batched_jacfwd
    from aircraft_tpu_torch.solvers import integrators
    from aircraft_tpu_torch.solvers.rollout import rollout
    from aircraft_tpu_torch.solvers.trim import multistart_trim

    dev = resolve_device(device)
    cfg = glider_config()
    params = AircraftParams.from_config(cfg.aircraft, device=dev)
    t0 = time.perf_counter()
    residual = None
    if u_trim is None:
        trim = multistart_trim(params, n_starts=64, target_airspeed=50.0,
                               generator=torch.Generator().manual_seed(0))
        residual = float(trim.residual)
        u_trim = trim.control[:7].cpu().numpy()
    trim_s = time.perf_counter() - t0

    us = roll_script(u_trim, T)
    step = integrators.make_step_fn(params, substeps=SUBSTEPS,
                                    normalize="step")
    x0 = torch.as_tensor(np.asarray(cfg.waypoints.initial_state, np.float32),
                         device=dev)
    us_d = torch.as_tensor(us, device=dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        xs = rollout(step, x0, us_d, DT).cpu().numpy()
    rollout_s = time.perf_counter() - t0
    bad = np.where(~np.isfinite(xs).all(axis=1))[0]
    u_trim = np.array(u_trim, np.float32)[:7]
    B = batched_jacfwd(lambda u: step(x0[None], u, DT),
                       torch.as_tensor(u_trim, device=dev)[None])[0]
    return {"xs": xs, "us": us, "u_trim": u_trim,
            "trim_residual": residual,
            "first_nan": int(bad[0]) if len(bad) else None,
            "elevator_column": B[:, 1].cpu().numpy(),
            "trim_s": trim_s, "rollout_s": rollout_s}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--out", default=str(DEFAULT_OUT))
    a = p.parse_args(argv)

    from aircraft_tpu_torch.plotting import TrajectoryPlotter
    from aircraft_tpu_torch.utils import TrajectoryData, missing_packages

    res = run(T=a.steps, device=a.device)
    xs, us = res["xs"], res["us"]
    print(f"trim residual {res['trim_residual']:.2e}")
    print(f"simulated {a.steps} steps; first NaN: "
          f"{'none' if res['first_nan'] is None else res['first_nan']}")
    print("elevator column of step Jacobian (pos/vel rows):",
          res["elevator_column"][:6].round(5))
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    data = TrajectoryData(state=xs, control=us,
                          time=np.arange(a.steps + 1) * DT)
    written = []
    missing = missing_packages("h5py", "matplotlib")
    if "h5py" not in missing:
        data.save_h5(out / "openloop.h5")
        written.append(str(out / "openloop.h5"))
    if "matplotlib" not in missing:
        TrajectoryPlotter(dt=DT, device=a.device).save(
            data, out / "openloop.png")
        written.append(str(out / "openloop.png"))
    if missing:
        print(f"not installed here: {', '.join(missing)}; skipped "
              "their files")
    print(json.dumps({"experiment": "openloop_sim", "steps": a.steps,
                      "trim_residual": res["trim_residual"],
                      "first_nan": res["first_nan"],
                      "finite": bool(np.isfinite(xs).all()),
                      "trim_s": res["trim_s"], "rollout_s": res["rollout_s"],
                      "written": written}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
