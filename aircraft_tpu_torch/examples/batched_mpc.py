"""Batched MPC serving: a fleet of receding-horizon controllers replanning
in lockstep on one card, or sharded over several.

The port of the reference's ``examples/batched_mpc.py``: a fleet of
gliders (the default aero model), each starting from the configured
initial state plus 0.5 x N(0, 1) x per-component scales (drawn from
``torch.Generator(0)``), flies ``MHTT.run_batch`` windows of N=25 knots
at dt=0.02 with 15 knots of overlap, 2 RK4 substeps, 2 AL rounds x 10
inner iterations of Gauss-Newton: on the two window kernels on the card,
on ``ilqr.solve_batch`` on the CPU.  ``--al-iters`` and ``--inner-iters``
cut the budget down.

    python -m aircraft_tpu_torch.examples.batched_mpc --batch 64
    python -m aircraft_tpu_torch.examples.batched_mpc --batch 1024 --mesh
    python -m aircraft_tpu_torch.examples.batched_mpc --device cpu \\
        --batch 4 --windows 1 --mesh --ranks 2

``--mesh`` shards the fleet over ``--ranks`` processes (``parallel.spawn``:
every visible card on ``cuda``, one rank per card over NCCL; gloo
processes on ``cpu``, where ``--ranks`` is required).  Each rank runs
``run_batch`` on its block and stops when its own block reaches the
progress target; rank 0 gathers the progress and prints.  With one card
``--mesh`` runs unsharded and says so.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from aircraft_tpu_torch.config import SolverConfig, glider_config
from aircraft_tpu_torch.device import resolve_device

# per-component scales of the start states' noise (position, velocity,
# quaternion, body rates)
START_SCALES = (1, 1, 1, 1, 1, 1, 0.01, 0.01, 0.01, 0.01, 0.02, 0.02, 0.02)
PROGRESS_TARGET = 0.95


def fleet_mhtt(device="cuda", al_iters=2, inner_iters=10):
    """The example's MHTT on ``device``: (mhtt, config)."""
    from aircraft_tpu_torch.control.initialisation import DubinsInitialiser
    from aircraft_tpu_torch.control.mhtt import MHTT
    from aircraft_tpu_torch.dynamics.aircraft import AircraftParams

    dev = resolve_device(device)
    cfg = glider_config()
    params = AircraftParams.from_config(cfg.aircraft, device=dev)
    mhtt = MHTT(params, cfg, DubinsInitialiser(cfg), num_nodes=25, dt=0.02,
                overlap=15, substeps=2, device=dev,
                solver_config=SolverConfig(max_al_iters=al_iters,
                                           max_inner_iters=inner_iters,
                                           hessian="gauss_newton"))
    return mhtt, cfg


def start_states(cfg, batch: int) -> torch.Tensor:
    """(B, 13) on the CPU: the initial state plus 0.5 N(0, 1) x
    ``START_SCALES``, from ``torch.Generator(0)``."""
    gen = torch.Generator().manual_seed(0)
    x0 = torch.tensor(cfg.waypoints.initial_state, dtype=torch.float32)
    return x0 + 0.5 * torch.randn((batch, 13), generator=gen) * torch.tensor(
        START_SCALES, dtype=torch.float32)


def run_fleet(batch=64, windows=5, device="cuda", al_iters=2,
              inner_iters=10) -> dict:
    """One fleet on one device: ``run_batch``'s result with its wall."""
    mhtt, cfg = fleet_mhtt(device, al_iters, inner_iters)
    x0s = start_states(cfg, batch).to(mhtt.device)
    t0 = time.time()
    out = mhtt.run_batch(x0s, max_windows=windows,
                         progress_target=PROGRESS_TARGET)
    return {"batch": batch, "windows": out["windows"],
            "solves": batch * out["windows"], "progress": out["progress"],
            "success_rate": out["success_rate"], "wall": time.time() - t0}


def fleet_rank(mesh, batch: int, windows: int, al_iters=2,
               inner_iters=10) -> dict:
    """One rank's block of the fleet (``parallel.spawn``); the progress
    and the solve count are gathered over the ranks."""
    from aircraft_tpu_torch.parallel import gather_batch, shard_batch

    mhtt, cfg = fleet_mhtt(mesh.device, al_iters, inner_iters)
    x0s = shard_batch(start_states(cfg, batch), mesh)
    t0 = time.time()
    out = mhtt.run_batch(x0s, max_windows=windows,
                         progress_target=PROGRESS_TARGET)
    s = torch.as_tensor(out["progress"], device=mesh.device)
    w = torch.full((1,), out["windows"], dtype=torch.int64,
                   device=mesh.device)
    s_all, w_all = gather_batch((s, w), mesh)
    s_all = s_all.cpu().numpy()
    w_all = w_all.cpu()
    return {"batch": batch, "windows": int(w_all.max()),
            "solves": int((w_all * x0s.shape[0]).sum()), "progress": s_all,
            "success_rate": float(np.mean(s_all >= PROGRESS_TARGET)),
            "wall": time.time() - t0, "ranks": mesh.size}


def report(r: dict) -> None:
    print(f"fleet of {r['batch']}: {r['windows']} replan rounds, "
          f"{r['solves']} window solves in {r['wall']:.1f}s "
          f"({r['solves'] / r['wall']:.0f} solves/s incl. compile)")
    print(f"median progress {np.median(r['progress']):.3f}, "
          f"success rate {r['success_rate']:.2f}")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--windows", type=int, default=5)
    p.add_argument("--mesh", action="store_true",
                   help="shard the batch over --ranks processes (every "
                   "visible card on cuda)")
    p.add_argument("--ranks", type=int, default=None,
                   help="ranks of --mesh (required on cpu)")
    p.add_argument("--al-iters", type=int, default=2)
    p.add_argument("--inner-iters", type=int, default=10)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    ranks = a.ranks
    if a.mesh and ranks is None:
        if dev.type != "cuda":
            p.error("--mesh on cpu needs --ranks")
        ranks = torch.cuda.device_count()
    if a.mesh and ranks > 1:
        # the ranks find fleet_rank by its import path, also when this file
        # runs as __main__
        from aircraft_tpu_torch.examples import batched_mpc
        from aircraft_tpu_torch.parallel import spawn

        print(f"sharding batch {a.batch} over {ranks} {dev.type} ranks")
        r = spawn(batched_mpc.fleet_rank, ranks, device=dev,
                  args=(a.batch, a.windows, a.al_iters, a.inner_iters))[0]
    else:
        if a.mesh:
            print(f"one {dev.type} rank: the batch of {a.batch} runs "
                  "unsharded")
        r = run_fleet(a.batch, a.windows, dev, a.al_iters, a.inner_iters)
    report(r)
    return r


if __name__ == "__main__":
    main()
