"""Entry points of the port: the flagship batched step and the mesh dry run.

    python -m aircraft_tpu_torch.entry [--device cuda] [--ranks N]

``entry()`` returns ``(fn, (x0, us))``: the flagship model's batched
forward step, the glider 6-DoF plant with the MLP aero surrogate under
RK4 at 10 substeps with the quaternion renormalised each step, dt 0.01,
on a batch of 256 copies of the problem's initial state with zero
controls.  Its MLP is drawn from a ``torch.Generator`` seeded 0
(``MLPCoeffParams.init``), or given as numpy arrays (``mlp=``).

``dryrun_multichip(n)`` starts ``n`` ranks (``parallel.spawn``) and runs
the reference's three production steps on a (dp x tp) mesh, tp = 2 when
n is even, else 1, each raising on failure:

1. ``solve_batch_sharded`` of 2n perturbed copies of the initial state
   (N = 6, dt 0.01, one substep, 1 AL x 2 inner iterations), the mean
   cost finite;
2. one tensor-parallel Adam step of the MLP on a batch of 4n
   (``parallel/tensor.py``), the loss finite;
3. the horizon-sharded Riccati sweep (``backward_associative_sharded``,
   horizon 4n, n = 13, m = 7) against the sequential sweep at atol 5e-3,
   its fail flag false.

On ``cuda`` each rank owns one card over NCCL, so a one-card machine runs
``n = 1`` (dp 1 x tp 1); on the CPU the ranks are gloo processes.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

B_FLAGSHIP = 256
DT = 0.01
SUBSTEPS = 10


def flagship(device="cuda", mlp=None):
    """(config, params): the glider problem and its plant with the MLP
    aero surrogate on ``device`` (``mlp``: numpy arrays keyed like
    ``MLP_KEYS``, else drawn from a generator seeded 0)."""
    from aircraft_tpu_torch.config import glider_config
    from aircraft_tpu_torch.device import resolve_device
    from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
    from aircraft_tpu_torch.dynamics.coefficients import (MLPCoeffParams,
                                                          mlp_from_numpy)

    dev = resolve_device(device)
    coeff = (MLPCoeffParams.init(torch.Generator().manual_seed(0),
                                 device=dev)
             if mlp is None else mlp_from_numpy(mlp, device=dev))
    cfg = glider_config()
    return cfg, AircraftParams.from_config(cfg.aircraft, coeff=coeff,
                                           device=dev)


def entry(device="cuda", mlp=None):
    """(fn, (x0, us)): ``fn(x, u)`` is the flagship's batched step over
    dt 0.01; x0 (256, 13), us (256, 7) on ``device``."""
    from aircraft_tpu_torch.solvers import integrators

    cfg, params = flagship(device, mlp)
    step = integrators.make_step_fn(params, substeps=SUBSTEPS,
                                    normalize="step")
    x0 = torch.as_tensor(np.asarray(cfg.waypoints.initial_state, np.float32),
                         device=params.device).expand(B_FLAGSHIP, 13)
    us = torch.zeros((B_FLAGSHIP, 7), dtype=torch.float32,
                     device=params.device)

    def fn(x, u):
        return step(x, u, DT)

    return fn, (x0.contiguous(), us)


def _normal(seed, shape, device):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed),
                       dtype=torch.float32).to(device)


def _sharded_solve(mesh, n_devices):
    """Step 1: the batched window solve with the scenarios split over dp."""
    from aircraft_tpu_torch.config import SolverConfig
    from aircraft_tpu_torch.parallel import solve_batch_sharded
    from aircraft_tpu_torch.solvers import integrators
    from aircraft_tpu_torch.solvers.ocp import OCPFunctions

    dev = mesh.device
    cfg, params = flagship(dev)
    step = integrators.make_step_fn(params, substeps=1, normalize="step")
    N = 6
    goal = torch.tensor([50.0, 0.0, -200.0], device=dev)
    ocp = OCPFunctions(
        step=lambda x, u, k: step(x, u, DT),
        stage_cost=lambda x, u, k: 1e-3 * torch.sum(u[..., :3] ** 2, dim=-1),
        terminal_cost=lambda x: torch.sum((x[..., :3] - goal) ** 2, dim=-1),
        ineq=lambda x, u, k: torch.cat([u[..., :3] - 10.0,
                                        -10.0 - u[..., :3]], dim=-1))
    B = 2 * n_devices
    x0 = torch.as_tensor(np.asarray(cfg.waypoints.initial_state, np.float32),
                         device=dev)
    x0s = x0[None] + 0.01 * _normal(1, (B, 13), dev)
    us = torch.zeros((B, N, 7), dtype=torch.float32, device=dev)
    _, summary = solve_batch_sharded(
        ocp, x0s, us, mesh, SolverConfig(max_al_iters=1, max_inner_iters=2))
    mean_cost = float(summary.mean_cost)
    if not np.isfinite(mean_cost):
        raise RuntimeError(f"sharded solve: mean cost {mean_cost}")
    return mean_cost


def _tp_step(mesh, n_devices, mlp):
    """Step 2: one Adam step of the MLP, hidden layer split over tp, the
    batch over dp."""
    from aircraft_tpu_torch.dynamics.coefficients import (MLP_KEYS,
                                                          MLPCoeffParams,
                                                          mlp_from_numpy)
    from aircraft_tpu_torch.parallel import batch_sharding
    from aircraft_tpu_torch.parallel.tensor import (TensorParallelTrainer,
                                                    gather_mlp, shard_mlp)

    dev = mesh.device
    whole = (MLPCoeffParams.init(torch.Generator().manual_seed(0),
                                 device="cpu")
             if mlp is None else mlp_from_numpy(mlp, device="cpu"))
    B = 4 * n_devices
    xb, yb = _normal(2, (B, 5), "cpu"), _normal(3, (B, 6), "cpu")
    rows = batch_sharding(mesh, B)
    trainer = TensorParallelTrainer(shard_mlp(whole, mesh), mesh, lr=1e-3)
    loss = float(trainer.step(xb[rows].to(dev), yb[rows].to(dev),
                              torch.ones(6, device=dev), B))
    if not np.isfinite(loss):
        raise RuntimeError(f"tensor-parallel step: loss {loss}")
    after = gather_mlp(trainer.params, mesh)
    return {"loss": loss, "xb": xb.numpy(), "yb": yb.numpy(),
            "init": {k: getattr(whole, k).numpy() for k in MLP_KEYS},
            "mlp": {k: getattr(after, k).cpu().numpy() for k in MLP_KEYS}}


def _seq_riccati(n_devices, device):
    """Step 3: the horizon-sharded Riccati sweep against the sequential
    one on a random LQ problem (horizon 4n)."""
    from aircraft_tpu_torch.parallel.seq_riccati import (
        backward_associative_sharded, make_seq_mesh)
    from aircraft_tpu_torch.solvers import riccati

    seq = make_seq_mesh(n_devices, device=device.type)
    Nh, n, m = 4 * n_devices, 13, 7
    g = torch.Generator().manual_seed(4)
    r = lambda *shape: torch.randn(shape, generator=g, dtype=torch.float32)
    A = torch.eye(n) + 0.02 * r(Nh, n, n)
    Bm = 0.1 * r(Nh, n, m)
    Wx, Wu = r(Nh, n, n), r(Nh, m, m)
    lxx = Wx @ Wx.transpose(-1, -2) / n + torch.eye(n)
    luu = Wu @ Wu.transpose(-1, -2) / m + torch.eye(m)
    lux = torch.zeros(Nh, m, n)
    lx, lu = r(Nh, n), r(Nh, m)
    args = tuple(t[None].to(device) for t in (A, Bm, lx, lu, lxx, luu, lux,
                                               torch.zeros(n), torch.eye(n)))
    reg = torch.full((1,), 1e-6, device=device)
    K_p, _, _, _, _, fail_p = backward_associative_sharded(seq, *args, reg)
    K_s = riccati.backward_sequential(*args, reg)[0]
    blk = Nh // seq.size
    err = float((K_p - K_s[:, seq.rank * blk:(seq.rank + 1) * blk])
                .abs().max())
    if bool(fail_p.any()) or not err <= 5e-3:
        raise RuntimeError(f"sharded Riccati sweep: fail {bool(fail_p.any())},"
                           f" max |K - K_sequential| {err}")
    return err


def _dryrun_rank(group, n_devices, mlp):
    """One rank of ``dryrun_multichip`` (``group``: the 1-D mesh of the
    ranks' process group); host values only."""
    from aircraft_tpu_torch.parallel import make_mesh

    tp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(n_devices, tp=tp, device=group.device.type)
    return {"coords": (mesh.dp, mesh.tp), "shape": (mesh.size, mesh.tp_size),
            "mean_cost": _sharded_solve(mesh, n_devices),
            **_tp_step(mesh, n_devices, mlp),
            "riccati_max_abs_dK": _seq_riccati(n_devices, mesh.device)}


def dryrun_multichip(n_devices: int, device="cuda", mlp=None) -> list:
    """The three production steps on an ``n_devices``-rank mesh (see the
    module docstring); returns each rank's record (the dp x tp
    coordinates, the solve's mean cost, the MLP step's loss, batch and
    MLP before and after, the sweep's max |K - K_sequential|).  Raises when
    a step fails on any rank."""
    from aircraft_tpu_torch.parallel import spawn

    return spawn(_dryrun_rank, n_devices, device=device,
                 args=(n_devices, mlp))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--ranks", type=int, default=1)
    a = p.parse_args(argv)
    from aircraft_tpu_torch.observability import timed_jit_call

    # the ranks import their function by its module's name, not __main__
    from aircraft_tpu_torch import entry as mod

    fn, (x0, us) = mod.entry(a.device)
    run = timed_jit_call(fn, x0, us, reps=5)
    recs = mod.dryrun_multichip(a.ranks, device=a.device)
    print(json.dumps({
        "entry": {"batch": B_FLAGSHIP, "first_call_excess_s": run.compile_s,
                  "step_s": run.execute_s,
                  "finite": bool(torch.isfinite(run.result).all())},
        "dryrun": [{k: r[k] for k in ("coords", "shape", "mean_cost", "loss",
                                      "riccati_max_abs_dK")} for r in recs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
