"""The port's bench: the serving-chain headline, the single-aircraft
serving modes, the kernel modes and the fleet-scale modes.

``--mode headline`` (the default): batched N=50 MHTT window solves of a
fleet of gliders spread along the course track, chained window to window.
Each window solves the whole fleet's N=50, dt=0.01 window (3 AL rounds x
12 inner iterations, Gauss-Newton curvature, 6 line-search candidates,
per-row penalty ratchet), commits 20 knots, and carries the state, the
shifted controls and the violation-gated duals to the next window.
``--solver fused`` runs every inner iteration as the two window kernels;
``--solver ilqr`` runs ``solvers/ilqr.solve_batch`` (the reference's
``BENCH_FUSED=0``), whose Quu solves take the batched-Cholesky kernel
with ``--cuda-chol`` (``BENCH_PALLAS_CHOL=1``).  The reference's
``BENCH_BATCH_MINOR`` has no switch here: ``solve_batch(batch_minor=True)``
is the same solve on the card.  On ``cpu`` every kernel runs its plain
version.

The set-up (the plant's best-glide speed and L/D, which lay out the
track, and the fleet trim that seeds the controls) comes from trim
searches run on the host in float64 whatever ``--device`` is, so every
device builds the same problem.  ``--seed 0`` (the default) starts them
from the reference bench's own start clouds (drawn from
``jax.random.PRNGKey(0)``, stored in ``solvers/trim_starts.npz``); any
other seed draws the clouds from ``torch.Generator().manual_seed(seed)``.

    python -m aircraft_tpu_torch.bench [--solver fused|ilqr] [--cuda-chol]
        [--batch 256] [--warmup 6] [--reps 3] [--seed 0]

prints one JSON line with the reference bench's headline fields plus
``device``, ``fused_kernels``, ``matmul_precision``, ``solver`` and the
kernels' launch counts.

``--mode kernel`` (the reference's ``BENCH_MODE=kernel``): the fused
rollout kernel (both TPU names, ``make_fused_rollout`` and
``make_fused_rollout_tiles``) against the plain PyTorch rollout on
B=1024 copies of the configured initial state, N=50, dt=0.01, 10
substeps, zero controls.  The plant is the trained ``mlp.npz``: the
reference draws ``MLPCoeffParams.init(PRNGKey(0))``, which torch cannot
replay.  ``--mode chol`` (``BENCH_MODE=chol``): the batched-Cholesky
kernel on B=12800 SPD systems, m=7, k=8, built from
``np.random.default_rng(0)`` as the reference builds them.  Each prints the
reference mode's JSON keys; the keys it names ``xla_*`` hold the plain
PyTorch rollout (kernel mode) or ``torch.linalg.cholesky_ex`` +
``torch.cholesky_solve`` (chol mode).  Times are host wall clock around a
synchronised call, the median of ``--reps`` (5 and 7 by default).

``--mode riccati`` (``BENCH_MODE=riccati``): the sequential against the
associative Riccati sweep on one horizon of the reference mode's stage
data (n = 13, m = 7, ``np.random.default_rng(0)``) at each of
``--horizons`` (50, 200, 800, 3200), timed by CUDA events (median of
``--reps``, 7), with the largest |K| difference between the two sweeps;
``--cuda-chol`` puts their Quu solves on the batched-Cholesky kernel.  It
prints the reference mode's keys, ``device`` holding the card's name and
power limit.

``--mode whole`` (``BENCH_MODE=whole``): the reference's whole-trajectory
experiment, one fixed-time solve at N = ``--horizon`` (297) knots, dt =
0.01, default aero model, RK4, a terminal goal cost toward the reachable
goal [146, 8, -195] with every control channel penalised, at ``--al-iters
6 --inner-iters 25``, Gauss-Newton curvature, penalty 10.  Its warm start
is ``waypoints.receding_warm_start`` (``--window`` 50, ``--overlap`` 30:
MHTT flies the Dubins line to the goal, on the window kernels on the
card), timed apart.  The first solve is untimed (``compile_wall_s``); the
value is the median of ``--reps`` (3) more.  It prints the reference
mode's keys, ``device`` holding the card's name and power limit, and
``vs_baseline`` against the reference's 12 s of CasADi/IPOPT solver time
on a CPU, a ratio and not a target.

``--mode latency`` (``BENCH_MODE=latency``): one aircraft's N=50 window
solve at the headline budget, ``--reps`` times (30) from the same state,
p50 / p90 against the 0.2 s of flight a window commits.  ``--mode serve``
(``BENCH_MODE=serve``): one aircraft served ``--windows`` windows (50),
each committed window pushed to the async telemetry recorder; pipelined
(window w+1 dispatched before window w's blob is read) unless
``--no-pipeline``.  Both solve the headline problem from the fleet's
first glider at s = 0.1 with the trim warm start, on the window kernels
(``--solver fused``, the reference's ``BENCH_FUSED=1``) or
``ilqr.solve_batch`` (``--solver ilqr``), and print the reference mode's
keys plus ``device``, ``matmul_precision`` and the launch counts.

The fleet-scale modes (the reference's ``BENCH_MODE=phase|warm|roofline|
oppoints|scaling``) print the reference mode's keys, ``device`` holding
the card's name and power limit:

* ``--mode phase``: one inner iLQR iteration at B=256, N=50 split into
  its pieces, each timed alone (``bench_phase``); ``--cuda-chol`` puts
  the backward piece on the batched-Cholesky kernel.
* ``--mode warm``: a cold window and ``--windows`` (6) warm windows of
  ``ilqr.solve_batch`` at 2 x 6 (``bench_warm``).
* ``--mode roofline``: the fused window solve at 2 x 6 against the work
  its kernels' source counts (``aircraft_tpu_torch/roofline.py``).
* ``--mode oppoints``: one headline chain per ``--points`` entry
  ("ALxINNER[r]", a subprocess each), the best point clearing the gate;
  ``--no-row-penalty`` runs the headline without the per-row ratchet.
* ``--mode scaling``: ``parallel.solve_batch_sharded`` at each of
  ``--devices`` ranks (NCCL, one rank per card, a count above the
  visible cards skipped; gloo processes on ``cpu``).

oppoints and scaling write their record under
``build/aircraft_tpu_torch/runs/`` (or ``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from aircraft_tpu_torch.config import SolverConfig, glider_config
from aircraft_tpu_torch.control.course import COURSE_OCP_KNOBS, course_track
from aircraft_tpu_torch.control.mhtt import (
    build_mhtt_ocp,
    finish_pull,
    start_pull,
)
from aircraft_tpu_torch.device import matmul_precision, resolve_device
from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
from aircraft_tpu_torch.dynamics.coefficients import load_mlp
from aircraft_tpu_torch.kernels import cholesky as chol_mod
from aircraft_tpu_torch.kernels import rollout as rollout_mod
from aircraft_tpu_torch.kernels import window as window_mod
from aircraft_tpu_torch.solvers import ilqr
from aircraft_tpu_torch.solvers import ocp as ocp_mod
from aircraft_tpu_torch.solvers import riccati
from aircraft_tpu_torch.solvers.fused import make_fused_solver
from aircraft_tpu_torch.solvers.trim import (
    TrimResult,
    multistart_trim,
    reference_start_cloud,
    start_cloud,
)

BASELINE_SOLVES_PER_S = 5.0   # one N=50 window per 0.2 s of committed flight
N_HORIZON = 50
DT = 0.01
OVERLAP = 30                  # knots a window shares with the next
RESET_VIOL = 5.0              # physical-unit-scaled rows
DEADLINE_S = (N_HORIZON - OVERLAP) * DT   # the flight a window commits


def headline_config(al_iters=3, inner_iters=12, ls=6, *, row_penalty=True,
                    reg_escalate=100.0) -> SolverConfig:
    """The bench's Gauss-Newton budget: ``row_penalty`` turns on the
    per-row penalty ratchet (the headline's; an oppoints point without
    its trailing ``r`` and the warm, roofline and scaling modes run
    without it, as the reference's ``BENCH_ROWPEN=0``)."""
    return SolverConfig(max_al_iters=al_iters, max_inner_iters=inner_iters,
                        line_search_steps=ls, hessian="gauss_newton",
                        reg_escalate=reg_escalate,
                        penalty_per_row=row_penalty)


def setup_trim(params, n_starts, target_airspeed, *, seed=0):
    """The set-up's trim search, the same on every device:
    ``multistart_trim(prefer_coordinated=True)`` on the host in float64
    from ``n_starts`` starts, its result in float32 on ``params``' device.
    Seed 0 takes the reference bench's start cloud (its draw from
    ``jax.random.PRNGKey(0)``, ``trim.reference_start_cloud``); any other
    seed draws one from ``torch.Generator().manual_seed(seed)``."""
    host = params.to("cpu").to(torch.float64)
    z0s = (reference_start_cloud(n_starts) if seed == 0 else
           start_cloud(n_starts, torch.Generator().manual_seed(seed), "cpu"))
    t = multistart_trim(host, torch.as_tensor(z0s, dtype=torch.float64),
                        target_airspeed=float(target_airspeed),
                        prefer_coordinated=True)
    return TrimResult(*(x.to(params.device, torch.float32)
                        if x.is_floating_point() else x.to(params.device)
                        for x in t))


def plant_best_glide(params, speeds=(24.0, 28.0, 32.0), seed=0):
    """(v_ref, glide_ld): the trim speed with the flattest glide
    (``setup_trim``, 8 starts), the track laid out at 90% of that L/D."""
    best = None
    for v in speeds:
        t = setup_trim(params, 8, v, seed=seed)
        vel = t.state[3:6].detach().cpu().numpy()
        gamma = float(np.arctan2(vel[2], np.hypot(vel[0], vel[1])))
        ld = 1.0 / max(np.tan(gamma), 1e-3)
        if best is None or ld > best[1]:
            best = (float(v), ld)
    return best[0], 0.9 * best[1]


def build_problem(device="cuda", *, coeff=None, seed=0, glide=None):
    """The bench's window OCP: MLP plant, course track anchored 20 m above
    ground at its end, the course knobs with unit-scaled envelope rows and
    the tanh control squash.  ``glide``: the plant's (v_ref, glide_ld)
    when already found (``plant_best_glide``, whose trims dominate the
    set-up).  Returns (cfg, params, ocp, track, v_ref, spec)."""
    dev = resolve_device(device)
    cfg = glider_config()
    coeff = load_mlp(device=dev) if coeff is None else coeff
    params = AircraftParams.from_config(cfg.aircraft, coeff=coeff, device=dev)
    v_ref, glide_ld = (plant_best_glide(params, seed=seed) if glide is None
                       else glide)
    track = course_track(cfg, v_ref=v_ref, glide_ld=glide_ld)
    z_end = float(track.track_points[:, 2].max())
    track.track_points = track.track_points.clone()
    track.track_points[:, 2] -= max(0.0, z_end + 20.0)
    knobs = dict(COURSE_OCP_KNOBS)
    knobs["envelope_overrides"] = {**knobs["envelope_overrides"],
                                   "unit_scales": True}
    knobs["squash_box"] = True
    spec = {}
    ocp = build_mhtt_ocp(params, cfg, track.track_points.to(dev),
                         track.length(), dt=DT, v_ref=v_ref, spec_out=spec,
                         **knobs)
    return cfg, params, ocp, track, v_ref, spec


def fleet_rows(track, batch, v_ref, *, s_span=(0.1, 0.9)) -> np.ndarray:
    """(batch, 14) float32 stations along the track at the serving speed:
    the track's state guess (coordinated-turn attitude and rates) at
    progress spread over ``s_span``, the speed and rates scaled to
    ``v_ref``, the progress in the last column."""
    M = 256
    guess = np.asarray(track.state_guess(M), np.float64)
    idx = np.round(np.linspace(s_span[0], s_span[1], batch) * M).astype(int)
    rows = guess[idx].copy()
    speed0 = np.linalg.norm(rows[:, 3:6], axis=1, keepdims=True)
    scale = v_ref / np.maximum(speed0, 1e-6)
    rows[:, 3:6] *= scale
    rows[:, 10:13] *= scale
    return np.concatenate([rows, (idx / M)[:, None]], axis=1).astype(
        np.float32)


def fleet_states(params, track, batch, v_ref, *, s_span=(0.1, 0.9), seed=0):
    """`batch` gliders at the serving speed along the track
    (``fleet_rows``), and the trim that seeds their controls
    (``setup_trim``, 32 starts at ``v_ref + 2``).  Returns (z0s (B, 14),
    trim)."""
    trim = setup_trim(params, 32, v_ref + 2.0, seed=seed)
    z = fleet_rows(track, batch, v_ref, s_span=s_span)
    return torch.as_tensor(z, device=params.device), trim


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def kernel_launches() -> dict:
    """Launch counts of every kernel of the port, and the Riccati sweep's
    numeric fallbacks."""
    counts = {fn.__name__: fn.launches for mod in (window_mod, chol_mod,
                                                   rollout_mod)
              for fn in mod.KERNELS}
    counts["chol_fallbacks"] = riccati.read_fallbacks()
    return counts


def headline_chain(ocp, spec, config, us0, al0, *, horizon=N_HORIZON,
                   solver="fused", cuda_chol=False):
    """The serving chain's step: ``chain_step(z, us, al) -> (z, us, al,
    sols)`` solves the fleet's window, commits ``horizon - OVERLAP`` knots
    and carries the state, the shifted controls and the violation-gated
    duals; a scenario whose window ends above ``RESET_VIOL`` restarts from
    ``us0`` and ``al0``.  ``solver`` is ``"fused"`` (the window kernels)
    or ``"ilqr"`` (``ilqr.solve_batch``, its Quu solves on the
    batched-Cholesky kernel when ``cuda_chol``)."""
    if solver not in ("fused", "ilqr"):
        raise ValueError(f"solver={solver!r}")
    if cuda_chol and solver != "ilqr":
        raise ValueError("cuda_chol applies to solver='ilqr'")
    if solver == "fused":
        solve = make_fused_solver(ocp, spec, horizon, config)
    else:
        def solve(z, us, al):
            return ilqr.solve_batch(ocp, z, us, config, al_inits=al,
                                    cuda_chol=cuda_chol)
    commit = horizon - OVERLAP if horizon > OVERLAP else max(1, horizon // 2)

    def chain_step(z, us, al):
        sols = solve(z, us, al)
        z_next = sols.xs[:, commit]
        us_next = torch.cat([sols.us[:, commit:],
                             sols.us[:, -1:].expand(-1, commit, -1)], dim=1)
        al_next = ocp_mod.shift_al_state(
            sols.al, commit, mu0=config.penalty_init,
            decay=ocp_mod.gated_decay(sols.violation, RESET_VIOL))
        bad = sols.violation > RESET_VIOL
        us_next = torch.where(bad[:, None, None], us0, us_next)
        al_next = al_next.where(bad, al0)
        return z_next.contiguous(), us_next.contiguous(), al_next, sols

    return chain_step


def window_summary(violation, cost) -> dict:
    """One window's fleet quality from its violations and costs (host
    arrays), the headline's fields: converged fraction at 1e-2, mean
    cost, mean violation, diverged fraction."""
    viol = np.asarray(violation, np.float64)
    cost = np.asarray(cost, np.float64)
    return {"converged_fraction_1e2": float(np.mean(viol <= 1e-2)),
            "mean_cost": float(np.nanmean(cost)),
            "mean_violation": float(np.nanmean(viol)),
            "diverged_fraction": float(np.mean(viol > RESET_VIOL))}


def run_headline(device="cuda", *, batch=256, horizon=N_HORIZON, al_iters=3,
                 inner_iters=12, ls=6, warmup=6, reps=3, seed=0,
                 solver="fused", cuda_chol=False, row_penalty=True,
                 reg_escalate=100.0, glide=None, on_window=None) -> dict:
    """Cold window, `warmup` chained windows, then `reps` timed chained
    windows; returns the headline record.  ``solver`` and ``cuda_chol``
    as ``headline_chain``; ``seed`` as ``setup_trim``; ``row_penalty`` as
    ``headline_config``; ``glide`` as ``build_problem``.  ``on_window(w, sols)``, when given,
    is called after each window w = 0 .. warmup + reps (outside the timed
    span) and adds nothing to the record."""
    dev = resolve_device(device)
    t_setup = time.perf_counter()
    cfg, params, ocp, track, v_ref, spec = build_problem(dev, seed=seed,
                                                         glide=glide)
    config = headline_config(al_iters, inner_iters, ls,
                             row_penalty=row_penalty,
                             reg_escalate=reg_escalate)
    z0s, trim = fleet_states(params, track, batch, v_ref, seed=seed)
    u_trim = ocp.control_unsquash(trim.control[:7])
    us0 = u_trim.reshape(1, 1, 7).expand(batch, horizon, 7).contiguous()
    al0 = ocp_mod.init_al_state(ocp, z0s, us0[:, 0], horizon,
                                mu0=config.penalty_init)
    chain_step = headline_chain(ocp, spec, config, us0, al0, horizon=horizon,
                                solver=solver, cuda_chol=cuda_chol)
    setup_s = time.perf_counter() - t_setup
    hook = on_window if on_window is not None else (lambda w, sols: None)

    t0 = time.perf_counter()
    z, us, al, sols = chain_step(z0s, us0, al0)
    _sync(dev)
    cold_s = time.perf_counter() - t0
    cold_viol = float(torch.nanmean(sols.violation))
    hook(0, sols)
    for w in range(warmup):
        z, us, al, sols = chain_step(z, us, al)
        hook(1 + w, sols)
    walls = []
    for w in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        z, us, al, sols = chain_step(z, us, al)
        _sync(dev)
        walls.append(time.perf_counter() - t0)
        hook(1 + warmup + w, sols)
    wall = float(np.median(walls))

    viol = sols.violation.detach().cpu().numpy()
    cost = sols.cost.detach().cpu().numpy()
    converged = float(np.mean(viol <= 1e-2))
    return {
        "metric": "6dof_nn_mpc_solves_per_s_N50_per_chip",
        "value": round(batch / wall, 2),
        "feasibility_gate_95pct_1e2_passed": converged >= 0.95,
        "unit": "solves/s",
        "vs_baseline": round(batch / wall / BASELINE_SOLVES_PER_S, 2),
        "batch": batch,
        "wall_s_per_batch": round(wall, 4),
        "latency_s_per_window": round(wall, 4),
        "compile_s": round(setup_s + cold_s, 1),
        "compile_cache_entries_at_start": 0,
        "chained_windows": True,
        "scan_windows": 1,
        "matmul_precision": matmul_precision(),
        "al_iters": config.max_al_iters,
        "inner_iters": config.max_inner_iters,
        "penalty_per_row": config.penalty_per_row,
        "violation_units": "physical-unit-scaled",
        "converged_gate": 1e-2,
        "reset_viol": RESET_VIOL,
        "warmup_windows": warmup,
        "finite_fraction": round(float(np.isfinite(cost).mean()), 3),
        "mean_violation": round(float(np.nanmean(viol)), 6),
        "cold_window_mean_violation": round(cold_viol, 4),
        "converged_fraction_1e2": round(converged, 4),
        "converged_fraction_1e4": round(float(np.mean(viol <= 1e-4)), 4),
        "p90_violation": round(float(np.nanpercentile(viol, 90)), 6),
        "median_violation": round(float(np.nanpercentile(viol, 50)), 6),
        "diverged_fraction": round(float(np.mean(viol > RESET_VIOL)), 4),
        "mean_cost": round(float(np.nanmean(cost)), 2),
        "device": _device_name(dev),
        "fused_kernels": solver == "fused" and dev.type == "cuda",
        "solver": solver,
        "cuda_chol": cuda_chol,
        "windows": 1 + warmup + reps,
        "horizon": horizon,
        "line_search_steps": ls,
        "kernel_launches": kernel_launches(),
    }


def _median_wall(fn, args, reps, dev):
    walls = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        fn(*args)
        _sync(dev)
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


def _device_name(dev):
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def bench_kernel(device="cuda", *, batch=1024, horizon=N_HORIZON,
                 substeps=10, reps=5) -> dict:
    """The fused rollout kernel under both TPU names against the plain
    PyTorch rollout (``xla_s``) on the same batch."""
    dev = resolve_device(device)
    cfg = glider_config()
    params = AircraftParams.from_config(cfg.aircraft,
                                        coeff=load_mlp(device=dev), device=dev)
    x0 = torch.as_tensor(np.asarray(cfg.waypoints.initial_state, np.float32),
                         device=dev).expand(batch, 13).contiguous()
    us = torch.zeros((batch, horizon, 7), dtype=torch.float32, device=dev)
    kern = rollout_mod.make_fused_rollout(params, horizon=horizon, dt=DT,
                                          substeps=substeps)
    tiles = rollout_mod.make_fused_rollout_tiles(
        params, horizon=horizon, dt=DT, substeps=substeps)
    def plain(x0, us):
        return rollout_mod.rollout_plain(kern.operands, x0, us)

    out_k, out_t, out_x = kern(x0, us), tiles(x0, us), plain(x0, us)
    max_diff = float(torch.max(torch.abs(out_k - out_x)))
    max_diff_tiles = float(torch.max(torch.abs(out_t - out_x)))
    tk = _median_wall(kern, (x0, us), reps, dev)
    tt = _median_wall(tiles, (x0, us), reps, dev)
    tx = _median_wall(plain, (x0, us), reps, dev)
    best = min(tk, tt)
    return {
        "metric": "fused_rollout_speedup_vs_xla",
        "value": round(tx / best, 3), "unit": "x",
        "vs_baseline": round(tx / best, 3),
        "kernel_lanes_s": round(tk, 5), "kernel_tiles_s": round(tt, 5),
        "xla_s": round(tx, 5),
        "batch": batch, "horizon": horizon, "substeps": substeps,
        "max_diff": max_diff, "max_diff_tiles": max_diff_tiles,
        "device": _device_name(dev),
    }


def chol_problem(batch=256 * 50, m=7, k=8, seed=0):
    """The reference chol mode's SPD batch: A = W Wᵀ/m + 2I, rhs ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    W = rng.normal(0, 1, (batch, m, m)).astype(np.float32)
    A = (np.einsum("bij,bkj->bik", W, W) / m
         + 2.0 * np.eye(m)[None]).astype(np.float32)
    rhs = rng.normal(0, 1, (batch, m, k)).astype(np.float32)
    return A, rhs


def library_cholesky_solve(A, rhs):
    """One library factor-and-solve of the same systems: the yardstick the
    chol mode names ``xla_s``."""
    L, _ = torch.linalg.cholesky_ex(A)
    return torch.cholesky_solve(rhs, L)


def bench_chol(device="cuda", *, batch=256 * 50, reps=7) -> dict:
    """The batched-Cholesky kernel against a library solve (``xla_s``)."""
    dev = resolve_device(device)
    m, k = 7, 8   # Quu size and [Qu | Qux] width of the reference's mode
    A, rhs = (torch.as_tensor(t, device=dev) for t in chol_problem(batch, m, k))
    xk = chol_mod.batched_cholesky_solve(A, rhs)
    xx = library_cholesky_solve(A, rhs)
    max_diff = float(torch.max(torch.abs(xk - xx)))
    tk = _median_wall(chol_mod.batched_cholesky_solve, (A, rhs), reps, dev)
    tx = _median_wall(library_cholesky_solve, (A, rhs), reps, dev)
    return {
        "metric": "batched_tiny_cholesky_speedup_vs_xla",
        "value": round(tx / tk, 3), "unit": "x",
        "vs_baseline": round(tx / tk, 3),
        "kernel_s": round(tk, 6), "xla_s": round(tx, 6),
        "batch": batch, "m": m, "k": k, "max_diff": max_diff,
        "device": _device_name(dev),
    }


def riccati_problem(N, rng, n=13, m=7):
    """The reference riccati mode's stage data for one horizon of N knots
    (a batch of one), float32, drawn from ``rng`` in the reference's
    order: A ≈ I, small B, PD lxx and luu, small cross terms, vx, vxx = I."""
    A = np.eye(n)[None] + 0.01 * rng.normal(0, 1, (N, n, n))
    B = 0.01 * rng.normal(0, 1, (N, n, m))
    lx = rng.normal(0, 1, (N, n))
    lu = rng.normal(0, 1, (N, m))
    W = rng.normal(0, 1, (N, n, n))
    lxx = np.einsum("bij,bkj->bik", W, W) / n + np.eye(n)[None]
    U = rng.normal(0, 1, (N, m, m))
    luu = np.einsum("bij,bkj->bik", U, U) / m + np.eye(m)[None]
    lux = 0.01 * rng.normal(0, 1, (N, m, n))
    vx = rng.normal(0, 1, n)
    vxx = np.eye(n)
    return tuple(np.asarray(a, np.float32)[None]
                 for a in (A, B, lx, lu, lxx, luu, lux, vx, vxx))


def _median_ms(fn, args, reps, dev):
    """Median time of ``reps`` calls after a warm one: CUDA events around
    each call on the card, the host clock on the CPU."""
    fn(*args)
    walls = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            stop.record()
            stop.synchronize()
            walls.append(start.elapsed_time(stop))
        else:
            t0 = time.perf_counter()
            fn(*args)
            walls.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(walls))


def _card(dev) -> str:
    """The card's name and power limit as nvidia-smi reports them, or
    "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", f"--id={dev.index or 0}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def bench_riccati(device="cuda", *, horizons=(50, 200, 800, 3200), reps=7,
                  cuda_chol=False) -> dict:
    """The sequential against the associative Riccati sweep over horizon
    lengths on one horizon of the reference mode's stage data (n = 13,
    m = 7), with the largest |K| difference between them; float32
    matmuls run at full precision throughout (``device.py``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    reg = torch.full((1,), 1e-6, device=dev)
    rows = {}
    for N in horizons:
        args = tuple(torch.as_tensor(a, device=dev)
                     for a in riccati_problem(N, rng)) + (reg,)
        seq = lambda *a: riccati.backward_sequential(*a, cuda_chol=cuda_chol)
        assoc = lambda *a: riccati.backward_associative(*a,
                                                        cuda_chol=cuda_chol)
        ts, ta = _median_ms(seq, args, reps, dev), _median_ms(assoc, args,
                                                              reps, dev)
        K_s, K_a = seq(*args)[0], assoc(*args)[0]
        rows[f"N{N}"] = {
            "seq_ms": round(ts, 3), "assoc_ms": round(ta, 3),
            "speedup": round(ts / ta, 3),
            "max_K_diff": float(torch.max(torch.abs(K_s - K_a))),
        }
    biggest = rows[f"N{horizons[-1]}"]
    return {
        "metric": "riccati_associative_speedup_vs_sequential",
        "value": biggest["speedup"], "unit": "x",
        "vs_baseline": biggest["speedup"], "horizons": rows,
        "cuda_chol": cuda_chol, "matmul_precision": matmul_precision(),
        "device": _card(dev),
    }


def serving_problem(device="cuda", *, horizon=N_HORIZON, al_iters=3,
                    inner_iters=12, ls=6, solver="fused", seed=0, glide=None):
    """One aircraft on the headline problem: a healthy on-track state
    (the fleet's first glider at s = 0.1) and the trim warm start.
    Returns (dev, ocp, config, z0 (14,), us0 (N, 7), solve), ``solve``
    taking batch-leading (z0s, us, al) through the window kernels
    (``fused``) or ``ilqr.solve_batch`` (``ilqr``); ``glide`` as
    ``build_problem``."""
    if solver not in ("fused", "ilqr"):
        raise ValueError(f"solver={solver!r}")
    dev = resolve_device(device)
    cfg, params, ocp, track, v_ref, spec = build_problem(dev, seed=seed,
                                                         glide=glide)
    config = headline_config(al_iters, inner_iters, ls)
    zs, trim = fleet_states(params, track, 1, v_ref, s_span=(0.1, 0.1),
                            seed=seed)
    u_trim = ocp.control_unsquash(trim.control[:7])
    us0 = u_trim[None].expand(horizon, 7).contiguous()
    if solver == "fused":
        solve = make_fused_solver(ocp, spec, horizon, config)
    else:
        def solve(z0s, us, al=None):
            return ilqr.solve_batch(ocp, z0s, us, config, al_inits=al)
    return dev, ocp, config, zs[0], us0, solve


def bench_latency(device="cuda", *, horizon=N_HORIZON, al_iters=3,
                  inner_iters=12, ls=6, reps=30, solver="fused",
                  seed=0, glide=None) -> dict:
    """p50 / p90 replan latency of one aircraft's window solve (batch 1)
    from the same state and warm start, against the 0.2 s of flight a
    window commits (the reference's ``BENCH_MODE=latency``)."""
    dev, ocp, config, z0, us0, solve = serving_problem(
        device, horizon=horizon, al_iters=al_iters, inner_iters=inner_iters,
        ls=ls, solver=solver, seed=seed, glide=glide)
    t0 = time.perf_counter()
    sol = solve(z0[None], us0[None])
    _sync(dev)
    compile_wall = time.perf_counter() - t0
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sol = solve(z0[None], us0[None])
        _sync(dev)
        walls.append(time.perf_counter() - t0)
    p50 = float(np.percentile(walls, 50))
    return {
        "metric": "replan_latency_p50_ms_b1_N50",
        "value": round(p50 * 1e3, 3),
        "unit": "ms",
        "vs_baseline": round(DEADLINE_S / p50, 2),
        "p90_ms": round(float(np.percentile(walls, 90)) * 1e3, 3),
        "reps": reps,
        "fused_kernels": solver == "fused" and dev.type == "cuda",
        "al_iters": config.max_al_iters,
        "inner_iters": config.max_inner_iters,
        "compile_wall_s": round(compile_wall, 1),
        "cost": round(float(sol.cost[0]), 1),
        "violation": round(float(sol.violation[0]), 6),
        "device": _device_name(dev),
        "matmul_precision": matmul_precision(),
        "solver": solver,
        "horizon": horizon,
        "kernel_launches": kernel_launches(),
    }


def bench_serve(device="cuda", *, windows=50, pipeline=True, horizon=N_HORIZON,
                al_iters=3, inner_iters=12, ls=6, solver="fused",
                seed=0, glide=None) -> dict:
    """One aircraft served window after window against the deadline of
    the 0.2 s of flight each window commits, every committed window
    pushed to the async telemetry recorder (the reference's
    ``BENCH_MODE=serve``).  The carry (state, shifted controls, duals
    gated at RESET_VIOL) stays on the device; a window above RESET_VIOL
    hands the next one the trim warm start and cold duals.  Each window
    returns one packed blob ``[xs[1:c+1] | us[:c] | cost, violation,
    reset, s_next]``.

    Pipelined (the default) dispatches window w+1 before reading window
    w's blob, and reports the commit cadence; ``pipeline=False`` reports
    the synchronous loop's latency with its solve / commit-copy /
    telemetry split.  The log goes to ``serve_telemetry.bin`` in the
    build directory."""
    from aircraft_tpu_torch.kernels._build import BUILD_DIR
    from aircraft_tpu_torch.native import telemetry as tel

    dev, ocp, config, x, us_reset, solve = serving_problem(
        device, horizon=horizon, al_iters=al_iters, inner_iters=inner_iters,
        ls=ls, solver=solver, seed=seed, glide=glide)
    N = horizon
    commit = N - OVERLAP if N > OVERLAP else max(1, N // 2)
    al_reset = ocp_mod.init_al_state(ocp, x[None], us_reset[None, 0], N,
                                     mu0=config.penalty_init)

    def step(x, us, al):
        sol = solve(x[None], us[None], al)
        us_next = torch.cat([sol.us[0, commit:],
                             sol.us[0, -1:].expand(commit, -1)])
        al_next = ocp_mod.shift_al_state(
            sol.al, commit, mu0=config.penalty_init,
            decay=ocp_mod.gated_decay(sol.violation, RESET_VIOL))
        bad = sol.violation > RESET_VIOL
        us_next = torch.where(bad, us_reset, us_next).contiguous()
        al_next = al_next.where(bad, al_reset)
        blob = torch.cat([
            sol.xs[0, 1:commit + 1, :14].reshape(-1),
            sol.us[0, :commit].reshape(-1),
            sol.cost, sol.violation, bad.to(torch.float32),
            sol.xs[0, commit, 13:14]])
        return sol.xs[0, commit], us_next, al_next, blob

    def unpack(host):
        xs14 = host[: commit * 14].reshape(commit, 14)
        us_c = host[commit * 14: commit * 21].reshape(commit, 7)
        cost, viol, was_reset, progress = host[-4:]
        return xs14, us_c, cost, viol, was_reset, progress

    us, al = us_reset, al_reset
    t0 = time.perf_counter()
    blob = step(x, us, al)[3]
    _sync(dev)
    compile_wall = time.perf_counter() - t0

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    solve_walls, copy_walls, tel_walls, cadence, viol_hist = [], [], [], [], []
    progress_hist, n_resets = [], 0

    def record(rec, w, host):
        nonlocal n_resets
        xs14, us_c, cost, viol, was_reset, progress = unpack(host)
        viol_hist.append(float(viol))
        progress_hist.append(float(progress))
        n_resets += int(was_reset > 0)
        rec.push(tel.flight_records(w, xs14[:, :13], us_c, xs14[:, 13],
                                    cost, viol))

    with tel.TelemetryRecorder(BUILD_DIR / "serve_telemetry.bin",
                               tel.FLIGHT_REC_FLOATS,
                               capacity=1 << 16) as rec:
        if pipeline:
            x_n, us_n, al_n, blob_n = step(x, us, al)
            pending = start_pull(blob_n)
            t_prev = time.perf_counter()
            for w in range(windows):
                x, us, al, pulled = x_n, us_n, al_n, pending
                # dispatch w+1 from the carry on the device, then read w
                # (no speculative solve after the last window)
                if w + 1 < windows:
                    x_n, us_n, al_n, blob_n = step(x, us, al)
                    pending = start_pull(blob_n)
                record(rec, w, finish_pull(pulled))
                t_now = time.perf_counter()
                cadence.append(t_now - t_prev)
                t_prev = t_now
        else:
            for w in range(windows):
                t0 = time.perf_counter()
                x, us, al, blob = step(x, us, al)
                _sync(dev)
                t1 = time.perf_counter()
                solve_walls.append(t1 - t0)
                host = blob.cpu().numpy()      # the one commit transfer
                t2 = time.perf_counter()
                copy_walls.append(t2 - t1)
                record(rec, w, host)
                t3 = time.perf_counter()
                tel_walls.append(t3 - t2)
                cadence.append(t3 - t0)
        rec.flush()
        written, dropped = rec.stats()
        backend = rec.backend

    totals = np.asarray(cadence)
    p50 = float(np.percentile(totals, 50))
    breakdown = {}
    if not pipeline:
        pct = lambda v: float(np.percentile(np.asarray(v), 50))
        breakdown = {
            "solve_p50_ms": round(pct(solve_walls) * 1e3, 2),
            "commit_copy_p50_ms": round(pct(copy_walls) * 1e3, 2),
            "telemetry_push_p50_us": round(pct(tel_walls) * 1e6, 1),
        }
    progress = progress_hist[-1]
    return {
        "metric": ("serve_cadence_miss_rate_N50" if pipeline
                   else "serve_deadline_miss_rate_N50"),
        "value": round(int(np.sum(totals > DEADLINE_S)) / windows, 4),
        "unit": "fraction",
        "vs_baseline": round(DEADLINE_S / p50, 2),
        "windows": windows,
        "pipelined": pipeline,
        "deadline_ms": DEADLINE_S * 1e3,
        "p50_ms": round(p50 * 1e3, 2),
        "p99_ms": round(float(np.percentile(totals, 99)) * 1e3, 2),
        "max_ms": round(float(totals.max()) * 1e3, 2),
        **breakdown,
        "telemetry_backend": backend,
        "telemetry_records": written,
        "telemetry_dropped": dropped,
        "fused_kernels": solver == "fused" and dev.type == "cuda",
        "compile_wall_s": round(compile_wall, 1),
        "compile_cache_entries_at_start": 0,
        "initial_progress": round(progress_hist[0], 4),
        "final_progress": round(progress, 4),
        "progress_per_window": round(
            (progress - progress_hist[0]) / max(windows - 1, 1), 6),
        "resets": n_resets,
        "reset_viol": RESET_VIOL,
        "violation_units": "physical-unit-scaled",
        "mean_violation": round(float(np.mean(viol_hist)), 6),
        "p90_violation": round(float(np.percentile(viol_hist, 90)), 6),
        "device": _device_name(dev),
        "matmul_precision": matmul_precision(),
        "solver": solver,
        "horizon": horizon,
        "kernel_launches": kernel_launches(),
    }


WHOLE_GOAL = (146.0, 8.0, -195.0)
WHOLE_HORIZON = 297


def whole_problem(device="cuda"):
    """The whole mode's problem: the default-aero plant, its OCP toward
    ``WHOLE_GOAL`` (the reference's exact goal sits behind the start, out
    of reach in 2.97 s; this one is 146 m ahead, reached at the 50 m/s
    initial airspeed), the initial state, and the course the warm start's
    tracker flies (the Dubins line to the goal at the initial airspeed).
    Returns (params, ocp, x0, track_config)."""
    import dataclasses

    from aircraft_tpu_torch.control.aircraft import (build_aircraft_ocp,
                                                     goal_cost)

    dev = resolve_device(device)
    cfg = glider_config()
    params = AircraftParams.from_config(cfg.aircraft, device=dev)  # default aero
    stage0, terminal = goal_cost(WHOLE_GOAL, w_goal=1e-2, w_control=1e-2,
                                 device=dev)

    def stage(x, u, k):
        # every channel: goal_cost charges only the surfaces (u[:3])
        return stage0(x, u, k) + 1e-3 * torch.sum((u[..., 3:] / 10.0) ** 2,
                                                  dim=-1)

    ocp = build_aircraft_ocp(params, cfg, dt=DT, stage_cost=stage,
                             terminal_cost=terminal, quaternion="integration",
                             integration="explicit")
    x0 = torch.as_tensor(cfg.waypoints.initial_state, dtype=torch.float32,
                         device=dev)
    track_config = dataclasses.replace(cfg, waypoints=dataclasses.replace(
        cfg.waypoints, waypoints=(WHOLE_GOAL,), waypoint_indices=(0, 1, 2),
        default_velocity=50.0))
    return params, ocp, x0, track_config


def whole_goal_miss(sol) -> float:
    """Distance of the first scenario's final position from the goal."""
    goal = torch.as_tensor(WHOLE_GOAL, device=sol.xs.device)
    return float(torch.linalg.norm(sol.xs[0, -1, :3] - goal))


def bench_whole(device="cuda", *, horizon=WHOLE_HORIZON, al_iters=6,
                inner_iters=25, riccati_mode="sequential",
                penalty_init=10.0, window=50, overlap=30,
                warm_iters=(2, 10), reps=3) -> dict:
    """One whole-trajectory fixed-time solve of ``whole_problem`` from the
    receding-horizon tracker's controls (``warm_iters`` AL rounds x inner
    iterations per window, Gauss-Newton)."""
    from aircraft_tpu_torch.control.waypoints import receding_warm_start

    dev = resolve_device(device)
    params, ocp, x0, cfg1 = whole_problem(dev)
    config = SolverConfig(max_al_iters=al_iters, max_inner_iters=inner_iters,
                          hessian="gauss_newton", riccati=riccati_mode,
                          penalty_init=penalty_init)
    _sync(dev)
    t0 = time.perf_counter()
    us0 = receding_warm_start(
        params, cfg1, num_nodes=horizon, dt=DT, window=window,
        overlap=overlap, device=dev, solver_config=SolverConfig(
            max_al_iters=warm_iters[0], max_inner_iters=warm_iters[1],
            hessian="gauss_newton"))
    _sync(dev)
    warm_wall = time.perf_counter() - t0
    warm_launches = kernel_launches()

    def solve():
        return ilqr.solve_impl(ocp, x0[None], us0[None], config)

    t0 = time.perf_counter()
    sol = solve()
    _sync(dev)
    first_wall = time.perf_counter() - t0
    walls = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        sol = solve()
        _sync(dev)
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    finite = all(bool(torch.isfinite(t).all()) for t in (
        sol.xs, sol.us, sol.cost, sol.violation))
    return {
        "metric": f"whole_trajectory_solve_s_N{horizon}",
        "value": round(wall, 4),
        "unit": "s",
        "vs_baseline": round(12.0 / wall, 1),    # the reference's solver time
        "ref_wall_with_callback_s": 423.6,
        "horizon": horizon,
        "goal_miss_m": round(whole_goal_miss(sol), 2),
        "cost": round(float(sol.cost[0]), 2),
        "violation": round(float(sol.violation[0]), 3),
        "iterations": int(sol.iterations[0]),
        "compile_wall_s": round(first_wall, 1),
        "warm_start_wall_s": round(warm_wall, 2),
        "device": _card(dev),
        "matmul_precision": matmul_precision(),
        "al_iters": al_iters,
        "inner_iters": inner_iters,
        "wall_s_per_inner_iteration": round(wall / (al_iters * inner_iters),
                                            4),
        "reps": reps,
        "finite": finite,
        "warm_start_kernel_launches": warm_launches,
    }


# ---------------------------------------------------------------------------
# the fleet-scale modes: phase, warm, roofline, oppoints, scaling
# ---------------------------------------------------------------------------

ROOT = Path(__file__).resolve().parents[1]
OPPOINTS = "2x6,2x10,3x8,3x12r,3x16r,4x20r"
FEASIBLE_SHARE = 0.95        # the reference's practical-feasibility gate


def _runs_dir() -> Path:
    from aircraft_tpu_torch.kernels._build import BUILD_DIR

    return BUILD_DIR / "runs"


def _write_run(out: dict, name: str, path=None) -> Path:
    """The record as JSON at ``path``, or as ``<name>.json`` under the build
    directory's ``runs/`` (the reference writes ``data/runs/``)."""
    path = Path(path) if path is not None else _runs_dir() / f"{name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    return path


def initial_states(cfg, batch, device, seed=42):
    """(B, 14): the configured initial state at progress 0 plus 0.01 N(0, 1)
    on its 13 flight states, drawn from a ``torch.Generator`` (the
    reference's ``_bench_initial_states``)."""
    gen = torch.Generator().manual_seed(seed)
    x0 = torch.tensor(list(cfg.waypoints.initial_state) + [0.0],
                      dtype=torch.float32)
    noise = 0.01 * torch.randn((batch, 14), generator=gen)
    noise[:, 13] = 0.0
    return (x0 + noise).to(device)


def _launches_since(before: dict) -> dict:
    now = kernel_launches()
    return {k: now[k] - before[k] for k in now}


def _timed_calls(fn, reps, dev):
    """Median host wall of ``reps`` calls of fn() after one untimed call,
    each synchronised before and after."""
    fn()
    return _median_wall(fn, (), reps, dev)


def bench_phase(device="cuda", *, batch=256, horizon=N_HORIZON, reps=5,
                cuda_chol=False, glide=None) -> dict:
    """One inner iLQR iteration of the bench problem split into its
    pieces, each timed as its own call over the whole batch: the initial
    rollout, the linearisation, the Gauss-Newton expansion (residual
    form), the sequential Riccati sweep (on the batched-Cholesky kernel
    with ``cuda_chol``) and the line search over 12 step sizes (2^0 …
    2^-10 and 0).  States: ``initial_states``; zero controls.  Each time is
    the median of ``reps`` calls after an untimed one.

    ``linearize_s`` is the solver's own ``ilqr.linearize``, which already
    pushes one basis over [x; u]; ``linearize_fused_s`` (outside the total)
    is the reference's A/B form, one Jacobian of the step over the joined
    z = [x; u], so here the two time nearly the same work.  ``glide`` as
    ``build_problem``, here and in the other fleet-scale modes."""
    from aircraft_tpu_torch.ops.autodiff import batched_jacfwd

    dev = resolve_device(device)
    cfg, params, ocp, track, v_ref, spec = build_problem(dev, glide=glide)
    B, N, n = batch, horizon, 14
    x0s = initial_states(cfg, B, dev)
    us0 = torch.zeros((B, N, 7), device=dev)
    alphas = torch.tensor(ilqr.line_search_alphas(12), device=dev)
    reg = torch.full((B,), 1e-6, device=dev)
    ks = ilqr._knot_index(B, N, dev)

    def lin_fused(xs, us):
        z = torch.cat([ilqr._knots(xs[:, :-1]), ilqr._knots(us)], dim=-1)
        J = batched_jacfwd(lambda z: ocp.step(z[:, :n], z[:, n:], ks), z)
        return J[..., :n], J[..., n:]

    def backward():
        return riccati.backward_sequential(A, Bm, *quad, reg,
                                           cuda_chol=cuda_chol)

    # the data flow of one iteration, staged once
    xs, _ = ilqr.initial_rollout(ocp, x0s, us0)
    al0 = ocp_mod.init_al_state(ocp, x0s, us0[:, 0], N)
    A, Bm = ilqr.linearize(ocp, xs, us0)
    quad = tuple(ilqr._san(t, 1e8)
                 for t in ilqr.quadraticize_gn(ocp, al0, xs, us0))
    K, kff, *_ = backward()
    K, kff = torch.clamp(K, -50.0, 50.0), torch.clamp(kff, -50.0, 50.0)

    pieces = {
        "rollout_s": _timed_calls(
            lambda: ilqr.initial_rollout(ocp, x0s, us0), reps, dev),
        "linearize_s": _timed_calls(
            lambda: ilqr.linearize(ocp, xs, us0), reps, dev),
        "quadraticize_s": _timed_calls(
            lambda: ilqr.quadraticize_gn(ocp, al0, xs, us0), reps, dev),
    }
    before = kernel_launches()
    pieces["backward_s"] = _timed_calls(backward, reps, dev)
    chol_per_call = (_launches_since(before)["batched_cholesky_solve"]
                     / (reps + 1))
    pieces["forward_12alpha_s"] = _timed_calls(
        lambda: ilqr.forward_pass(ocp, al0, xs, us0, K, kff, alphas), reps,
        dev)
    total = sum(pieces.values())
    out = {
        "metric": "ilqr_inner_iteration_phase_split",
        "value": round(total, 5),
        "unit": "s/iteration",
        "vs_baseline": 1.0,
        "batch": B,
        "horizon": N,
        "use_residuals": True,
        "device": _card(dev),
    }
    out.update({k: round(v, 5) for k, v in pieces.items()})
    out.update({k[:-2] + "_frac": round(v / total, 3)
                for k, v in pieces.items()})
    out["linearize_fused_s"] = round(_timed_calls(
        lambda: lin_fused(xs, us0), reps, dev), 5)
    out.update({"reps": reps, "cuda_chol": cuda_chol,
                "backward_cholesky_launches_per_call": chol_per_call,
                "matmul_precision": matmul_precision(),
                "kernel_launches": kernel_launches()})
    return out


def bench_warm(device="cuda", *, batch=256, horizon=N_HORIZON, al_iters=2,
               inner_iters=6, ls=6, reg_escalate=100.0, row_penalty=False,
               windows=6, cuda_chol=False, glide=None) -> dict:
    """Steady receding-horizon throughput of ``ilqr.solve_batch``: a cold
    window from ``initial_states`` and zero controls, then ``windows`` warm
    windows, each from the state at the commit knot (N - 30) with the
    controls shifted and the last one held; the value is the fleet over
    the median warm window's wall (the reference's ``BENCH_MODE=warm``).
    ``cuda_chol`` puts the Riccati solves on the batched-Cholesky kernel."""
    dev = resolve_device(device)
    cfg, params, ocp, track, v_ref, spec = build_problem(dev, glide=glide)
    config = headline_config(al_iters, inner_iters, ls,
                             row_penalty=row_penalty,
                             reg_escalate=reg_escalate)
    B, N = batch, horizon
    commit = N - OVERLAP if N > OVERLAP else max(1, N // 2)

    def solve(z, us):
        return ilqr.solve_batch(ocp, z, us, config, cuda_chol=cuda_chol)

    before = kernel_launches()
    _sync(dev)
    t0 = time.perf_counter()
    sols = solve(initial_states(cfg, B, dev),
                 torch.zeros((B, N, 7), device=dev))
    _sync(dev)
    cold_wall = time.perf_counter() - t0
    walls = []
    for _ in range(windows):
        z = sols.xs[:, commit].contiguous()
        us = torch.cat([sols.us[:, commit:],
                        sols.us[:, -1:].expand(-1, commit, -1)],
                       dim=1).contiguous()
        _sync(dev)
        t0 = time.perf_counter()
        sols = solve(z, us)
        _sync(dev)
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    launches = _launches_since(before)
    passes = (1 + windows) * al_iters * inner_iters
    cost = sols.cost.detach().cpu().numpy()
    return {
        "metric": "6dof_nn_mpc_warm_window_solves_per_s_N50_per_chip",
        "value": round(B / wall, 2),
        "unit": "solves/s",
        "vs_baseline": round(B / wall / BASELINE_SOLVES_PER_S, 2),
        "batch": B,
        "warm_wall_s_per_window": round(wall, 4),
        "cold_wall_s": round(cold_wall, 1),
        "windows_timed": windows,
        "finite_fraction": round(float(np.isfinite(cost).mean()), 3),
        "mean_violation": round(float(np.nanmean(
            sols.violation.detach().cpu().numpy())), 4),
        "device": _card(dev),
        "horizon": N,
        "al_iters": al_iters,
        "inner_iters": inner_iters,
        "line_search_steps": ls,
        "penalty_per_row": row_penalty,
        "cuda_chol": cuda_chol,
        "backward_passes": passes,
        "cholesky_launches_per_backward_pass":
            launches["batched_cholesky_solve"] / passes,
        "kernel_launches": launches,
        "matmul_precision": matmul_precision(),
    }


def bench_roofline(device="cuda", *, batch=256, horizon=N_HORIZON,
                   al_iters=2, inner_iters=6, ls=6, reg_escalate=100.0,
                   row_penalty=False, reps=3, glide=None) -> dict:
    """Speed-of-light accounting of the fused window solve (the port's
    main path) on ``initial_states`` with zero controls: its work counted
    from the kernels' source (``roofline.solve_work``), its warm wall (the
    median of ``reps`` after an untimed solve) and the card's ceilings,
    picked by its name.  ``value`` = the bound's wall / the measured wall.

    The reference reads XLA's cost model (``xla_flops_per_batch``,
    ``xla_hbm_bytes_per_batch``); PyTorch has none, so
    ``counted_flops_per_batch`` and ``counted_bytes_per_batch`` take their
    place: the initial rollout and each inner iteration's two window
    kernels (``counted``).  The pieces under ``uncounted`` add work, so the
    fraction is a lower bound.  A card the table does not know (and the
    CPU) gives ``bound`` "unknown device" and value 0.0, as in the
    reference."""
    from aircraft_tpu_torch import roofline

    dev = resolve_device(device)
    cfg, params, ocp, track, v_ref, spec = build_problem(dev, glide=glide)
    config = headline_config(al_iters, inner_iters, ls,
                             row_penalty=row_penalty,
                             reg_escalate=reg_escalate)
    solve = make_fused_solver(ocp, spec, horizon, config)
    z0s = initial_states(cfg, batch, dev)
    us0 = torch.zeros((batch, horizon, 7), device=dev)
    flops, nbytes = roofline.solve_work(solve.operands, batch,
                                        al_iters * inner_iters)
    before = kernel_launches()
    wall = _timed_calls(lambda: solve(z0s, us0), reps, dev)
    out = {
        "metric": "roofline_speed_of_light_fraction",
        "unit": "fraction",
        "batch": batch,
        "wall_s": round(wall, 4),
        "counted_flops_per_batch": flops,
        "counted_bytes_per_batch": nbytes,
        "counted": list(roofline.COUNTED),
        "uncounted": list(roofline.UNCOUNTED),
        "achieved_gflops": round(flops / wall / 1e9, 1),
        "achieved_hbm_gbs": round(nbytes / wall / 1e9, 1),
        "arithmetic_intensity_flops_per_byte": round(flops / max(nbytes, 1),
                                                     2),
        "device": _card(dev),
        "horizon": horizon,
        "al_iters": al_iters,
        "inner_iters": inner_iters,
        "line_search_steps": ls,
        "reps": reps,
        "fused_kernels": dev.type == "cuda",
        "kernel_launches": _launches_since(before),
    }
    peak = roofline.peaks(_device_name(dev)) if dev.type == "cuda" else None
    if peak is None:
        out.update({"value": 0.0, "vs_baseline": 0.0,
                    "bound": "unknown device"})
        return out
    t_compute, t_memory = flops / peak[0], nbytes / peak[1]
    sol_wall = max(t_compute, t_memory)
    out.update({
        "value": sol_wall / wall,
        "vs_baseline": sol_wall / wall,
        "bound": "compute" if t_compute > t_memory else "memory",
        "sol_wall_s": sol_wall,
        "peak_tflops_f32": peak[0] / 1e12,
        "peak_hbm_gbs": peak[1] / 1e9,
    })
    return out


def parse_point(spec: str) -> tuple:
    """An operating point "ALxINNER[r]": (AL rounds, inner iterations,
    per-row penalty ratchet), the trailing "r" turning the ratchet on."""
    spec = spec.strip()
    al, inner = spec.rstrip("r").split("x")
    return int(al), int(inner), spec.endswith("r")


def best_point(rows) -> Optional[dict]:
    """The fastest row that clears the gate (converged_fraction_1e2 >=
    0.95), or None."""
    feasible = [r for r in rows
                if r.get("converged_fraction_1e2", 0) >= FEASIBLE_SHARE]
    return max(feasible, key=lambda r: r["solves_per_s"]) if feasible else None


def bench_oppoints(device="cuda", *, points=OPPOINTS, point_timeout=3600.0,
                   batch=256, horizon=N_HORIZON, ls=6, warmup=6, reps=3,
                   out_path=None, glide=None) -> dict:
    """The serving chain's operating points: each "ALxINNER[r]" of
    ``points`` is one headline chain (``python -m aircraft_tpu_torch.bench``
    in a subprocess on the same device, its own ``point_timeout``), and the
    value is the best throughput among the points that clear the gate, 0.0
    when none does (the reference's ``BENCH_MODE=oppoints``).  The record
    goes to ``out_path`` or ``build/aircraft_tpu_torch/runs/
    operating_points.json``; each row is printed to stderr as it is
    made.  ``glide``, when given, goes to each point as ``--glide``."""
    dev = resolve_device(device)
    pythonpath = [str(ROOT)] + ([os.environ["PYTHONPATH"]]
                                if os.environ.get("PYTHONPATH") else [])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(pythonpath))
    rows = []
    for spec in points.split(","):
        spec = spec.strip()
        al, inner, rowpen = parse_point(spec)
        cmd = [sys.executable, "-m", "aircraft_tpu_torch.bench",
               "--device", str(device), "--batch", str(batch),
               "--horizon", str(horizon), "--al-iters", str(al),
               "--inner-iters", str(inner), "--line-search", str(ls),
               "--warmup", str(warmup), "--reps", str(reps),
               "--row-penalty" if rowpen else "--no-row-penalty"]
        if glide is not None:
            cmd += ["--glide", ",".join(repr(float(g)) for g in glide)]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                                  text=True, timeout=point_timeout)
        except subprocess.TimeoutExpired:
            rows.append({"point": spec, "error": "timeout"})
            print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
            continue
        wall = time.perf_counter() - t0
        line = next((l for l in reversed(proc.stdout.strip().splitlines())
                     if l.startswith("{")), None)
        if proc.returncode != 0 or line is None:
            rows.append({"point": spec,
                         "error": (proc.stderr or proc.stdout)[-500:]})
        else:
            r = json.loads(line)
            rows.append({
                "point": spec, "al": al, "inner": inner, "rowpen": rowpen,
                "solves_per_s": r["value"],
                "mean_violation": r["mean_violation"],
                "median_violation": r["median_violation"],
                "p90_violation": r["p90_violation"],
                "converged_fraction_1e2": r["converged_fraction_1e2"],
                "converged_fraction_1e4": r.get("converged_fraction_1e4"),
                "diverged_fraction": r["diverged_fraction"],
                "mean_cost": r["mean_cost"],
                "violation_units": r["violation_units"],
                "batch": r["batch"], "device": r["device"],
                "subprocess_wall_s": round(wall, 1),
                "kernel_launches": r["kernel_launches"],
            })
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    best = best_point(rows)
    value = best["solves_per_s"] if best else 0.0
    out = {
        "metric": "serving_chain_feasible_operating_point_solves_per_s",
        "value": value,
        "unit": "solves/s",
        "vs_baseline": round(value / BASELINE_SOLVES_PER_S, 2),
        "gate": f"converged_fraction_1e2 >= {FEASIBLE_SHARE}",
        "best_point": best["point"] if best else None,
        "points": rows,
        "device": _card(dev),
    }
    out["written_to"] = str(_write_run(out, "operating_points", out_path))
    return out


def scaling_rank(mesh, job: dict, n_dev: int, mode: str) -> dict:
    """One (device count, mode) measurement on one rank of
    ``parallel.spawn``: ``solve_batch_sharded`` of the job's fleet, an
    untimed solve and then ``reps`` timed ones (the ranks meet at a
    barrier before each; the summary's host read waits for every rank)."""
    import torch.distributed as dist

    from aircraft_tpu_torch.parallel import solve_batch_sharded

    _, _, ocp, *_ = build_problem(mesh.device, glide=job["glide"])
    x0s = torch.as_tensor(job["z0s"], device=mesh.device)
    us0 = torch.as_tensor(job["us0"], device=mesh.device)

    def run():
        _, summary = solve_batch_sharded(ocp, x0s, us0, mesh, job["config"],
                                         cuda_chol=job["cuda_chol"])
        return [float(t) for t in summary]

    run()
    before = kernel_launches()
    walls = []
    for _ in range(job["reps"]):
        dist.barrier(group=mesh.group)
        t0 = time.perf_counter()
        n_conv, mean_cost, max_viol, _ = run()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    total = x0s.shape[0]
    return {
        "devices": n_dev,
        "mode": mode,
        "total_batch": total,
        "ranks": mesh.size,
        "wall_s": round(wall, 4),
        "solves_per_s": round(total / wall, 3),
        "mean_cost": round(mean_cost, 2),
        "max_violation": round(max_viol, 4),
        "n_converged": int(n_conv),
        "device": _card(mesh.device),
        "kernel_launches": _launches_since(before),
    }


def bench_scaling(device="cuda", *, devices=(1, 2, 4, 8), per_device=8,
                  horizon=N_HORIZON, al_iters=2, inner_iters=6, ls=6,
                  reg_escalate=100.0, row_penalty=False, reps=3,
                  cuda_chol=False, out_path=None, glide=None,
                  rank=None) -> dict:
    """Weak scaling of ``parallel.solve_batch_sharded`` (the reference's
    ``BENCH_MODE=scaling``): for each device count n, the ``sharded`` run
    (n ranks, ``per_device`` fleet scenarios each) and, for n > 1, the
    ``single`` run (the same n·per_device scenarios on one rank), each
    through ``parallel.spawn``.  ``weak_scaling_efficiency_raw`` is the
    1-rank wall over the n-rank wall; ``topology_efficiency`` the single
    wall over the sharded wall (the same total work, so it isolates the
    split and the collectives).

    On ``cuda`` each rank takes its own card over NCCL, and a count above
    the visible cards is not run: it is listed under ``skipped``.  On
    ``cpu`` the ranks are gloo processes with one thread each, standing
    in for the reference's virtual devices, and share the host's cores.
    A failing rank fails the call.  ``rank``: the function each rank runs
    (``scaling_rank``'s signature; by default ``scaling_rank``), found by
    its import path.  The record goes to ``out_path`` or
    ``build/aircraft_tpu_torch/runs/scaling_<device>.json``."""
    from aircraft_tpu_torch import parallel

    dev = resolve_device(device)
    if rank is None:
        # the ranks find the rank function by its import path, also when
        # this file runs as __main__
        from aircraft_tpu_torch import bench as this
        rank = this.scaling_rank
    if glide is None:
        glide = plant_best_glide(AircraftParams.from_config(
            glider_config().aircraft, coeff=load_mlp(device=dev),
            device=dev))
    cfg, params, ocp, track, v_ref, spec = build_problem(dev, glide=glide)
    config = headline_config(al_iters, inner_iters, ls,
                             row_penalty=row_penalty,
                             reg_escalate=reg_escalate)
    visible = torch.cuda.device_count() if dev.type == "cuda" else None
    rows, skipped, ran = [], [], []
    for n_dev in devices:
        if visible is not None and n_dev > visible:
            skipped.append({"devices": n_dev, "reason":
                            f"{visible} visible card(s); NCCL takes one "
                            "rank per card"})
            continue
        ran.append(n_dev)
        total = per_device * n_dev
        z0s, trim = fleet_states(params, track, total, v_ref)
        u_trim = ocp.control_unsquash(trim.control[:7])
        job = {"glide": glide, "config": config, "reps": reps,
               "cuda_chol": cuda_chol, "z0s": z0s.cpu().numpy(),
               "us0": u_trim.reshape(1, 1, 7).expand(
                   total, horizon, 7).cpu().numpy()}
        for mode in (["sharded"] if n_dev == 1 else ["sharded", "single"]):
            world = n_dev if mode == "sharded" else 1
            row = parallel.spawn(rank, world, device=device,
                                 args=(job, n_dev, mode))[0]
            rows.append(row)
            print(json.dumps(row), file=sys.stderr, flush=True)

    by = {(r["devices"], r["mode"]): r for r in rows}
    w1 = by.get((1, "sharded"), {}).get("wall_s")
    curve = {}
    for n_dev in ran:
        s = by.get((n_dev, "sharded"))
        if s is None or w1 is None:
            continue
        entry = {"solves_per_s": s["solves_per_s"], "wall_s": s["wall_s"],
                 "weak_scaling_efficiency_raw": round(w1 / s["wall_s"], 4)}
        sg = by.get((n_dev, "single"))
        if sg is not None:
            entry["topology_efficiency"] = round(sg["wall_s"] / s["wall_s"],
                                                 4)
            entry["single_device_same_batch_wall_s"] = sg["wall_s"]
        curve[f"{n_dev}dev"] = entry
    last = ran[-1] if ran else 0
    topo = curve.get(f"{last}dev", {}).get("topology_efficiency", 0.0)
    note = ("gloo processes on the host's cores stand in for devices and "
            "share them, so weak_scaling_efficiency_raw is bound by core "
            "contention (a lower bound only); topology_efficiency compares "
            "the SAME total batch on 1 rank and on n, identical compute, "
            "isolating the split and the collectives. Read the counts up to "
            "the core count for the topology signal"
            if dev.type == "cpu" else
            "one rank per card over NCCL; a count above the visible cards "
            "is not run (skipped)")
    out = {
        "metric": f"sharded_solve_topology_efficiency_{last}dev_{dev.type}",
        "value": topo,
        "unit": "fraction",
        "vs_baseline": topo,
        "per_device_batch": per_device,
        "host_physical_cores": os.cpu_count(),
        "note": note,
        "curve": curve,
        "rows": rows,
        "skipped": skipped,
        "horizon": horizon,
        "al_iters": al_iters,
        "inner_iters": inner_iters,
        "penalty_per_row": row_penalty,
        "cuda_chol": cuda_chol,
        "device": _card(dev),
    }
    out["written_to"] = str(_write_run(out, f"scaling_{dev.type}", out_path))
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", choices=("headline", "kernel", "chol",
                                      "riccati", "latency", "serve",
                                      "whole", "phase", "warm", "roofline",
                                      "oppoints", "scaling"),
                   default="headline")
    p.add_argument("--solver", choices=("fused", "ilqr"), default="fused")
    p.add_argument("--cuda-chol", action="store_true",
                   help="ilqr solver and the riccati, phase, warm and "
                   "scaling modes: Quu solves on the batched-Cholesky kernel")
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch", type=int, default=None,
                   help="256 (headline, phase, warm, roofline), 1024 "
                   "(kernel), 12800 (chol)")
    p.add_argument("--horizon", type=int, default=None,
                   help="50 (297 in the whole mode)")
    p.add_argument("--substeps", type=int, default=10, help="kernel mode")
    p.add_argument("--al-iters", type=int, default=None,
                   help="3 (6 in the whole mode; 2 in warm, roofline, "
                   "scaling)")
    p.add_argument("--inner-iters", type=int, default=None,
                   help="12 (25 in the whole mode; 6 in warm, roofline, "
                   "scaling)")
    p.add_argument("--line-search", type=int, default=6)
    p.add_argument("--row-penalty", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="the per-row penalty ratchet (on in the headline, "
                   "off in warm, roofline and scaling)")
    p.add_argument("--glide", default=None,
                   help="the plant's V_REF,GLIDE_LD when already found: "
                   "skips the best-glide trims")
    p.add_argument("--reg-escalate", type=float, default=100.0)
    p.add_argument("--warmup", type=int, default=6)
    p.add_argument("--reps", type=int, default=None,
                   help="timed windows (3) or timed calls (kernel 5, chol 7, "
                   "riccati 7, latency 30, phase 5, roofline 3, scaling 3)")
    p.add_argument("--horizons", default="50,200,800,3200",
                   help="riccati mode: comma-separated horizons")
    p.add_argument("--windows", type=int, default=None,
                   help="serve mode (50), warm mode's warm windows (6)")
    p.add_argument("--no-pipeline", action="store_true",
                   help="serve mode: the synchronous loop")
    p.add_argument("--window", type=int, default=50,
                   help="whole mode: the warm start's window")
    p.add_argument("--overlap", type=int, default=30,
                   help="whole mode: the warm start's window overlap")
    p.add_argument("--warm-iters", default="2,10",
                   help="whole mode: the warm start's AL rounds,inner "
                   "iterations per window")
    p.add_argument("--points", default=OPPOINTS,
                   help="oppoints mode: comma-separated ALxINNER[r]")
    p.add_argument("--point-timeout", type=float, default=3600.0,
                   help="oppoints mode: seconds per point")
    p.add_argument("--devices", default="1,2,4,8",
                   help="scaling mode: comma-separated device counts")
    p.add_argument("--per-device", type=int, default=8,
                   help="scaling mode: scenarios per rank")
    p.add_argument("--out", default=None,
                   help="oppoints and scaling modes: the record's path")
    p.add_argument("--seed", type=int, default=0,
                   help="the set-up's trim start clouds (best glide and "
                   "fleet trim, searched on the host in float64, so every "
                   "device builds the same problem): 0 takes the reference "
                   "bench's draw from jax.random.PRNGKey(0), any other "
                   "seed a torch.Generator draw")
    a = p.parse_args(argv)
    whole = a.mode == "whole"
    light = a.mode in ("warm", "roofline", "scaling")   # 2 x 6
    if a.horizon is None:
        a.horizon = WHOLE_HORIZON if whole else N_HORIZON
    if a.al_iters is None:
        a.al_iters = 6 if whole else 2 if light else 3
    if a.inner_iters is None:
        a.inner_iters = 25 if whole else 6 if light else 12
    if a.row_penalty is None:
        a.row_penalty = not light
    glide = (None if a.glide is None
             else tuple(float(g) for g in a.glide.split(",")))
    budget = dict(horizon=a.horizon, al_iters=a.al_iters,
                  inner_iters=a.inner_iters, ls=a.line_search)
    if whole:
        out = bench_whole(a.device, horizon=a.horizon, al_iters=a.al_iters,
                          inner_iters=a.inner_iters, window=a.window,
                          overlap=a.overlap, warm_iters=tuple(
                              int(i) for i in a.warm_iters.split(",")),
                          reps=3 if a.reps is None else a.reps)
    elif a.mode == "kernel":
        out = bench_kernel(a.device, batch=a.batch or 1024, horizon=a.horizon,
                           substeps=a.substeps, reps=a.reps or 5)
    elif a.mode == "chol":
        out = bench_chol(a.device, batch=a.batch or 256 * 50, reps=a.reps or 7)
    elif a.mode == "riccati":
        out = bench_riccati(a.device, horizons=tuple(
            int(h) for h in a.horizons.split(",")), reps=a.reps or 7,
            cuda_chol=a.cuda_chol)
    elif a.mode == "latency":
        out = bench_latency(a.device, horizon=a.horizon, al_iters=a.al_iters,
                            inner_iters=a.inner_iters, ls=a.line_search,
                            reps=30 if a.reps is None else a.reps,
                            solver=a.solver, seed=a.seed, glide=glide)
    elif a.mode == "serve":
        out = bench_serve(a.device, windows=a.windows or 50,
                          pipeline=not a.no_pipeline, horizon=a.horizon,
                          al_iters=a.al_iters, inner_iters=a.inner_iters,
                          ls=a.line_search, solver=a.solver, seed=a.seed,
                          glide=glide)
    elif a.mode == "phase":
        out = bench_phase(a.device, batch=a.batch or 256, horizon=a.horizon,
                          reps=a.reps or 5, cuda_chol=a.cuda_chol,
                          glide=glide)
    elif a.mode == "warm":
        out = bench_warm(a.device, batch=a.batch or 256, **budget,
                         reg_escalate=a.reg_escalate,
                         row_penalty=a.row_penalty,
                         windows=6 if a.windows is None else a.windows,
                         cuda_chol=a.cuda_chol, glide=glide)
    elif a.mode == "roofline":
        out = bench_roofline(a.device, batch=a.batch or 256, **budget,
                             reg_escalate=a.reg_escalate,
                             row_penalty=a.row_penalty,
                             reps=a.reps or 3, glide=glide)
    elif a.mode == "oppoints":
        out = bench_oppoints(a.device, points=a.points,
                             point_timeout=a.point_timeout,
                             batch=a.batch or 256, horizon=a.horizon,
                             ls=a.line_search, warmup=a.warmup,
                             reps=3 if a.reps is None else a.reps,
                             out_path=a.out, glide=glide)
    elif a.mode == "scaling":
        out = bench_scaling(a.device, devices=tuple(
            int(d) for d in a.devices.split(",")),
            per_device=a.per_device, **budget, reg_escalate=a.reg_escalate,
            row_penalty=a.row_penalty, reps=a.reps or 3,
            cuda_chol=a.cuda_chol, out_path=a.out, glide=glide)
    else:
        out = run_headline(a.device, batch=a.batch or 256, horizon=a.horizon,
                           al_iters=a.al_iters, inner_iters=a.inner_iters,
                           ls=a.line_search, warmup=a.warmup,
                           reps=3 if a.reps is None else a.reps, seed=a.seed,
                           solver=a.solver, cuda_chol=a.cuda_chol,
                           row_penalty=a.row_penalty,
                           reg_escalate=a.reg_escalate, glide=glide)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
