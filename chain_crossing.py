"""Set-up × solver crossing of the headline serving chain, on the CPU.

The port's headline chain (``aircraft_tpu_torch.bench.run_headline``) and
the reference's (``bench.py``'s chain on ``ilqr.solve_batch``, what it runs
off the TPU) each find their own set-up: the plant's best-glide speed and
L/D (which lays out the track's altitude profile), the fleet's stations
and the trim that seeds their controls.  This script separates the two
causes of a difference in the chain's quality, the set-up and the solver,
by running every solver on every set-up, window by window:

* ``trims`` (no JAX) runs the port's set-up trim searches start by
  start from the same start clouds on the CPU in float32 and float64 and,
  with ``--device cuda``, on the card: each start's residual, sideslip,
  L/D and controls, the start picked, and the float32 set-up found on
  each device from the torch clouds (``device_f32_setup``: the bench's
  set-up before its searches moved to the host; ``trims_<device>.json``);
* ``setup`` prints, for both packages, each candidate speed's L/D and the
  pick, the fleet trim (``multistart_trim`` at ``v_ref + 2``, 32 starts,
  coordinated) and the track's length and end altitude, and saves the
  set-ups as numpy arrays: ``ref``, ``host`` (what the port's bench
  builds on every device: its searches on the host in float64 from the
  reference's start clouds), ``port`` (``device_f32_setup`` on the CPU)
  and, when ``trims_cuda.json`` from a card run is under ``--out``,
  ``card`` (``device_f32_setup`` on the card, on the same stations);
* ``headline`` (no JAX) runs the port's headline chain at the bench's
  default depth on ``--device`` for each of ``--seeds`` (the set-up's
  start clouds: 0 the reference's) and prints each window's summary, the
  set-up and the gate (``headline_<device>.json``);
* an arm ``<solver>@<set-up>`` runs the chain (3 AL × 12 inner, row
  penalty, 6 step sizes, commit 20, reset at 5.0) for ``--windows`` (10)
  windows on the set-up's fleet rows ``[offset::stride]`` (32 of 256
  gliders) and prints each window's converged fraction at 1e-2, mean
  cost, mean violation and diverged fraction.  Solvers: ``ref`` (the JAX
  package's ``ilqr.solve_batch``, 8 gliders per call; it also saves the
  carry entering each window), ``ref-b32`` (the same, 32 gliders per
  call), ``port-ilqr`` and ``port-fused`` (the port on the CPU, every
  kernel in its plain version);
* ``batch-<f32|f64>@<set-up>`` solves the reference's cold window on the
  32 gliders as batches of 1, 8 and 32, in float32 or float64, and the
  port's ``solve_batch`` as batches of 8 and 32: how far each glider's
  answer moves with the batch layout alone;
* ``same-<port solver>@<set-up>`` solves each window of the port from the
  ``ref`` arm's own carry into it and lists the gliders whose cost parts
  from the reference's by more than 1%;
* ``table`` prints the arms side by side, on the rows ``[::stride]`` and,
  for each arm run on every offset, on the whole fleet (``--card-log``:
  with the card's own chain, read from a ``chip_smoke.py`` log), and
  whether each tracks ``ref`` on its set-up (mean cost within 5%, mean
  violation within 0.3·(1+v));
* ``all`` (the default) runs the set-up, then the chain arms of every
  set-up found as parallel processes (one torch thread each), and prints
  the table.

    python chain_crossing.py [--out build/aircraft_tpu_torch/chain_crossing]
        [--arm all|setup|trims|headline|table|<solver>@<set-up>
         |batch-<dtype>@<set-up>|same-<solver>@<set-up>] [--stride 8]
        [--offset 0] [--windows 10] [--device cuda] [--seeds 0,1,2,3]
        [--card-log chip_smoke.log]

The reference arms import JAX; the port's package imports none of it.
Writes ``setups.npz``, ``<arm>.json`` (``<arm>+<offset>.json`` for an
offset above 0; ``ref@<set-up>_carry.npz``) and ``table.json`` under
``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SOLVERS = ("ref", "ref-b32", "port-ilqr", "port-fused")
SETUPS = ("ref", "host", "port", "card")
ARMS = tuple(f"{s}@{u}" for u in SETUPS for s in SOLVERS)
SAME = tuple(f"same-{s}@{u}" for u in SETUPS
             for s in ("port-ilqr", "port-fused"))
FLEET = 256
REF_CHUNK = 8   # the reference's batch per solve_batch call (``ref``)
# The reference bench's set-up for data/networks/mlp.npz, as ``--arm
# setup`` finds it (``reference_constants_match``): its best glide (v_ref,
# 90% of the best L/D) and its fleet trim's controls.
REFERENCE_GLIDE = (32.0, 9.444397062835858)
REFERENCE_TRIM_CONTROL = (0.37900492548942566, 4.368319988250732,
                          0.10321048647165298, 0.0, 0.0, 0.0, 0.0,
                          -0.09192918986082077, -0.03432433679699898,
                          0.022375985980033875)
AL_FIELDS = ("lam_ineq", "lam_eq", "lam_t_ineq", "lam_t_eq", "mu", "mu_row")
SPEEDS = (24.0, 28.0, 32.0)
BATCH = tuple(f"batch-{d}@{u}" for u in SETUPS for d in ("f32", "f64"))


def _jax():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                          str(ROOT / "build" / "jax_cache"))
    sys.path.insert(0, str(ROOT))
    import bench as ref_bench  # the reference bench: its set-up functions
    return ref_bench


def _ld(state) -> float:
    vel = np.asarray(state, np.float64)[3:6]
    gamma = float(np.arctan2(vel[2], np.hypot(vel[0], vel[1])))
    return 1.0 / max(np.tan(gamma), 1e-3)


def setup(out: Path) -> dict:
    """Both packages' set-ups, printed and saved to ``setups.npz``."""
    import jax
    import torch

    ref_bench = _jax()
    from aircraft_tpu.solvers.trim import multistart_trim as ref_trim

    from aircraft_tpu_torch import bench as port_bench

    cfg, jparams, _, jtrack, jv, _ = ref_bench._build_problem()
    rows = {}
    for v in SPEEDS:
        t = ref_trim(jparams, jax.random.PRNGKey(0), n_starts=8,
                     target_airspeed=v, prefer_coordinated=True)
        rows.setdefault("ref", []).append((v, _ld(t.state)))
    _, hparams, _, htrack, hv, _ = port_bench.build_problem("cpu")
    for v in SPEEDS:
        t = port_bench.setup_trim(hparams, 8, v)
        rows.setdefault("host", []).append((v, _ld(t.state)))
    hz, ht = port_bench.fleet_states(hparams, htrack, FLEET, hv)
    (pv, p_ld), pt, lds = device_f32_setup(hparams)
    rows["port"] = lds
    _, _, _, ptrack, _, _ = port_bench.build_problem("cpu", glide=(pv, p_ld))
    pz = torch.as_tensor(port_bench.fleet_rows(ptrack, FLEET, pv))
    jz, jt = ref_bench._bench_fleet_states(cfg, jparams, jtrack, FLEET, jv)
    saved, report = {}, {}
    for name, v_ref, track, z, trim in (
            ("ref", jv, jtrack, jz, jt), ("host", hv, htrack, hz, ht),
            ("port", pv, ptrack, pz, pt)):
        lds = rows[name]
        best = max(lds, key=lambda r: r[1])
        pts = np.asarray(track.track_points)
        saved[f"{name}_glide"] = np.array([best[0], 0.9 * best[1]])
        saved[f"{name}_z0s"] = np.asarray(z, np.float32)
        saved[f"{name}_trim_state"] = np.asarray(trim.state, np.float32)
        saved[f"{name}_trim_control"] = np.asarray(trim.control, np.float32)
        saved[f"{name}_track"] = pts.astype(np.float32)
        report[name] = {
            "ld_per_speed": {f"{v:g}": round(ld, 4) for v, ld in lds},
            "v_ref": float(v_ref), "glide_ld": round(0.9 * best[1], 4),
            "trim_state": np.round(np.asarray(trim.state), 5).tolist(),
            "trim_control": np.round(np.asarray(trim.control), 5).tolist(),
            "track_length_m": round(float(track.length()), 3),
            "track_end_altitude_m": round(float(-pts[-1, 2]), 3),
            "track_start_altitude_m": round(float(-pts[0, 2]), 3)}
    report["reference_constants_match"] = bool(
        np.allclose(saved["ref_glide"], REFERENCE_GLIDE)
        and np.allclose(saved["ref_trim_control"], REFERENCE_TRIM_CONTROL))
    card = out / "trims_cuda.json"
    if card.exists():
        # the set-up the bench finds on the card (``--arm trims --device
        # cuda`` run there): the same stations laid out on its glide
        found = json.loads(card.read_text())["cuda-f32"]["setup"]
        v_ref, glide_ld = found["glide"]
        _, _, _, track, _, _ = port_bench.build_problem(
            "cpu", glide=(v_ref, glide_ld))
        saved["card_glide"] = np.array([v_ref, glide_ld])
        saved["card_z0s"] = port_bench.fleet_rows(track, FLEET, v_ref)
        saved["card_trim_control"] = np.array(found["trim_control"],
                                               np.float32)
        report["card"] = {"v_ref": v_ref, "glide_ld": round(glide_ld, 4),
                          "trim_control": np.round(
                              saved["card_trim_control"], 5).tolist()}
    for name in ("host", "port"):
        report[f"{name}_track_max_abs_diff_m"] = float(np.abs(
            saved["ref_track"] - saved[f"{name}_track"]).max())
        report[f"{name}_fleet_max_abs_diff"] = float(np.abs(
            saved["ref_z0s"] - saved[f"{name}_z0s"]).max())
    report["host_glide_ld_rel_to_reference"] = float(
        saved["host_glide"][1] / REFERENCE_GLIDE[1] - 1.0)
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / "setups.npz", **saved)
    (out / "setup.json").write_text(json.dumps(report, indent=1))
    return report


def device_f32_setup(params):
    """The set-up the port's bench found before its searches moved to the
    host: ``multistart_trim`` in float32 on ``params``' device from
    ``torch.Generator().manual_seed(0)`` clouds, 8 starts per candidate
    speed and 32 for the fleet trim at ``v_ref + 2``.  Returns ((v_ref,
    glide_ld), fleet trim, [(speed, L/D)])."""
    import torch

    from aircraft_tpu_torch.solvers.trim import multistart_trim

    lds = []
    for v in SPEEDS:
        t = multistart_trim(params, n_starts=8, target_airspeed=v,
                            prefer_coordinated=True,
                            generator=torch.Generator().manual_seed(0))
        lds.append((v, _ld(t.state.detach().cpu().numpy())))
    v_ref, ld = max(lds, key=lambda r: r[1])
    trim = multistart_trim(params, n_starts=32, target_airspeed=v_ref + 2.0,
                           prefer_coordinated=True,
                           generator=torch.Generator().manual_seed(0))
    return (v_ref, 0.9 * ld), trim, lds


def _trim_table(params, z0s, v, dtype):
    """Every start of one trim search at ``v`` m/s: the port's
    Levenberg-Marquardt (``solve_trim``) from ``z0s`` in ``dtype``, and
    the start ``multistart_trim(prefer_coordinated=True)`` picks when one
    converges."""
    import torch

    from aircraft_tpu_torch.ops import quaternion as quat
    from aircraft_tpu_torch.solvers.trim import (default_trim_bounds,
                                                 solve_trim)

    dev = params.device
    lb, ub = (torch.as_tensor(b, dtype=dtype, device=dev)
              for b in default_trim_bounds())
    z0 = torch.minimum(torch.maximum(z0s.to(dev, dtype), lb), ub)
    p = params.to(dtype) if dtype != torch.float32 else params
    sols = solve_trim(p, z0, (lb, ub), v)
    lat = torch.abs(quat.rotate_inv(sols.state[:, 6:10],
                                    sols.state[:, 3:6])[:, 1])
    score = torch.where(sols.residual < 1e-3, lat, 1e6 + sols.residual)
    st = sols.state.detach().cpu().double().numpy()
    ct = sols.control.detach().cpu().double().numpy()
    res = sols.residual.detach().cpu().double().numpy()
    starts = [{"residual": float(res[i]),
               "lateral_mps": float(lat[i]),
               "speed": float(np.linalg.norm(st[i, 3:6])),
               "ld": _ld(st[i]),
               "aileron_elevator_rudder": ct[i, :3].tolist(),
               "com": ct[i, 7:10].tolist()} for i in range(len(res))]
    return {"pick": int(torch.argmin(score)), "starts": starts}


def trims(out: Path, device: str) -> dict:
    """The port's set-up trims, start by start, on ``device`` in float32
    and on the CPU in float32 and float64, from the same start clouds
    (``start_cloud`` on a CPU generator, seed 0): each candidate speed's 8
    starts (``plant_best_glide``) and the fleet trim's 32 at 30 and 34
    m/s (``fleet_states`` at ``v_ref + 2``).  Imports no JAX."""
    import torch

    from aircraft_tpu_torch.config import glider_config
    from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
    from aircraft_tpu_torch.dynamics.coefficients import load_mlp
    from aircraft_tpu_torch.solvers.trim import start_cloud

    cfg = glider_config()
    runs = {"cpu-f32": ("cpu", torch.float32),
            "cpu-f64": ("cpu", torch.float64)}
    if device != "cpu":
        runs[f"{device}-f32"] = (device, torch.float32)
    report = {}
    for name, (dev, dtype) in runs.items():
        params = AircraftParams.from_config(
            cfg.aircraft, coeff=load_mlp(device=dev), device=dev)
        cases = {}
        for v, n in [(s, 8) for s in SPEEDS] + [(30.0, 32), (34.0, 32)]:
            z0s = start_cloud(n, torch.Generator().manual_seed(0), "cpu")
            cases[f"{v:g}m/s x{n}"] = _trim_table(params, z0s, v, dtype)
        if dtype == torch.float32:
            # the float32 set-up on this device (``device_f32_setup``)
            glide, trim, _ = device_f32_setup(params)
            cases["plant_best_glide"] = glide
            cases["setup"] = {"glide": list(glide), "trim_control":
                              trim.control.cpu().double().tolist()}
        report[name] = cases
        print(name, json.dumps({
            k: (c if k in ("plant_best_glide", "setup") else
                {"pick": c["pick"], "ld": round(c["starts"][c["pick"]]["ld"],
                                                4),
                 "elevator": round(c["starts"][c["pick"]][
                     "aileron_elevator_rudder"][1], 5),
                 "converged": sum(s["residual"] < 1e-3
                                  for s in c["starts"])})
            for k, c in cases.items()}), flush=True)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"trims_{device}.json").write_text(json.dumps(report, indent=1))
    return report


def headline(out: Path, device: str, seeds, windows: int = 10) -> dict:
    """The port's headline chain at the bench's default depth (a cold, 6
    warm-up and 3 timed windows of the whole fleet, ``bench.run_headline``)
    on ``device`` for each seed of the set-up's start clouds: the set-up,
    each window's summary and the gate (``headline_<device>.json``).
    Imports no JAX."""
    import torch

    from aircraft_tpu_torch import bench as port_bench
    from aircraft_tpu_torch.config import glider_config
    from aircraft_tpu_torch.control.course import course_track
    from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
    from aircraft_tpu_torch.dynamics.coefficients import load_mlp
    from aircraft_tpu_torch.kernels import window

    report = {"device": port_bench._card(torch.device(device))}
    params = AircraftParams.from_config(
        glider_config().aircraft, coeff=load_mlp(device=device),
        device=device)
    for seed in seeds:
        glide = port_bench.plant_best_glide(params, seed=seed)
        _, trim = port_bench.fleet_states(params, course_track(
            glider_config(), v_ref=glide[0], glide_ld=glide[1]), 1, glide[0],
            seed=seed)
        rows = []

        def on_window(w, sols):
            rows.append({"window": w, **window_row(
                sols.violation.detach().cpu().numpy(),
                sols.cost.detach().cpu().numpy())})
            print(f"seed {seed} window {w}: {json.dumps(rows[-1])}",
                  flush=True)

        window.reset_launch_counts()     # this seed's chain only
        head = port_bench.run_headline(device, seed=seed, glide=glide,
                                       warmup=windows - 4, on_window=on_window)
        report[f"seed {seed}"] = {
            "glide": list(glide),
            "trim_control": trim.control.cpu().double().tolist(),
            "windows": rows,
            "gate_passed": head["feasibility_gate_95pct_1e2_passed"],
            "converged_fraction_1e2": head["converged_fraction_1e2"],
            "wall_s_per_batch": head["wall_s_per_batch"],
            "kernel_launches": head["kernel_launches"]}
        print(f"seed {seed}: set-up {json.dumps(list(glide))}, gate "
              f"{head['feasibility_gate_95pct_1e2_passed']} (converged "
              f"fraction {head['converged_fraction_1e2']})", flush=True)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"headline_{device}.json").write_text(json.dumps(report, indent=1))
    return report


def _arrays(out: Path, name: str, stride: int, offset: int = 0):
    with np.load(out / "setups.npz") as d:
        v_ref, glide_ld = (float(x) for x in d[f"{name}_glide"])
        return (v_ref, glide_ld, d[f"{name}_z0s"][offset::stride].copy(),
                d[f"{name}_trim_control"].copy())


def _row(w, viol, cost, t0) -> dict:
    """One window's printed summary (``bench.window_summary``); the saved
    row also keeps every scenario's cost and violation."""
    from aircraft_tpu_torch.bench import window_summary

    row = {"window": w, **window_summary(viol, cost),
           "wall_s": round(time.perf_counter() - t0, 2)}
    print(json.dumps(row), flush=True)
    return {**row, "cost": np.asarray(cost, np.float64).tolist(),
            "violation": np.asarray(viol, np.float64).tolist()}


def _reference_problem(v_ref, glide_ld):
    """The reference bench's window OCP on the given set-up (``bench.py``
    ``_build_problem`` from (v_ref, glide_ld)) and its headline budget:
    (ocp, config, N)."""
    ref_bench = _jax()
    from aircraft_tpu.config import SolverConfig, glider_config
    from aircraft_tpu.control.course import COURSE_OCP_KNOBS, course_track
    from aircraft_tpu.control.mhtt import build_mhtt_ocp
    from aircraft_tpu.dynamics.aircraft import AircraftParams
    from aircraft_tpu.dynamics.coefficients import default_nn_coeff

    cfg = glider_config()
    params = AircraftParams.from_config(cfg.aircraft, coeff=default_nn_coeff())
    track = course_track(cfg, v_ref=v_ref, glide_ld=glide_ld)
    z_end = float(np.asarray(track.track_points)[:, 2].max())
    track.track_points = track.track_points.at[:, 2].add(
        -max(0.0, z_end + 20.0))
    knobs = dict(COURSE_OCP_KNOBS)
    knobs["envelope_overrides"] = {**(knobs.get("envelope_overrides") or {}),
                                   "unit_scales": True}
    knobs["squash_box"] = True
    ocp = build_mhtt_ocp(params, cfg, track.track_points, track.length(),
                         dt=ref_bench.DT, v_ref=v_ref, spec_out={}, **knobs)
    config = SolverConfig(max_al_iters=3, max_inner_iters=12,
                          line_search_steps=6, hessian="gauss_newton",
                          reg_escalate=100.0, penalty_per_row=True)
    return ocp, config, ref_bench.N_HORIZON


def reference_chain(v_ref, glide_ld, z0s, u_trim, windows, chunk=None,
                    carry_out=None):
    """The reference bench's chain (``bench.py`` main, ``BENCH_FUSED=0``)
    on the given set-up; one summary per window.  ``chunk``: solve the
    fleet as batches of that many gliders (one ``solve_batch`` each per
    window; every glider's chain is its own, so only the batch shape of
    the compiled program changes), else as one batch.  ``carry_out``: a
    path to save the carry entering each window (state, controls and
    multipliers) as numpy arrays."""
    import jax
    import jax.numpy as jnp

    from aircraft_tpu.solvers import ilqr
    from aircraft_tpu.solvers import ocp as ocp_mod

    ocp, config, N = _reference_problem(v_ref, glide_ld)
    B = chunk or z0s.shape[0]
    u0 = ocp.control_unsquash(jnp.asarray(u_trim, jnp.float32)[:7])
    us0 = jnp.array(jnp.tile(u0[None, None, :], (B, N, 1)), jnp.float32)
    commit, reset = N - 30, 5.0

    def chain_step(z, us, al, us_reset, al_reset):
        sols = ilqr.solve_batch(ocp, z, us, config, al_inits=al)
        z_next = sols.xs[:, commit]
        us_next = jnp.concatenate(
            [sols.us[:, commit:], jnp.tile(sols.us[:, -1:], (1, commit, 1))],
            axis=1)
        al_next = jax.vmap(lambda a, v: ocp_mod.shift_al_state(
            a, commit, mu0=config.penalty_init,
            decay=ocp_mod.gated_decay(v, reset)))(sols.al, sols.violation)
        bad = sols.violation > reset
        us_next = jnp.where(bad[:, None, None], us_reset, us_next)
        al_next = jax.tree.map(
            lambda car, cold: jnp.where(
                bad.reshape((-1,) + (1,) * (car.ndim - 1)), cold, car),
            al_next, al_reset)
        return z_next, us_next, al_next, sols.cost, sols.violation

    chain = jax.jit(chain_step)
    carries, cold, rows = [], [], []
    for i in range(0, z0s.shape[0], B):
        x0s = jnp.asarray(z0s[i:i + B])
        al0 = jax.vmap(lambda x, u: ocp_mod.init_al_state(
            ocp, x, u, N, mu0=config.penalty_init))(x0s, us0[:, 0])
        # strongly typed, as the chain's outputs are: the second window
        # then reuses the first one's program instead of compiling again
        cold.append(jax.tree.map(lambda t: jnp.array(t, dtype=t.dtype), al0))
        carries.append((x0s, us0, cold[-1]))
    saved = {}
    with jax.default_matmul_precision("highest"):
        for w in range(windows):
            t0 = time.perf_counter()
            costs, viols = [], []
            if carry_out is not None:
                saved[f"w{w}_z"] = np.concatenate(
                    [np.asarray(c[0]) for c in carries])
                saved[f"w{w}_us"] = np.concatenate(
                    [np.asarray(c[1]) for c in carries])
                for f in AL_FIELDS:
                    saved[f"w{w}_{f}"] = np.concatenate(
                        [np.asarray(getattr(c[2], f)) for c in carries])
            for j, (z, us, al) in enumerate(carries):
                z, us, al, cost, viol = chain(z, us, al, us0, cold[j])
                carries[j] = (z, us, al)
                costs.append(np.asarray(cost))
                viols.append(np.asarray(viol))
            rows.append(_row(w, np.concatenate(viols),
                             np.concatenate(costs), t0))
    if carry_out is not None:
        np.savez(carry_out, **saved)
    return rows


def port_chain(v_ref, glide_ld, z0s, u_trim, windows, solver):
    """The port's chain (``bench.headline_chain``) on the CPU on the given
    set-up; one summary per window."""
    import torch

    from aircraft_tpu_torch import bench as port_bench
    from aircraft_tpu_torch.solvers import ocp as ocp_mod

    torch.set_float32_matmul_precision("highest")
    _, _, ocp, _, _, spec = port_bench.build_problem(
        "cpu", glide=(v_ref, glide_ld))
    config = port_bench.headline_config()
    B, N = z0s.shape[0], port_bench.N_HORIZON
    z = torch.as_tensor(z0s)
    u0 = ocp.control_unsquash(torch.as_tensor(u_trim)[:7])
    us0 = u0.reshape(1, 1, 7).expand(B, N, 7).contiguous()
    al0 = ocp_mod.init_al_state(ocp, z, us0[:, 0], N, mu0=config.penalty_init)
    step = port_bench.headline_chain(ocp, spec, config, us0, al0,
                                     solver=solver)
    us, al, rows = us0, al0, []
    for w in range(windows):
        t0 = time.perf_counter()
        z, us, al, sols = step(z, us, al)
        rows.append(_row(w, sols.violation.numpy(), sols.cost.numpy(), t0))
    return rows


def _arm_file(out: Path, arm: str, offset: int) -> Path:
    return out / (f"{arm}.json" if offset == 0 else f"{arm}+{offset}.json")


def run_arm(arm: str, out: Path, stride: int, windows: int,
            offset: int = 0) -> list:
    """One arm on the fleet rows ``[offset::stride]``."""
    solver, name = arm.split("@")
    v_ref, glide_ld, z0s, u_trim = _arrays(out, name, stride, offset)
    if solver.startswith("ref"):
        rows = reference_chain(v_ref, glide_ld, z0s, u_trim, windows,
                               None if solver == "ref-b32" else REF_CHUNK,
                               out / f"{arm}_carry.npz"
                               if solver == "ref" and offset == 0 else None)
    else:
        rows = port_chain(v_ref, glide_ld, z0s, u_trim, windows,
                          solver.split("-")[1])
    _arm_file(out, arm, offset).write_text(json.dumps(rows, indent=1))
    return rows


def same_inputs(out: Path, name: str, solver: str, windows) -> list:
    """Each window of the port's ``solver`` solved from the reference
    chain's own carry into it (``ref@<name>_carry.npz``), against the
    reference's window: per window the population comparison and the
    scenarios whose cost differs by more than 1%."""
    import torch

    from aircraft_tpu_torch import bench as port_bench
    from aircraft_tpu_torch.solvers import ocp as ocp_mod

    torch.set_float32_matmul_precision("highest")
    v_ref, glide_ld, _, u_trim = _arrays(out, name, 1)
    ref_rows = json.loads((out / f"ref@{name}.json").read_text())
    _, _, ocp, _, _, spec = port_bench.build_problem(
        "cpu", glide=(v_ref, glide_ld))
    config = port_bench.headline_config()
    rows = []
    with np.load(out / f"ref@{name}_carry.npz") as c:
        for w in windows:
            z = torch.as_tensor(c[f"w{w}_z"])
            us = torch.as_tensor(c[f"w{w}_us"])
            al = ocp_mod.ALState(*(torch.as_tensor(c[f"w{w}_{f}"])
                                   for f in AL_FIELDS))
            step = port_bench.headline_chain(ocp, spec, config, us, al,
                                             solver=solver)
            t0 = time.perf_counter()
            sols = step(z, us, al)[3]
            row = _row(w, sols.violation.numpy(), sols.cost.numpy(), t0)
            ref = np.asarray(ref_rows[w]["cost"])
            rel = np.abs(np.asarray(row["cost"]) - ref) / np.abs(ref)
            row["tracks_reference"] = tracks([row], [ref_rows[w]])[0]
            row["scenarios_cost_off_1pct"] = np.flatnonzero(
                rel > 0.01).tolist()
            row["max_cost_rel_diff"] = float(rel.max())
            print(json.dumps({k: row[k] for k in (
                "window", "tracks_reference", "scenarios_cost_off_1pct",
                "max_cost_rel_diff")}), flush=True)
            rows.append(row)
    return rows


def batch_dependence(out: Path, name: str, dtype: str) -> dict:
    """The reference's cold window (``ilqr.solve_batch``) on the set-up's
    32 gliders, solved as batches of 1, 8 and 32 in ``dtype`` (float32 or
    float64, JAX's x64 mode), and the port's ``ilqr.solve_batch`` on the
    CPU as batches of 8 and 32 in float32: every glider's cost and
    violation per batch size, and the gliders whose cost parts by more
    than 1% between two batch sizes of one code."""
    import jax

    if dtype == "f64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    from aircraft_tpu.solvers import ilqr
    from aircraft_tpu.solvers import ocp as ocp_mod
    from aircraft_tpu_torch import bench as port_bench
    from aircraft_tpu_torch.solvers import ilqr as port_ilqr
    from aircraft_tpu_torch.solvers import ocp as port_ocp

    v_ref, glide_ld, z0s, u_trim = _arrays(out, name, 8)
    jdt = jnp.float64 if dtype == "f64" else jnp.float32
    ocp, config, N = _reference_problem(v_ref, glide_ld)
    u0 = ocp.control_unsquash(jnp.asarray(u_trim[:7], jdt))

    def ref_solve(z):
        us = jnp.tile(u0[None, None, :], (z.shape[0], N, 1))
        al = jax.vmap(lambda x, u: ocp_mod.init_al_state(
            ocp, x, u, N, mu0=config.penalty_init))(z, us[:, 0])
        sols = ilqr.solve_batch(ocp, z, us, config, al_inits=al)
        return sols.cost, sols.violation

    solve = jax.jit(ref_solve)
    runs = {}
    with jax.default_matmul_precision("highest"):
        for b in (1, 8, 32):
            t0 = time.perf_counter()
            cost, viol = [], []
            for i in range(0, len(z0s), b):
                c, v = solve(jnp.asarray(z0s[i:i + b], jdt))
                cost.append(np.asarray(c, np.float64))
                viol.append(np.asarray(v, np.float64))
            runs[f"ref-b{b}"] = (np.concatenate(cost), np.concatenate(viol))
            print(f"ref-b{b} {dtype}", json.dumps(window_row(*runs[
                f"ref-b{b}"][::-1])), f"{time.perf_counter() - t0:.1f} s",
                flush=True)
    if dtype == "f32":
        torch.set_float32_matmul_precision("highest")
        _, _, pocp, _, _, _ = port_bench.build_problem(
            "cpu", glide=(v_ref, glide_ld))
        pconfig = port_bench.headline_config()
        pu0 = pocp.control_unsquash(torch.as_tensor(u_trim[:7]))
        for b in (8, 32):
            cost, viol = [], []
            for i in range(0, len(z0s), b):
                z = torch.as_tensor(z0s[i:i + b])
                us = pu0.reshape(1, 1, 7).expand(len(z), N, 7).contiguous()
                al = port_ocp.init_al_state(pocp, z, us[:, 0], N,
                                            mu0=pconfig.penalty_init)
                sols = port_ilqr.solve_batch(pocp, z, us, pconfig,
                                             al_inits=al)
                cost.append(sols.cost.double().numpy())
                viol.append(sols.violation.double().numpy())
            runs[f"port-ilqr-b{b}"] = (np.concatenate(cost),
                                       np.concatenate(viol))
            print(f"port-ilqr-b{b} f32", json.dumps(window_row(*runs[
                f"port-ilqr-b{b}"][::-1])), flush=True)
    report = {k: {"cost": c.tolist(), "violation": v.tolist(),
                  **window_row(v, c)} for k, (c, v) in runs.items()}
    keys = list(runs)
    for i, a in enumerate(keys):
        for b in keys[i + 1:]:
            ca, cb = runs[a][0], runs[b][0]
            rel = np.abs(ca - cb) / np.abs(cb)
            report[f"{a} vs {b}"] = {
                "gliders_cost_off_1pct": np.flatnonzero(rel > 0.01).tolist(),
                "max_cost_rel_diff": float(rel.max())}
            print(f"{a} vs {b}", json.dumps(report[f"{a} vs {b}"]),
                  flush=True)
    (out / f"batch-{dtype}@{name}.json").write_text(
        json.dumps(report, indent=1))
    return report


def window_row(viol, cost) -> dict:
    from aircraft_tpu_torch.bench import window_summary

    return {k: round(v, 6) for k, v in window_summary(viol, cost).items()}


def tracks(rows, ref_rows) -> list:
    """Per window, whether ``rows`` holds ``ref_rows`` at the population
    tolerance: mean cost within 5%, mean violation within 0.3·(1 + v)."""
    ok = []
    for r, q in zip(rows, ref_rows):
        ok.append(bool(
            abs(r["mean_cost"] - q["mean_cost"]) <= 0.05 * abs(q["mean_cost"])
            and abs(r["mean_violation"] - q["mean_violation"])
            <= 0.3 * (1.0 + q["mean_violation"])))
    return ok


def _merged(out: Path, arm: str, stride: int):
    """The arm's rows over the whole fleet, window by window, from its
    runs on every offset ``0 .. stride - 1``; None while one is missing."""
    parts = [_arm_file(out, arm, k) for k in range(stride)]
    if not all(p.exists() for p in parts):
        return None
    runs = [json.loads(p.read_text()) for p in parts]
    rows = []
    for w in range(min(len(r) for r in runs)):
        cost = np.concatenate([r[w]["cost"] for r in runs])
        viol = np.concatenate([r[w]["violation"] for r in runs])
        rows.append({"window": w, **window_row(viol, cost),
                     "cost": cost.tolist(), "violation": viol.tolist()})
    return rows


def card_chain(log: Path):
    """The port's fused chain on the card, window by window, from the
    ``chain window <w>: {...}`` lines of a ``chip_smoke.py`` log (the
    whole fleet), and its set-up: ``host`` where the log prints the
    set-up it held (``set-up: ...``, the smoke since the searches moved
    to the host), else ``card`` (the float32 set-up found on the card)."""
    rows, name = [], "card"
    for line in log.read_text().splitlines():
        if line.startswith("set-up: "):
            name = "host"
        m = re.match(r"chain window (\d+)[^:]*: (\{.*\})$", line.strip())
        if m:
            if rows and int(m.group(1)) == 0:
                break   # the log's first chain only
            rows.append({"window": int(m.group(1)), **json.loads(m.group(2))})
    return name, rows


def table(out: Path, stride: int = 8, card_log: Path = None) -> dict:
    """Every arm side by side, on the fleet rows ``[::stride]`` and, where
    the arm ran on every offset, on the whole fleet (with the card's own
    chain from ``card_log``, arm ``card-fused@<its set-up>``); and whether
    each tracks ``ref@<set-up>`` on its set-up."""
    result = {}
    for fleet in ("rows", "whole"):
        arms = {}
        if fleet == "whole" and card_log is not None:
            name, rows = card_chain(card_log)
            arms[f"card-fused@{name}"] = rows
        for a in ARMS:
            if fleet == "rows" and _arm_file(out, a, 0).exists():
                arms[a] = json.loads(_arm_file(out, a, 0).read_text())
            elif fleet == "whole" and stride > 1:
                rows = _merged(out, a, stride)
                if rows is not None:
                    arms[a] = rows
        if not arms:
            continue
        print(f"-- fleet {'[::%d]' % stride if fleet == 'rows' else 'whole'}")
        for a, rows in arms.items():
            print(f"{a:19s} " + " ".join(
                f"{r['converged_fraction_1e2']:.3f}/{r['mean_cost']:.0f}/"
                f"{r['mean_violation']:.3g}/{r['diverged_fraction']:.2f}"
                .ljust(26) for r in rows))
        verdict = {}
        for name in SETUPS:
            ref = arms.get(f"ref@{name}")
            for s in SOLVERS[1:] + ("card-fused",):   # against the reference
                if ref and f"{s}@{name}" in arms:
                    verdict[f"{s}@{name}"] = tracks(arms[f"{s}@{name}"], ref)
        print("tracks ref@<set-up> (cost 5%, violation 0.3(1+v)):",
              json.dumps(verdict))
        result[fleet] = {"arms": {a: [{k: v for k, v in r.items()
                                       if k not in ("cost", "violation")}
                                      for r in rows]
                                  for a, rows in arms.items()},
                         "tracks_reference": verdict}
    (out / "table.json").write_text(json.dumps(result, indent=1))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arm", default="all",
                    choices=("all", "setup", "table", "trims", "headline")
                    + ARMS + SAME + BATCH)
    ap.add_argument("--device", default="cpu",
                    help="the trims arm's device besides the CPU; the "
                    "headline arm's device")
    ap.add_argument("--seeds", default="0",
                    help="the headline arm's set-up seeds, comma-separated")
    ap.add_argument("--out", default=str(ROOT / "build" / "aircraft_tpu_torch"
                                         / "chain_crossing"))
    ap.add_argument("--stride", type=int, default=8)
    ap.add_argument("--windows", type=int, default=10)
    ap.add_argument("--card-log", default=None,
                    help="a chip_smoke.py log: the table adds the card's "
                         "chain")
    ap.add_argument("--offset", type=int, default=0,
                    help="an arm's first fleet row (rows [offset::stride])")
    a = ap.parse_args(argv)
    out = Path(a.out)
    if a.arm == "trims":
        trims(out, a.device)
    elif a.arm == "headline":
        headline(out, a.device, [int(k) for k in a.seeds.split(",")],
                 a.windows)
    elif a.arm == "setup":
        print(json.dumps(setup(out), indent=1))
    elif a.arm == "table":
        table(out, a.stride, a.card_log and Path(a.card_log))
    elif a.arm == "all":
        print(json.dumps(setup(out), indent=1), flush=True)
        with np.load(out / "setups.npz") as d:
            found = {k.split("_")[0] for k in d.files}
        arms = [arm for arm in ARMS if arm.split("@")[1] in found]
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--arm", arm, "--out", str(out),
             "--stride", str(a.stride), "--windows", str(a.windows)],
            stdout=open(out / f"{arm}.log", "w"), stderr=subprocess.STDOUT)
            for arm in arms]
        rcs = [p.wait() for p in procs]
        if any(rcs):
            raise SystemExit(f"arms failed: {dict(zip(arms, rcs))}")
        table(out, a.stride)
    elif a.arm in BATCH:
        import torch
        torch.set_num_threads(1)
        dtype, name = a.arm[len("batch-"):].split("@")
        batch_dependence(out, name, dtype)
    elif a.arm in SAME:
        import torch
        torch.set_num_threads(1)    # the arms run side by side
        solver, name = a.arm[len("same-"):].split("@")
        rows = same_inputs(out, name, solver.split("-")[1], range(a.windows))
        (out / f"{a.arm}.json").write_text(json.dumps(rows, indent=1))
    else:
        import torch
        torch.set_num_threads(1)
        run_arm(a.arm, out, a.stride, a.windows, a.offset)


if __name__ == "__main__":
    main()
