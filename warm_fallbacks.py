#!/usr/bin/env python3
"""Where the warm mode's Cholesky kernel route falls back, and where the
value Hessian Vxx turns indefinite upstream of it.

    python3 warm_fallbacks.py [--windows 2] [--al-iters 2] [--inner-iters 6]
                              [--batch 256] [--device cuda] [--save PATH]
                              [--out PATH]

Runs ``bench.bench_warm`` with ``--cuda-chol`` twice on the same inputs:
as the bench runs it (the kernel-route sweep as its CUDA graph), then with
that sweep run eagerly (the same arithmetic; ``chip_smoke.py`` holds the
two bit for bit) and every knot's solve inspected.  A knot falls back when
any of the batch's systems has a non-finite entry in the kernel's X: the
whole batch then takes the reference route (``riccati.chol_solve_kernel``,
the reference's ``lax.cond``).  For each such knot it records the solve,
the AL round, the knot, which systems were non-finite in the kernel and
in its plain version (the TPU kernel's rule, unrolled in PyTorch), and,
for those systems, the float64 eigenvalues of ½(Quu + Quuᵀ) + reg·I, its
largest entry, and whether the stage expansion luu or the step Jacobian
B at that knot sat at the solver's clamps (1e8 and 1e6).

In the eager run every backward pass also keeps each knot's Vxx (after
the sweep's ±1e14 clamp; the terminal vxx at knot N) and its float64
eigenvalues.  A knot's Vxx counts as indefinite when its least eigenvalue
is below -INDEF_TOL times its largest |eigenvalue|.  For every scenario
that fell back, the summary gives the first pass (window, AL round, inner
iteration) and, within it, the first knot the sweep reaches (the latest
in time) where that scenario's Vxx is indefinite, with whether the 1e14
clamp, the 1e8 clamp of the stage expansion or the 1e6 clamp of A and B
fired at that knot.  Prints one JSON summary (``--out`` also writes it).

``--save PATH`` writes, as ``.npz``, the first fallen scenario and its 7
neighbours (a batch of 8) at that pass: the window's inputs (x0s, us),
the pass's expansion point (xs, us, the AL state, reg), the backward
sweep's inputs as the solver handed them over (A, B and the sanitised
expansion) and each knot's Vxx eigenvalue ratio seen on this device.

``warm_vxx_crossing.py`` holds the two packages on such a file (on the
CPU, the JAX package as the reference); ``tests/test_torch_warm_vxx.py``
holds them on the file the card wrote
(``tests/data/warm_vxx_indefinite.npz``).
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

import numpy as np
import torch

# least eigenvalue below -INDEF_TOL · max |eigenvalue|: a Gauss-Newton
# Vxx is positive semidefinite but singular along directions no cost
# sees, where float32 rounding alone leaves ratios down to ~-4e-6
INDEF_TOL = 1e-4
NEIGHBOURS = 8       # the saved batch: the fallen scenario and 7 others
EXPANSION = ("lx", "lu", "lxx", "luu", "lux", "vx", "vxx")
SWEEP_INPUTS = ("A", "B", *EXPANSION, "reg")   # the sweep's arguments


def vxx_eig_ratio(V: torch.Tensor) -> torch.Tensor:
    """Least over largest-magnitude float64 eigenvalue of each symmetric
    matrix of V (..., n, n); 0 for a zero matrix."""
    eig = torch.linalg.eigvalsh(V.double())
    top = eig.abs().amax(-1)
    return torch.where(top > 0, eig[..., 0] / torch.where(top > 0, top, 1.0),
                       torch.zeros_like(top))


def first_indefinite(ratio: torch.Tensor) -> torch.Tensor:
    """(B, N+1) ratios -> (B,): the first knot the backward sweep reaches
    (the largest index) whose Vxx is indefinite, -1 where none is."""
    N1 = ratio.shape[-1]
    bad = ratio < -INDEF_TOL
    idx = torch.arange(N1, device=ratio.device).expand_as(bad)
    return torch.where(bad, idx, torch.full_like(idx, -1)).amax(-1)


def neighbours(s: int, B: int, k: int = NEIGHBOURS) -> list:
    """k consecutive scenario indices around s, inside 0 .. B-1."""
    lo = min(max(0, s - k // 2 + 1), max(0, B - k))
    return list(range(lo, min(B, lo + k)))



def port_sweep_vxx(args, dtype=torch.float32) -> torch.Tensor:
    """Each knot's Vxx (B, N+1, n, n) of the port's sequential sweep on
    ``args`` (the sweep's inputs, CPU tensors) in ``dtype``, after its
    clamp; knot N is the terminal vxx."""
    from aircraft_tpu_torch.solvers import riccati

    args = [torch.as_tensor(a).to(dtype) for a in args]
    seen, real = [], riccati._clamp

    def clamp(t):
        out = real(t)
        if t.ndim == 3:
            seen.append(out)
        return out

    riccati._clamp = clamp
    try:
        riccati.backward_sequential(*args)
    finally:
        riccati._clamp = real
    return torch.stack(seen[::-1] + [args[8]], dim=1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--windows", type=int, default=2)
    p.add_argument("--al-iters", type=int, default=2)
    p.add_argument("--inner-iters", type=int, default=6)
    p.add_argument("--save", default=None)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)

    from aircraft_tpu_torch import bench
    from aircraft_tpu_torch.config import glider_config
    from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
    from aircraft_tpu_torch.dynamics.coefficients import load_mlp
    from aircraft_tpu_torch.kernels import cholesky
    from aircraft_tpu_torch.solvers import ilqr, riccati
    from aircraft_tpu_torch.solvers import ocp as ocp_mod

    def warm():
        return bench.bench_warm(a.device, batch=a.batch,
                                al_iters=a.al_iters,
                                inner_iters=a.inner_iters,
                                windows=a.windows, cuda_chol=True)

    graph = warm()
    print("as the bench runs it: " + json.dumps(
        {k: graph[k] for k in ("backward_passes", "kernel_launches",
                               "finite_fraction", "mean_violation")}),
        flush=True)

    ctx = {"solve": -1, "pass": -1, "t": 0}
    fallen = []
    first = []
    windows = []    # per solve: its x0s and us
    passes = []     # per backward pass: its inputs and each knot's Vxx
    real_solve, real_route = ilqr.solve_batch, riccati.chol_solve_kernel
    real_quad, real_clamp = ilqr.quadraticize_gn, riccati._clamp

    def solve_batch(ocp, x0s, us_inits, *args, **kw):
        ctx["solve"] += 1
        ctx["pass"] = -1
        windows.append((x0s.clone(), us_inits.clone()))
        return real_solve(ocp, x0s, us_inits, *args, **kw)

    def quadraticize_gn(ocp, al, xs, us, **kw):
        ctx["point"] = (xs.clone(), us.clone(), ocp_mod.ALState(*(
            getattr(al, f).clone() for f in ocp_mod._AL_FIELDS)))
        return real_quad(ocp, al, xs, us, **kw)

    def sweep(A, B, lx, lu, lxx, luu, lux, vx, vxx, reg, *, cuda_chol=False):
        ctx.update({"pass": ctx["pass"] + 1, "t": A.shape[1], "B": B,
                    "luu": luu})
        seen = []     # each knot's Vxx before and after the 1e14 clamp
        ctx["quu"] = []   # each knot's least eigenvalue of ½(Quu+Quuᵀ)+reg·I

        def clamp(t):
            out = real_clamp(t)
            if t.ndim == 3:
                fired = ~torch.isfinite(t) | (t.abs() > riccati.V_LIM)
                seen.append((fired.flatten(1).any(1), out))
            return out

        riccati._clamp = clamp
        try:
            out = riccati._sequential(A, B, lx, lu, lxx, luu, lux, vx, vxx,
                                      reg, cuda_chol=cuda_chol)
        finally:
            riccati._clamp = real_clamp
        # seen runs knot N-1 down to 0; knot N is the terminal vxx
        V = torch.stack([v for _, v in reversed(seen)] + [vxx], dim=1)
        ratio = vxx_eig_ratio(V)
        xs, us, al = ctx["point"]
        passes.append({
            "solve": ctx["solve"], "pass": ctx["pass"],
            "ratio": ratio,
            "quu_min_eig": torch.stack(ctx["quu"][::-1], dim=1),
            "clamp_fired": torch.stack([c for c, _ in reversed(seen)], 1),
            "inputs": tuple(t.clone() for t in (A, B, lx, lu, lxx, luu, lux,
                                                vx, vxx, reg)),
            "point": (xs, us, al)})
        return out

    def route(M, rhs, reg, groups=1):
        ctx["t"] -= 1
        t = ctx["t"]
        eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
        Ms = riccati._sym(M) + reg[:, None, None] * eye
        ctx["quu"].append(torch.linalg.eigvalsh(Ms.double())[:, 0])
        X = cholesky.batched_cholesky_solve(Ms, rhs)
        bad = ~torch.isfinite(X).flatten(1).all(1)
        if bool(bad.any()):
            Xp = cholesky.cholesky_solve_plain(Ms, rhs)
            bad_plain = ~torch.isfinite(Xp).flatten(1).all(1)
            idx = bad.nonzero()[:, 0]
            Mb = Ms[idx].double()
            eig = torch.linalg.eigvalsh(Mb)
            _, bad_ref = riccati.chol_solve_reference(M[idx], rhs[idx],
                                                      reg[idx])
            luu_t = ctx["luu"][idx, t]
            B_t = ctx["B"][idx, t]
            fallen.append({
                "solve": ctx["solve"],
                "al_round": ctx["pass"] // a.inner_iters,
                "pass": ctx["pass"], "knot": t,
                "systems": idx.tolist(),
                "plain_same_systems": bool((bad == bad_plain).all()),
                "inputs_finite": bool(torch.isfinite(Mb).all()
                                      and torch.isfinite(rhs[idx]).all()),
                "min_eig": eig[:, 0].tolist(),
                "max_eig": eig[:, -1].tolist(),
                "max_entry": Mb.abs().flatten(1).amax(1).tolist(),
                "luu_at_clamp": (luu_t.abs() >= 1e8).flatten(1).any(1)
                .tolist(),
                "B_at_clamp": (B_t.abs() >= 1e6).flatten(1).any(1).tolist(),
                "reference_route_flags": int(bad_ref.sum()),
                "reg": reg[idx].tolist(),
            })
            if not first:
                first.append((Ms.cpu(), rhs.cpu()))
        return real_route(M, rhs, reg, groups)

    ilqr.solve_batch = solve_batch
    ilqr.quadraticize_gn = quadraticize_gn
    riccati.backward_sequential, real_sweep = sweep, riccati.backward_sequential
    riccati.chol_solve_kernel = route
    try:
        eager = warm()
    finally:
        ilqr.solve_batch = real_solve
        ilqr.quadraticize_gn = real_quad
        riccati.backward_sequential = real_sweep
        riccati.chol_solve_kernel = real_route

    knots = eager["backward_passes"] * bench.N_HORIZON
    systems = [s for f in fallen for s in f["systems"]]
    by_scenario = collections.Counter(systems)
    min_eig = [e for f in fallen for e in f["min_eig"]]
    cond = [hi / lo for f in fallen for lo, hi in zip(f["min_eig"],
                                                      f["max_eig"])
            if lo > 0]
    # where each fallen scenario's Vxx first turns indefinite
    onsets = {}
    for i, ps in enumerate(passes):
        knot = first_indefinite(ps["ratio"]).tolist()
        for s_ in by_scenario:
            if s_ in onsets or knot[s_] < 0:
                continue
            t = knot[s_]
            A, Bm, _, _, lxx, luu, lux, _, vxx, reg = ps["inputs"]
            at = (lambda x: bool((x[s_, t].abs() >= 1e8).any())) if t < \
                A.shape[1] else (lambda x: False)
            onsets[s_] = {
                "index": i, "solve": ps["solve"],
                "al_round": ps["pass"] // a.inner_iters,
                "inner_iteration": ps["pass"] % a.inner_iters,
                "knot": t, "ratio": float(ps["ratio"][s_, t]),
                "clamp_1e14_fired": (bool(ps["clamp_fired"][s_, t])
                                     if t < A.shape[1] else False),
                "expansion_at_1e8": (at(lxx) or at(luu) or at(lux)
                                     if t < A.shape[1] else
                                     bool((vxx[s_].abs() >= 1e8).any())),
                "A_or_B_at_1e6": (bool((A[s_, t].abs() >= 1e6).any()
                                       or (Bm[s_, t].abs() >= 1e6).any())
                                  if t < A.shape[1] else False),
                "indefinite_knots_in_pass": int(
                    (ps["ratio"][s_] < -INDEF_TOL).sum()),
                "least_ratio_in_pass": float(ps["ratio"][s_].min()),
                "first_indefinite_quu_knot_in_pass": int(max(
                    (k for k in range(A.shape[1])
                     if ps["quu_min_eig"][s_, k] <= 0), default=-1)),
                "least_quu_eig_in_pass": float(ps["quu_min_eig"][s_].min()),
                "first_fallback_solve_pass": min(
                    (f["solve"], f["pass"]) for f in fallen
                    if s_ in f["systems"]),
            }
    indefinite_passes = sum(bool((ps["ratio"] < -INDEF_TOL).any())
                            for ps in passes)
    summary = {
        "device": bench._card(torch.device(a.device)),
        "batch": a.batch, "budget": [a.al_iters, a.inner_iters],
        "windows": a.windows,
        "graph_fallbacks": graph["kernel_launches"]["chol_fallbacks"],
        "graph_cholesky_launches":
            graph["kernel_launches"]["batched_cholesky_solve"],
        "eager_fallbacks": len(fallen),
        "knots": knots,
        "eager_equals_graph": (
            graph["kernel_launches"]["chol_fallbacks"] == len(fallen)
            and graph["mean_violation"] == eager["mean_violation"]),
        "by_solve": dict(collections.Counter(f["solve"] for f in fallen)),
        "by_al_round": dict(collections.Counter(f["al_round"]
                                                for f in fallen)),
        "by_pass": dict(collections.Counter(f["pass"] for f in fallen)),
        "knots_hit": sorted({f["knot"] for f in fallen}),
        "systems_per_fallen_knot": sorted(collections.Counter(
            len(f["systems"]) for f in fallen).items()),
        "scenarios": len(by_scenario),
        "top_scenarios": by_scenario.most_common(8),
        "plain_version_same_systems": all(f["plain_same_systems"]
                                          for f in fallen),
        "inputs_finite": all(f["inputs_finite"] for f in fallen),
        "systems": len(systems),
        "indefinite_in_float64": sum(e <= 0 for e in min_eig),
        "min_eig_range": [min(min_eig), max(min_eig)] if min_eig else None,
        "cond_of_definite_range": [min(cond), max(cond)] if cond else None,
        "max_entry_range": ([min(e for f in fallen for e in f["max_entry"]),
                             max(e for f in fallen for e in f["max_entry"])]
                            if fallen else None),
        "luu_at_clamp": sum(c for f in fallen for c in f["luu_at_clamp"]),
        "B_at_clamp": sum(c for f in fallen for c in f["B_at_clamp"]),
        "reference_route_flags": sum(f["reference_route_flags"]
                                     for f in fallen),
        "reg_values": sorted({r for f in fallen for r in f["reg"]}),
        "indef_tol": INDEF_TOL,
        "passes_with_an_indefinite_vxx": indefinite_passes,
        "scenarios_with_an_indefinite_vxx": int(torch.stack([
            (ps["ratio"] < -INDEF_TOL).any(1) for ps in passes]).any(0)
            .sum()) if passes else 0,
        "least_ratio_per_pass": [float(ps["ratio"].min()) for ps in passes],
        "vxx_onsets": {str(k): {f: v for f, v in o.items() if f != "index"}
                       for k, o in sorted(onsets.items())},
        "first_fallen": fallen[:3],
    }
    if a.save and fallen:
        s_ = fallen[0]["systems"][0]
        o = onsets.get(s_)
        ps = passes[o["index"]] if o else next(
            q for q in passes if (q["solve"], q["pass"])
            == (fallen[0]["solve"], fallen[0]["pass"]))
        rows = neighbours(s_, a.batch)
        pick = lambda t: t[rows].detach().cpu().numpy()
        x0s, us0 = windows[ps["solve"]]
        xs, us, al = ps["point"]
        glide = bench.plant_best_glide(AircraftParams.from_config(
            glider_config().aircraft, coeff=load_mlp(device="cpu"),
            device="cpu"))
        np.savez_compressed(
            a.save, rows=np.array(rows), scenario=s_,
            row_of_scenario=rows.index(s_),
            solve=ps["solve"], al_round=ps["pass"] // a.inner_iters,
            inner_iteration=ps["pass"] % a.inner_iters,
            knot=o["knot"] if o else -1,
            budget=np.array([a.al_iters, a.inner_iters]),
            glide=np.array(glide), window_x0s=pick(x0s),
            window_us=pick(us0), xs=pick(xs), us=pick(us),
            **{f"al_{f}": pick(getattr(al, f)) for f in ocp_mod._AL_FIELDS},
            **{k: pick(t) for k, t in zip(SWEEP_INPUTS, ps["inputs"])},
            ratio=pick(ps["ratio"]), quu_min_eig=pick(ps["quu_min_eig"]),
            device=summary["device"])
        summary["saved"] = {"path": a.save, "rows": rows, "scenario": s_,
                            "solve": int(ps["solve"]),
                            "pass": int(ps["pass"])}
        if first:
            torch.save({"A": first[0][0], "rhs": first[0][1],
                        "record": fallen[0]},
                       str(Path(a.save).with_suffix(".first_knot.pt")))
    print(json.dumps(summary), flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
