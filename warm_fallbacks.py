#!/usr/bin/env python3
"""Where the warm mode's Cholesky kernel route falls back.

    python3 warm_fallbacks.py [--windows 2] [--al-iters 2] [--inner-iters 6]
                              [--batch 256] [--device cuda] [--save PATH]

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
B at that knot sat at the solver's clamps (1e8 and 1e6).  Prints one JSON
summary.  ``--save`` writes the first fallen knot's systems (A, rhs) with
``torch.save``.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys

import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--windows", type=int, default=2)
    p.add_argument("--al-iters", type=int, default=2)
    p.add_argument("--inner-iters", type=int, default=6)
    p.add_argument("--save", default=None)
    a = p.parse_args(argv)

    from aircraft_tpu_torch import bench
    from aircraft_tpu_torch.kernels import cholesky
    from aircraft_tpu_torch.solvers import ilqr, riccati

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
    real_solve, real_route = ilqr.solve_batch, riccati.chol_solve_kernel

    def solve_batch(*args, **kw):
        ctx["solve"] += 1
        ctx["pass"] = -1
        return real_solve(*args, **kw)

    def sweep(A, B, lx, lu, lxx, luu, lux, vx, vxx, reg, *, cuda_chol=False):
        ctx.update({"pass": ctx["pass"] + 1, "t": A.shape[1], "B": B,
                    "luu": luu})
        return riccati._sequential(A, B, lx, lu, lxx, luu, lux, vx, vxx,
                                   reg, cuda_chol=cuda_chol)

    def route(M, rhs, reg, groups=1):
        ctx["t"] -= 1
        t = ctx["t"]
        eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
        Ms = riccati._sym(M) + reg[:, None, None] * eye
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
    riccati.backward_sequential, real_sweep = sweep, riccati.backward_sequential
    riccati.chol_solve_kernel = route
    try:
        eager = warm()
    finally:
        ilqr.solve_batch = real_solve
        riccati.backward_sequential = real_sweep
        riccati.chol_solve_kernel = real_route

    knots = eager["backward_passes"] * bench.N_HORIZON
    systems = [s for f in fallen for s in f["systems"]]
    by_scenario = collections.Counter(systems)
    min_eig = [e for f in fallen for e in f["min_eig"]]
    cond = [hi / lo for f in fallen for lo, hi in zip(f["min_eig"],
                                                      f["max_eig"])
            if lo > 0]
    summary = {
        "device": bench._card(torch.device(a.device)),
        "batch": a.batch, "budget": [a.al_iters, a.inner_iters],
        "windows": a.windows,
        "graph_fallbacks": graph["kernel_launches"]["chol_fallbacks"],
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
        "first_fallen": fallen[:3],
    }
    if a.save and first:
        torch.save({"A": first[0][0], "rhs": first[0][1],
                    "record": fallen[0]}, a.save)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
