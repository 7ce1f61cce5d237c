#!/usr/bin/env python3
"""The warm mode's indefinite value Hessian, the port against the
reference, on the CPU.

    JAX_PLATFORMS=cpu python warm_vxx_crossing.py \
        [tests/data/warm_vxx_indefinite.npz]

Reads a ``warm_fallbacks.py --save`` file (a fallen glider and 7
neighbours at the pass where its Vxx first turns indefinite) and prints
one JSON record: each knot's Vxx of the port's sequential sweep and of
the reference's (``aircraft_tpu/solvers/riccati.py::backward_sequential``)
from the saved sweep inputs, their first indefinite knots beside the
card's and how far the two part up to there; each package's own
Gauss-Newton expansion at the saved point, before the solver's 1e8
clamp, at that knot (its largest lxx entry, how many entries the clamp
cuts, the eigenvalue ratio of lxx before and after it, the two packages'
lxx apart); and both sweeps on the unclamped expansion.  A Vxx is
indefinite as ``warm_fallbacks.INDEF_TOL`` says.  The JAX package is the
reference here; the port's package imports none of it.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chain_crossing
from aircraft_tpu.solvers import ilqr as ref_ilqr
from aircraft_tpu.solvers import ocp as ref_ocp
from aircraft_tpu.solvers import riccati as ref_riccati
from aircraft_tpu_torch import bench
from aircraft_tpu_torch.solvers import ilqr
from aircraft_tpu_torch.solvers import ocp as ocp_mod
from warm_fallbacks import (EXPANSION, INDEF_TOL, SWEEP_INPUTS,
                            first_indefinite, port_sweep_vxx, vxx_eig_ratio)

ROOT = Path(__file__).resolve().parent
SAVED = ROOT / "tests" / "data" / "warm_vxx_indefinite.npz"


def _sweep_with_vxx(*args):
    """The reference's ``backward_sequential`` on one scenario, returning
    each knot's Vxx: its scan's carry, recorded by wrapping
    ``jax.lax.scan`` while it traces."""
    real, carries = jax.lax.scan, []

    def scan(f, init, xs=None, **kw):
        def g(c, x):
            c2, y = f(c, x)
            return c2, (y, c2[1])

        c, (ys, vxx) = real(g, init, xs, **kw)
        carries.append(vxx)
        return c, ys

    jax.lax.scan = scan
    try:
        ref_riccati.backward_sequential(*args)
    finally:
        jax.lax.scan = real
    return carries[0]


_reference_sweep = jax.jit(jax.vmap(_sweep_with_vxx))


def reference_sweep_vxx(args) -> torch.Tensor:
    """Each knot's Vxx (B, N+1, n, n) of the reference's sequential sweep
    on ``args`` (float32, vmapped and jitted, the highest matmul
    precision); knot N is the terminal vxx."""
    with jax.default_matmul_precision("highest"):
        V = np.array(_reference_sweep(
            *(jnp.asarray(np.asarray(a, np.float32)) for a in args)))
    return torch.cat([torch.as_tensor(V), torch.as_tensor(
        np.array(args[8], np.float32))[:, None]], dim=1)


def hold(path) -> dict:
    """Both packages' sweeps and expansions on a ``warm_fallbacks.py
    --save`` file (the module docstring); a JSON-ready record."""
    d = np.load(path)
    r, card_knot = int(d["row_of_scenario"]), int(d["knot"])
    args = [d[k] for k in SWEEP_INPUTS]
    Vp, Vr = port_sweep_vxx(args), reference_sweep_vxx(args)
    onset = {"card": card_knot,
             "port": int(first_indefinite(vxx_eig_ratio(Vp))[r]),
             "reference": int(first_indefinite(vxx_eig_ratio(Vr))[r])}
    t = max(onset["port"], onset["reference"], 0)
    scale = 1.0 + Vr[r, t:].abs().amax((-1, -2))
    part = ((Vp[r, t:] - Vr[r, t:]).abs().amax((-1, -2)) / scale)
    # each package's own expansion at the saved point, before the clamp
    v_ref, glide_ld = (float(g) for g in d["glide"])
    jocp, _, _ = chain_crossing._reference_problem(v_ref, glide_ld)
    jal = ref_ocp.ALState(**{f: jnp.asarray(d[f"al_{f}"])
                             for f in chain_crossing.AL_FIELDS})
    with jax.default_matmul_precision("highest"):
        ref_raw = [np.asarray(x) for x in jax.jit(jax.vmap(
            lambda x, w, a: ref_ilqr._quadraticize_gn(
                jocp, a, x, w, use_residuals=True)))(
            jnp.asarray(d["xs"]), jnp.asarray(d["us"]), jal)]
    _, _, pocp, _, _, _ = bench.build_problem("cpu", glide=(v_ref, glide_ld))
    pal = ocp_mod.ALState(*(torch.as_tensor(d[f"al_{f}"])
                            for f in ocp_mod._AL_FIELDS))
    port_raw = ilqr.quadraticize_gn(pocp, pal, torch.as_tensor(d["xs"]),
                                    torch.as_tensor(d["us"]))
    k = onset["card"]
    clip = lambda x: x.clip(-1e8, 1e8)
    raw = {}
    for name, lxx in (("reference", ref_raw[2]),
                      ("port", port_raw[2].numpy())):
        m = torch.as_tensor(np.array(lxx[r, k], np.float64))
        raw[name] = {
            "lxx_max": float(np.abs(lxx[r, k]).max()),
            "entries_above_1e8": int((np.abs(lxx[r, k]) > 1e8).sum()),
            "lxx_ratio_unclipped": float(vxx_eig_ratio(m)),
            "lxx_ratio_clipped": float(vxx_eig_ratio(clip(m)))}
    raw["port_vs_reference_lxx"] = float(
        np.abs(port_raw[2].numpy()[r, k] - ref_raw[2][r, k]).max()
        / (1.0 + np.abs(ref_raw[2][r, k]).max()))
    raw["saved_vs_reference_clipped"] = {
        name: float(np.abs(d[name] - clip(x)).max()
                    / (1.0 + np.abs(d[name]).max()))
        for name, x in zip(EXPANSION, ref_raw)}
    unclipped = [d["A"], d["B"], *(np.nan_to_num(x) for x in ref_raw),
                 d["reg"]]
    onset_unclipped = {
        "reference": int(first_indefinite(vxx_eig_ratio(
            reference_sweep_vxx(unclipped)))[r]),
        "port": int(first_indefinite(vxx_eig_ratio(
            port_sweep_vxx(unclipped)))[r]),
        "port_float64": int(first_indefinite(vxx_eig_ratio(
            port_sweep_vxx(unclipped, torch.float64)))[r])}
    return {"scenario": int(d["scenario"]), "row": r,
            "window_solve": int(d["solve"]), "al_round": int(d["al_round"]),
            "inner_iteration": int(d["inner_iteration"]),
            "saved_on": str(d["device"]), "indef_tol": INDEF_TOL,
            "onset": onset,
            "ratio_at_onset": {
                "card": float(d["ratio"][r, k]),
                "port": float(vxx_eig_ratio(Vp[r, k])),
                "reference": float(vxx_eig_ratio(Vr[r, k]))},
            "vxx_parts_up_to_onset": float(part.max()),
            "vxx_parts_at_onset": float(part[k - t]) if k >= t else None,
            "expansion_at_onset": raw,
            "onset_without_the_1e8_clamp": onset_unclipped}


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    print(json.dumps(hold(args[0] if args else SAVED)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
