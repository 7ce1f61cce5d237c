"""The slices as a whole: the port's fused window solve (the plain versions
of its kernels, on the CPU) and the port's ``ilqr.solve_batch`` (both
Quu-solve routes, the kernel route on the batched-Cholesky kernel's plain
version) against the reference's ``ilqr.solve_batch`` with residual
Gauss-Newton curvature, at N=4, B=8, 1 AL round x 2 inner iterations and
4 line-search candidates; and tiny runs of the port's bench, whose JSON
lines must carry the reference modes' fields.

Held at population level, as tests/test_window_kernel.py holds the TPU
fused solve: a chaotic plant and two summation orders give no per-scenario
parity, so the mean cost agrees within 5% and the mean violation within
0.3 (1 + v).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp

from aircraft_tpu.config import SolverConfig as JaxSolverConfig
from aircraft_tpu.solvers import ilqr

from aircraft_tpu_torch import bench
from aircraft_tpu_torch.config import SolverConfig
from aircraft_tpu_torch.kernels import cholesky
from aircraft_tpu_torch.kernels import window as win
from aircraft_tpu_torch.solvers import ilqr as t_ilqr
from aircraft_tpu_torch.solvers import riccati
from aircraft_tpu_torch.solvers.fused import make_fused_solver

from torch_port_problem import build_pair, fleet_inputs

N, B = 4, 8
BUDGET = dict(max_al_iters=1, max_inner_iters=2, line_search_steps=4,
              hessian="gauss_newton", reg_escalate=100.0, use_residual_gn=True)

# bench.py's headline fields (bench.py:1634-1671)
HEADLINE_FIELDS = (
    "metric", "value", "feasibility_gate_95pct_1e2_passed", "unit",
    "vs_baseline", "batch", "wall_s_per_batch", "latency_s_per_window",
    "compile_s", "compile_cache_entries_at_start", "chained_windows",
    "scan_windows", "matmul_precision", "al_iters", "inner_iters",
    "penalty_per_row", "violation_units", "converged_gate", "reset_viol",
    "warmup_windows", "finite_fraction", "mean_violation",
    "cold_window_mean_violation", "converged_fraction_1e2",
    "converged_fraction_1e4", "p90_violation", "median_violation",
    "diverged_fraction", "mean_cost", "device", "fused_kernels")


@pytest.fixture(scope="module")
def solves():
    jx, pt = build_pair("nn")
    z0s, _ = fleet_inputs(B, N, seed=3, reversed_lanes=0)
    us = np.zeros((B, N, 7), np.float32)
    with jax.default_matmul_precision("highest"):
        ref = ilqr.solve_batch(jx["ocp"], jnp.asarray(z0s), jnp.asarray(us),
                               JaxSolverConfig(**BUDGET))
    win.reset_launch_counts()
    cholesky.reset_launch_counts()
    riccati.reset_counts()
    x0, u0 = torch.as_tensor(z0s), torch.as_tensor(us)
    config = SolverConfig(**BUDGET)
    sols = {"fused": make_fused_solver(pt["ocp"], pt["spec"], N, config)(x0, u0)}
    for cuda_chol in (False, True):
        sols[f"ilqr-cuda_chol={cuda_chol}"] = t_ilqr.solve_batch(
            pt["ocp"], x0, u0, config, cuda_chol=cuda_chol)
    return ref, sols


def _population_close(sol, ref):
    assert bool(torch.isfinite(sol.cost).all())
    cf, cx = float(sol.cost.mean()), float(jnp.nanmean(ref.cost))
    assert abs(cf - cx) / (1.0 + abs(cx)) < 0.05, (cf, cx)
    vf, vx = float(sol.violation.mean()), float(jnp.nanmean(ref.violation))
    assert abs(vf - vx) < 0.3 * (1.0 + vx), (vf, vx)


def test_fused_solve_tracks_reference_population(solves):
    ref, sols = solves
    _population_close(sols["fused"], ref)


@pytest.mark.parametrize("route", ["ilqr-cuda_chol=False",
                                   "ilqr-cuda_chol=True"])
def test_ilqr_solve_tracks_reference_population(solves, route):
    ref, sols = solves
    _population_close(sols[route], ref)


def test_ilqr_kernel_route_ran_without_fallback(solves):
    """The kernel route took the kernel's plain version on every knot (no
    launch: CPU tensors) and never fell back, and both routes agree."""
    _, sols = solves
    assert cholesky.batched_cholesky_solve.launches == 0
    assert riccati.chol_fallbacks == 0
    a, b = sols["ilqr-cuda_chol=False"], sols["ilqr-cuda_chol=True"]
    np.testing.assert_allclose(b.cost.numpy(), a.cost.numpy(), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("name", ["fused", "ilqr-cuda_chol=False"])
def test_fused_solution_layout(solves, name):
    ref, sols = solves
    sol = sols[name]
    assert tuple(sol.xs.shape) == tuple(ref.xs.shape) == (B, N + 1, 14)
    assert tuple(sol.us.shape) == tuple(ref.us.shape) == (B, N, 7)
    assert tuple(sol.al.lam_ineq.shape) == tuple(ref.al.lam_ineq.shape)
    assert tuple(sol.al.mu_row.shape) == tuple(ref.al.mu_row.shape)
    # the solve ends with one multiplier update, as the reference's
    np.testing.assert_allclose(sol.al.mu.numpy(), np.asarray(ref.al.mu))


def test_cpu_solve_takes_the_plain_versions(solves):
    """On CPU tensors no kernel is launched."""
    assert win.window_backward.launches == win.window_forward.launches == 0


@pytest.fixture(scope="module")
def memo_setup():
    """The bench's problem and fleet set-up (trim solves, ~10 s on the
    CPU), made once for every bench case of this file."""
    memo = {}

    def cached(name, fn):
        def call(*args, **kwargs):
            key = (name, args, tuple(sorted(kwargs.items())))
            if key not in memo:
                memo[key] = fn(*args, **kwargs)
            return memo[key]
        return call

    mp = pytest.MonkeyPatch()
    mp.setattr(bench, "build_problem", cached("problem", bench.build_problem))
    mp.setattr(bench, "fleet_states", cached("fleet", bench.fleet_states))
    yield
    mp.undo()


@pytest.mark.parametrize("solver", [[], ["--solver", "ilqr"],
                                    ["--solver", "ilqr", "--cuda-chol"]],
                         ids=["fused", "ilqr", "ilqr-cuda-chol"])
def test_bench_prints_the_headline_fields(capsys, memo_setup, solver):
    """`python -m aircraft_tpu_torch.bench` with these arguments."""
    bench.main(["--device", "cpu", "--batch", "2", "--horizon", "4",
                "--al-iters", "1", "--inner-iters", "1", "--line-search", "3",
                "--warmup", "0", "--reps", "1"] + solver)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    missing = set(HEADLINE_FIELDS) - set(line)
    assert not missing, sorted(missing)
    assert line["device"] == "cpu" and line["fused_kernels"] is False
    assert line["matmul_precision"] == "highest"
    assert line["batch"] == 2 and line["finite_fraction"] == 1.0
    assert line["solver"] == ("ilqr" if solver else "fused")
    assert line["cuda_chol"] == ("--cuda-chol" in solver)


# the reference's BENCH_MODE=kernel and =chol JSON keys (bench.py:113-123,
# :161-169)
MODE_FIELDS = {
    "kernel": ("metric", "value", "unit", "vs_baseline", "kernel_lanes_s",
               "kernel_tiles_s", "xla_s", "batch", "horizon", "substeps",
               "max_diff", "max_diff_tiles", "device"),
    "chol": ("metric", "value", "unit", "vs_baseline", "kernel_s", "xla_s",
             "batch", "m", "k", "max_diff", "device"),
}


@pytest.mark.parametrize("mode,args", [
    ("kernel", ["--batch", "4", "--horizon", "3", "--substeps", "2"]),
    ("chol", ["--batch", "64"])])
def test_bench_modes_print_the_reference_fields(capsys, mode, args):
    bench.main(["--device", "cpu", "--mode", mode, "--reps", "1"] + args)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == set(MODE_FIELDS[mode])
    assert line["device"] == "cpu"
    # on the CPU the kernel is its plain version: the same numbers
    assert line["max_diff"] < 1e-4
