"""The port's ``parallel/`` against the reference's on the CPU.

* The horizon-sharded Riccati sweep at 2 and 4 gloo ranks against the
  reference's ``backward_associative_sharded`` on ``make_seq_mesh(8)`` (the
  8-device CPU mesh of tests/conftest.py), on LQ problems made by
  tests/test_riccati.py's recipe at (N, n, m) = (64, 6, 3) and (32, 13, 7),
  at that file's tolerances (K, k rtol/atol 2e-3; dv1 rtol 1e-2, atol
  1e-3; max |Qu| rtol 1e-2); against the port's own unsharded associative
  sweep within 1e-4 (1 + |ref|); and the one-process block decomposition
  (``backward_associative_blocked``) equal to the gloo runs.
* ``solve_batch_sharded`` at 2 gloo ranks against the port's unsharded
  ``solve_batch`` per scenario (1e-5 relative), its summary equal to the
  reduction of the unsharded solution, and against the reference's
  ``solve_batch_sharded`` on ``make_mesh(2)`` at B=8, N=4, 1 x 2,
  Gauss-Newton, held at population level (mean cost within 5%, mean
  violation within 0.3 (1 + v)) as tests/test_torch_fused.py holds the
  unsharded solves.
* The mesh helpers over two gloo ranks, and their refusals.

The reference jits its sharded solve as one program (``_run_sharded``),
so it cannot be split into small jits: its trace and compile are ~70 s of
this file.  The gloo ranks (``tests/torch_parallel_ranks.py``) run in a
thread meanwhile; they wait on their processes, not on the interpreter.
"""

import concurrent.futures
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp

from aircraft_tpu.config import SolverConfig as JaxSolverConfig
from aircraft_tpu.parallel import make_mesh as jax_make_mesh
from aircraft_tpu.parallel import solve_batch_sharded as jax_solve_sharded
from aircraft_tpu.parallel.seq_riccati import (
    backward_associative_sharded as jax_sweep_sharded)
from aircraft_tpu.parallel.seq_riccati import make_seq_mesh

from aircraft_tpu_torch import parallel
from aircraft_tpu_torch.config import SolverConfig
from aircraft_tpu_torch.parallel import seq_riccati
from aircraft_tpu_torch.solvers import riccati

import torch_parallel_ranks as ranks
from torch_port_problem import (MLP_KEYS, PARAM_KEYS, V_REF, build_pair,
                                fleet_inputs)

LQ_SHAPES = [(64, 6, 3), (32, 13, 7)]
WORLDS = (2, 4)
B, N = 8, 4
BUDGET = dict(max_al_iters=1, max_inner_iters=2, line_search_steps=4,
              hessian="gauss_newton", reg_escalate=100.0, use_residual_gn=True)


def lq_problem(N, n, m, seed=9):
    """tests/test_riccati.py's ``random_lq_problem`` recipe as one
    scenario, batch-leading: A, B, lx, lu, lxx, luu, lux, vx, vxx, reg."""
    rng = np.random.default_rng(seed)
    A = np.eye(n) + 0.05 * rng.normal(0, 1, (N, n, n))
    Bm = 0.1 * rng.normal(0, 1, (N, n, m))
    W = rng.normal(0, 1, (N, n, n))
    lxx = np.einsum("kij,klj->kil", W, W) / n + np.eye(n)[None]
    Wu = rng.normal(0, 1, (N, m, m))
    luu = np.einsum("kij,klj->kil", Wu, Wu) / m + np.eye(m)[None]
    lux = 0.1 * rng.normal(0, 1, (N, m, n))
    lx = rng.normal(0, 1, (N, n))
    lu = rng.normal(0, 1, (N, m))
    vx = rng.normal(0, 1, n)
    Wt = rng.normal(0, 1, (n, n))
    vxx = Wt @ Wt.T / n + np.eye(n)
    return tuple(np.asarray(a, np.float32)[None] for a in (
        A, Bm, lx, lu, lxx, luu, lux, vx, vxx)) + (
        np.full(1, 1e-6, np.float32),)


LQ = [lq_problem(*s) for s in LQ_SHAPES]


def solve_problem():
    """The window OCP of tests/test_torch_fused.py for both packages, its
    fleet (B=8, N=4) and the port's side as numpy arrays for the ranks."""
    jx, _ = build_pair("nn")
    jp = jx["params"]
    problem = {
        "params": {**{k: np.asarray(getattr(jp, k)) for k in PARAM_KEYS},
                   "epsilon": float(jp.epsilon)},
        "mlp": {**{k: np.asarray(getattr(jp.coeff, k)) for k in MLP_KEYS},
                "Cn_rudder": float(jp.coeff.Cn_rudder)},
        "pts": jx["pts"], "length": jx["track"].length(), "dt": 0.01,
        "v_ref": V_REF}
    z0s, _ = fleet_inputs(B, N, seed=3, reversed_lanes=0)
    return jx, problem, z0s, np.zeros((B, N, 7), np.float32)


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """The gloo runs, started in a thread: world 2 (both sweeps and the
    sharded solve) and world 4 (both sweeps)."""
    jx, problem, z0s, us = solve_problem()
    tmp = tmp_path_factory.mktemp("ranks")

    def run():
        two = parallel.spawn(ranks.world_two, 2, device="cpu", tmpdir=tmp,
                             args=(LQ, (problem, z0s, us,
                                        SolverConfig(**BUDGET))))
        four = parallel.spawn(ranks.sweeps, 4, device="cpu", tmpdir=tmp,
                              args=(LQ,))
        return {2: [r["sweeps"] for r in two], 4: four,
                "solve": [r["solve"] for r in two],
                "helpers": [r["helpers"] for r in two]}

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    future = pool.submit(run)
    yield {"future": future, "jax": jx, "z0s": z0s, "us": us}
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def jax_solve(gloo):
    """The reference's sharded solve on its 2-device mesh (after the gloo
    ranks have started)."""
    with jax.default_matmul_precision("highest"):
        sols, summary = jax_solve_sharded(
            gloo["jax"]["ocp"], jnp.asarray(gloo["z0s"]),
            jnp.asarray(gloo["us"]), jax_make_mesh(2),
            JaxSolverConfig(**BUDGET))
        jax.block_until_ready(sols.xs)
    return sols, summary


def sweep_of(results, world, p):
    """The gloo run's sweep of problem p: K, k joined over the ranks, the
    scalars from rank 0 (checked equal on every rank)."""
    per_rank = [results[world][r][p] for r in range(world)]
    for other in per_rank[1:]:
        for a, b in zip(per_rank[0][2:], other[2:]):
            np.testing.assert_array_equal(a, b)
    return (np.concatenate([r[0] for r in per_rank], axis=1),
            np.concatenate([r[1] for r in per_rank], axis=1),
            *per_rank[0][2:])


@pytest.fixture(scope="module")
def sweeps(gloo, jax_solve):
    """The gloo runs' results, read once the reference's solve, which
    runs meanwhile, is done."""
    return gloo["future"].result()


@pytest.fixture(scope="module")
def jax_sweeps():
    """The reference's horizon-sharded sweep of each LQ problem on the
    8-device mesh."""
    mesh = make_seq_mesh(8)
    sweep = jax.jit(lambda *a: jax_sweep_sharded(mesh, *a))
    return [sweep(*(jnp.asarray(a[0]) for a in prob[:9]),
                  jnp.asarray(1e-6, jnp.float32)) for prob in LQ]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("p", range(len(LQ_SHAPES)),
                         ids=[f"N{s[0]}-n{s[1]}-m{s[2]}" for s in LQ_SHAPES])
def test_sharded_sweep_matches_reference(sweeps, jax_sweeps, world, p):
    ref = jax_sweeps[p]
    K, k, dv1, dv2, qu, fail = sweep_of(sweeps, world, p)
    assert not bool(ref[5]) and not fail.any()
    np.testing.assert_allclose(K[0], np.asarray(ref[0]), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(k[0], np.asarray(ref[1]), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(dv1[0], float(ref[2]), rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(qu[0], float(ref[4]), rtol=1e-2)


def _close(a, ref, tol):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    assert np.all(np.abs(a - ref) <= tol * (1.0 + np.abs(ref))), (
        np.max(np.abs(a - ref)))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("p", range(len(LQ_SHAPES)),
                         ids=[f"N{s[0]}-n{s[1]}-m{s[2]}" for s in LQ_SHAPES])
def test_sharded_sweep_matches_the_port_sweep_and_its_blocks(sweeps, world,
                                                             p):
    """Against the port's unsharded associative sweep within 1e-4 (1 +
    |ref|), and the same arithmetic in one process (S blocks, the
    aggregates stacked) equal to the gloo run."""
    args = [torch.as_tensor(a) for a in LQ[p]]
    ref = riccati.backward_associative(*args)
    blocked = seq_riccati.backward_associative_blocked(world, *args)
    got = sweep_of(sweeps, world, p)
    for a, r in zip(got[:5], ref[:5]):
        _close(a, r.numpy(), 1e-4)
    assert not got[5].any() and not bool(ref[5].any())
    for a, b in zip(got[:2] + got[4:], blocked[:2] + blocked[4:]):
        np.testing.assert_array_equal(a, b.numpy())
    for a, b in zip(got[2:4], blocked[2:4]):      # summed in another order
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-6)


def test_sharded_solve_matches_the_unsharded_solve(sweeps):
    """Each rank's block against rank 0's unsharded solve of the whole
    fleet, per scenario within 1e-5 relative; the summary, the same on
    both ranks, equal to the reduction of the unsharded solution."""
    ranks_out = sweeps["solve"]
    whole = ranks_out[0]["whole"]
    for f in ranks.SOLUTION_FIELDS:
        _close(np.concatenate([r["block"][f] for r in ranks_out]), whole[f],
               1e-5)
    want = (whole["converged"].sum(), whole["cost"].sum() / B,
            whole["violation"].max(), whole["iterations"].sum() / B)
    for r in ranks_out:
        got = [float(t) for t in r["summary"]]
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_sharded_solve_tracks_the_reference_population(sweeps, jax_solve):
    sols, summary = jax_solve
    port = sweeps["solve"]
    cost = np.concatenate([r["block"]["cost"] for r in port])
    viol = np.concatenate([r["block"]["violation"] for r in port])
    assert np.isfinite(cost).all()
    cx = float(jnp.nanmean(sols.cost))
    assert abs(cost.mean() - cx) / (1.0 + abs(cx)) < 0.05, (cost.mean(), cx)
    vx = float(jnp.nanmean(sols.violation))
    assert abs(viol.mean() - vx) < 0.3 * (1.0 + vx), (viol.mean(), vx)
    # the summaries read the same populations
    n_conv, mean_cost, max_viol, _ = (float(t) for t in port[0]["summary"])
    assert abs(mean_cost - float(summary.mean_cost)) / (
        1.0 + abs(float(summary.mean_cost))) < 0.05
    assert tuple(np.asarray(sols.xs).shape) == (B, N + 1, 14)


def test_mesh_helpers_over_two_ranks(sweeps):
    """``replicated`` hands every rank rank 0's tree; ``shard_batch`` takes
    each rank's contiguous block; ``gather_batch`` joins the blocks in rank
    order (a bool tensor travels too)."""
    x0 = np.arange(6.0).reshape(6, 1)
    flags0 = np.arange(6) % 3 == 0
    for rank, h in enumerate(sweeps["helpers"]):
        np.testing.assert_array_equal(h["replicated"]["x"], x0)
        np.testing.assert_array_equal(h["replicated"]["flags"], flags0)
        np.testing.assert_array_equal(h["block"]["x"],
                                      x0[3 * rank:3 * rank + 3] + 10 * rank)
        assert h["gathered"]["flags"].dtype == np.bool_
        np.testing.assert_array_equal(
            h["gathered"]["x"], np.concatenate([x0[:3], x0[3:] + 10]))
        np.testing.assert_array_equal(
            h["gathered"]["flags"],
            np.concatenate([flags0[:3], (np.arange(6) % 3 == 1)[3:]]))


def test_shard_batch_refuses_a_batch_that_does_not_split():
    mesh = parallel.mesh.Mesh(rank=1, size=4, device=torch.device("cpu"))
    x = torch.arange(8.0).reshape(8, 1)
    np.testing.assert_array_equal(parallel.shard_batch(x, mesh).numpy(),
                                  [[2.0], [3.0]])
    with pytest.raises(ValueError, match="does not split"):
        parallel.shard_batch(torch.zeros(6, 3), mesh)


def test_spawn_on_cuda_without_a_card_starts_no_rank(monkeypatch, tmp_path):
    started = []
    monkeypatch.setattr(torch.multiprocessing, "start_processes",
                        lambda *a, **k: started.append(a))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        parallel.spawn(ranks.sweeps, 2, device="cuda", tmpdir=tmp_path,
                       args=(LQ,))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one rank per card"):
        parallel.spawn(ranks.sweeps, 2, device="cuda", tmpdir=tmp_path,
                       args=(LQ,))
    assert not started
