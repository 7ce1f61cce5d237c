"""The port's Riccati sweeps against ``jax.vmap`` of the reference's.

* The sequential sweep on both Quu-solve routes: the reference route
  (Cholesky with the Gershgorin retry) against the reference's, and the
  kernel route (the batched-Cholesky kernel's plain version) against the
  reference's Pallas kernel in interpret mode.  Problems:
  tests/test_riccati.py's batched one (3 scenarios, N=6, n=5, m=3) and one
  at the MHTT shapes (n=14, m=7, N=6).
* The associative sweep against the reference's at n=14, m=7, N in
  {8, 33}, the identity of its combine, and the riccati bench mode.
* The kernel route's fallback: one non-finite system injected through a
  stand-in kernel in both packages falls back at the reference's
  granularity (the whole batch at a knot of the sequential sweep, one
  scenario in the associative sweep's gain recovery); m = 17 takes the
  reference route.
* Which sweep the exact-Hessian solver may use on this plant: both sweeps
  in float32 and float64 on the headline window's exact expansion
  (``test_exact_hessian_takes_the_sequential_sweep``).

Held at 2e-3 as tests/test_riccati.py holds the two reference sweeps.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aircraft_tpu.solvers import riccati as jriccati

from aircraft_tpu_torch.kernels import cholesky
from aircraft_tpu_torch.solvers import riccati

ATOL = 2e-3


def lq_batch(Bsz, N, n, m, seed):
    """tests/test_riccati.py's per-scenario problem, stacked."""
    rng = np.random.default_rng(seed)

    def make():
        A = rng.normal(0, 0.3, (N, n, n)) + np.eye(n)
        Bm = rng.normal(0, 0.3, (N, n, m))
        lx = rng.normal(0, 1, (N, n))
        lu = rng.normal(0, 1, (N, m))
        W = rng.normal(0, 1, (N, n, n))
        lxx = np.einsum("kij,klj->kil", W, W) / n + np.eye(n)
        Wu = rng.normal(0, 1, (N, m, m))
        luu = np.einsum("kij,klj->kil", Wu, Wu) / m + np.eye(m)
        lux = rng.normal(0, 0.1, (N, m, n))
        vx = rng.normal(0, 1, (n,))
        vxx = np.eye(n)
        return A, Bm, lx, lu, lxx, luu, lux, vx, vxx

    cases = [make() for _ in range(Bsz)]
    return tuple(np.stack([c[i] for c in cases]).astype(np.float32)
                 for i in range(9))


PROBLEMS = {"test_riccati": (3, 6, 5, 3, 3), "mhtt_shapes": (4, 6, 14, 7, 11)}


@pytest.mark.parametrize("route", ["reference", "kernel"])
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_backward_sequential_matches_reference(problem, route):
    args = lq_batch(*PROBLEMS[problem])
    Bsz = args[0].shape[0]
    reg = np.full(Bsz, 1e-6, np.float32)
    try:
        jriccati.enable_pallas_chol(route == "kernel", interpret=True)
        ref = jax.jit(jax.vmap(jriccati.backward_sequential))(
            *(jnp.asarray(a) for a in args), jnp.asarray(reg))
    finally:
        jriccati.enable_pallas_chol(False)
    cholesky.reset_launch_counts()
    riccati.reset_counts()
    out = riccati.backward_sequential(
        *(torch.as_tensor(a) for a in args), torch.as_tensor(reg),
        cuda_chol=route == "kernel")
    names = ("K", "k", "dv1", "dv2", "qu_max")
    for name, o, r in zip(names, out[:5], ref[:5]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL,
                                   err_msg=name)
    np.testing.assert_array_equal(out[5].numpy(), np.asarray(ref[5]))
    assert riccati.read_fallbacks() == 0
    assert cholesky.batched_cholesky_solve.launches == 0   # CPU: plain version



POISON = 1e5


def _fake_kernel_jax(M, rhs):
    """A stand-in for the Cholesky kernel: twice the solution, so a knot
    that kept it is told from one that took the reference route, and
    non-finite on a system whose first pivot exceeds POISON."""
    X = 2.0 * jnp.linalg.solve(M, rhs)
    return jnp.where(M[..., :1, :1] > POISON, jnp.nan, X)


def _fake_kernel_torch(a, rhs):
    X = 2.0 * torch.linalg.solve(a, rhs)
    return torch.where(a[..., :1, :1] > POISON, float("nan"), X)


@pytest.mark.parametrize("sweep", ["sequential", "associative"])
def test_kernel_route_falls_back_as_the_reference_does(monkeypatch, sweep):
    """One system (scenario 1, knot 2) gives a non-finite X.  The
    reference's ``lax.cond`` runs under ``vmap`` over the scenarios: in
    the sequential sweep it decides at each knot for the whole batch,
    so that knot falls back for every scenario; in the associative
    sweep's ``recover_gains`` it decides over one scenario's N knots, so
    that scenario falls back at every knot.  Every other solve keeps the
    kernel's X.  One fallback is counted, read once.  Held against JAX
    with the same stand-in kernel."""
    from aircraft_tpu.kernels import cholesky_kernel as jkernel

    args = list(lq_batch(*PROBLEMS["mhtt_shapes"]))
    args[5][1, 2, 0, 0] += 1e6
    Bsz = args[0].shape[0]
    reg = np.full(Bsz, 1e-6, np.float32)
    monkeypatch.setattr(jkernel, "make_batched_cholesky_solve",
                        lambda m, k, interpret=False: _fake_kernel_jax)
    jfn = getattr(jriccati, f"backward_{sweep}")
    try:
        jriccati.enable_pallas_chol(True, interpret=True)
        ref = jax.jit(jax.vmap(jfn))(*(jnp.asarray(a) for a in args),
                                     jnp.asarray(reg))
    finally:
        jriccati.enable_pallas_chol(False)
    monkeypatch.setattr(riccati, "batched_cholesky_solve", _fake_kernel_torch)
    riccati.reset_counts()
    fn = getattr(riccati, f"backward_{sweep}")
    out = fn(*(torch.as_tensor(a) for a in args), torch.as_tensor(reg),
             cuda_chol=True)
    assert riccati.chol_fallbacks == 0          # not read yet
    assert riccati.read_fallbacks() == 1
    for name, o, r in zip(("K", "k"), out[:2], ref[:2]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=ATOL, err_msg=name)
    np.testing.assert_array_equal(out[5].numpy(), np.asarray(ref[5]))
    # a sweep that fell back whole would hold every knot's true gains
    whole = fn(*(torch.as_tensor(a) for a in args), torch.as_tensor(reg))
    assert np.abs(out[1][0].numpy() - whole[1][0].numpy()).max() > 0.1


def _reg(Bsz):
    return np.full(Bsz, 1e-6, np.float32)


@pytest.mark.parametrize("N", [8, 33])
def test_backward_associative_matches_reference(N):
    """The port's associative sweep against ``jax.vmap`` of the
    reference's on the reference route, n = 14, m = 7, at 2e-3 as
    tests/test_riccati.py holds the reference's two sweeps."""
    args = lq_batch(3, N, 14, 7, N)
    reg = _reg(3)
    ref = jax.jit(jax.vmap(jriccati.backward_associative))(
        *(jnp.asarray(a) for a in args), jnp.asarray(reg))
    riccati.reset_counts()
    out = riccati.backward_associative(*(torch.as_tensor(a) for a in args),
                                       torch.as_tensor(reg))
    for name, o, r in zip(("K", "k", "dv1", "dv2", "qu_max"), out[:5],
                          ref[:5]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=ATOL,
                                   atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(out[5].numpy(), np.asarray(ref[5]))
    # the kernel route (its plain version on the CPU) gives the same
    kern = riccati.backward_associative(*(torch.as_tensor(a) for a in args),
                                        torch.as_tensor(reg), cuda_chol=True)
    np.testing.assert_allclose(kern[0].numpy(), out[0].numpy(), rtol=ATOL,
                               atol=ATOL)
    assert riccati.read_fallbacks() == 0


def test_cv_identity_is_the_identity_of_the_combine():
    args = [torch.as_tensor(a) for a in lq_batch(2, 5, 6, 3, 5)]
    elems, _ = riccati.cv_elements(*args[:7], torch.as_tensor(_reg(2)))
    ident = riccati.cv_identity(6, torch.float32, "cpu", batch=(2, 5))
    for left, right in ((ident, elems), (elems, ident)):
        for c, e in zip(riccati.cv_combine(left, right), elems):
            np.testing.assert_allclose(c.numpy(), e.numpy(), rtol=1e-6,
                                       atol=1e-6)


def test_kernel_route_sends_m_above_16_to_the_reference_route():
    """m = 17 exceeds the kernel (which still refuses it): the kernel route
    takes the reference route, as the reference takes its library solve,
    and counts no fallback."""
    rng = np.random.default_rng(4)
    Bsz, m, k = 5, 17, 3
    W = rng.normal(0, 1, (Bsz, m, m))
    M = torch.as_tensor(np.einsum("bij,bkj->bik", W, W) / m + np.eye(m),
                        dtype=torch.float32)
    rhs = torch.as_tensor(rng.normal(0, 1, (Bsz, m, k)), dtype=torch.float32)
    reg = torch.full((Bsz,), 1e-6)
    with pytest.raises(ValueError):
        cholesky.batched_cholesky_solve(M, rhs)
    cholesky.reset_launch_counts()
    riccati.reset_counts()
    X, bad = riccati.chol_solve_kernel(M, rhs, reg)
    X_ref, bad_ref = riccati.chol_solve_reference(M, rhs, reg)
    np.testing.assert_array_equal(X.numpy(), X_ref.numpy())
    np.testing.assert_array_equal(bad.numpy(), bad_ref.numpy())
    assert riccati.read_fallbacks() == 0
    assert cholesky.batched_cholesky_solve.launches == 0


# the reference's BENCH_MODE=riccati JSON keys (bench.py:227-234)
RICCATI_MODE_FIELDS = ("metric", "value", "unit", "vs_baseline", "horizons",
                       "device")


@pytest.mark.parametrize("cuda_chol", [[], ["--cuda-chol"]],
                         ids=["reference-route", "kernel-route"])
def test_bench_riccati_mode_prints_the_reference_fields(capsys, cuda_chol):
    """`python -m aircraft_tpu_torch.bench --mode riccati` at two short
    horizons: the reference's keys, each horizon's row, and the two sweeps
    agreeing within 2e-3."""
    from aircraft_tpu_torch import bench

    bench.main(["--device", "cpu", "--mode", "riccati", "--horizons", "6,17",
                "--reps", "1"] + cuda_chol)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(RICCATI_MODE_FIELDS) <= set(line)
    assert line["device"] == "cpu" and line["matmul_precision"] == "highest"
    assert line["cuda_chol"] == bool(cuda_chol)
    assert set(line["horizons"]) == {"N6", "N17"}
    for row in line["horizons"].values():
        assert set(row) == {"seq_ms", "assoc_ms", "speedup", "max_K_diff"}
        assert row["max_K_diff"] < ATOL
    assert line["value"] == line["horizons"]["N17"]["speedup"]


def test_unread_fallback_counts_stay_bounded_and_exact(monkeypatch):
    """Kernel-route calls whose counts nobody reads add into one 0-dim
    device counter per device, and the one read still counts every
    fallback."""
    monkeypatch.setattr(riccati, "batched_cholesky_solve",
                        lambda a, rhs: torch.full_like(rhs, float("nan")))
    M = torch.eye(2).repeat(3, 1, 1)
    rhs, reg = torch.ones(3, 2, 1), torch.full((3,), 1e-6)
    riccati.reset_counts()
    calls = 2053
    for _ in range(calls):
        riccati.chol_solve_kernel(M, rhs, reg)
    counter = riccati._counters[torch.device("cpu")]
    assert counter.ndim == 0 and len(riccati._counters) == 1
    assert riccati.read_fallbacks() == calls
    assert riccati.read_fallbacks() == calls     # nothing new: no second read
    riccati.reset_counts()


# The two worst scenarios of the headline fleet window's first exact
# expansion (bench.build_problem and fleet_states, B=256, N=50, the CPU;
# each scenario's kernel-route sweep alone): 186 is the kernel route's
# worst, 202 the float64 sweeps' widest split.
EXACT_WORST = (186, 202)
# bench.plant_best_glide's (v_ref, glide_ld) for the MLP plant at seed 0,
# taken as given: finding it costs three trims (~7 s on a CPU)
FLEET_GLIDE = (32.0, 9.44715661069095)
GAIN_TOL = 1e-2      # the repo's tolerance on Riccati gains, relative


def _rel(a, b):
    """Per scenario max |a − b| / (1 + max |b|), non-finite as inf."""
    d = (a.double() - b.double()).abs().flatten(1).amax(1)
    r = d / (1 + b.double().abs().flatten(1).amax(1))
    return r.nan_to_num(nan=float("inf"))


def test_exact_hessian_takes_the_sequential_sweep(monkeypatch):
    """The exact-Hessian solver uses the sequential sweep (the default of
    ``SolverConfig``) on the reference route.  Why, from each sweep in
    float32 against itself in float64 on the same float32 expansion (the
    headline window's first exact expansion; chip_smoke.py prints the same
    numbers over all 256 scenarios on the card):

    * on the reference route each sweep reproduces its own float64 run
      within the gains' tolerance: neither sweep's split from the other is
      its own rounding;
    * the two float64 sweeps differ far beyond it where Quu is indefinite:
      the sequential sweep shifts each indefinite Quu (Gershgorin) before
      it forms V and clamps V, as the reference's default solver does,
      while the associative one combines the unshifted value functions.
      They are two computations there, and agree only on a
      positive-definite expansion (the LQ batch above);
    * on the kernel route the batched-Cholesky kernel's clamped pivots
      keep some indefinite systems finite, and the fallback fires only on
      a non-finite result, so gains far from float64 come through on both
      sweeps at a small batch (at B=256 a non-finite neighbour trips the
      sequential sweep's whole-batch fallback at most knots).  The
      reference's kernel and fallback have the same rule.

    Held on the two worst scenarios at B=2, N=50."""
    from aircraft_tpu_torch import bench
    from aircraft_tpu_torch.config import SolverConfig
    from aircraft_tpu_torch.solvers import ilqr
    from aircraft_tpu_torch.solvers import ocp as ocp_mod

    assert (SolverConfig().hessian, SolverConfig().riccati) == (
        "exact", "sequential")
    monkeypatch.setattr(bench, "plant_best_glide",
                        lambda *a, **k: FLEET_GLIDE)
    _, params, ocp, track, v_ref, _ = bench.build_problem("cpu")
    z0s, trim = bench.fleet_states(params, track, 256, v_ref)
    z0s = z0s[list(EXACT_WORST)]
    config = bench.headline_config(1, 4)
    N = bench.N_HORIZON
    us = ocp.control_unsquash(trim.control[:7]).reshape(1, 1, 7).expand(
        len(EXACT_WORST), N, 7).contiguous()
    xs, _ = ilqr.initial_rollout(ocp, z0s, us)
    al = ocp_mod.init_al_state(ocp, z0s, us[:, 0], N,
                               mu0=config.penalty_init)
    A, Bm = ilqr.linearize(ocp, xs, us)
    quad = [ilqr._san(t, 1e8) for t in ilqr.quadraticize(ocp, al, xs, us)]
    reg = torch.full((len(EXACT_WORST),), config.reg_init)
    a32 = (A, Bm, *quad, reg)
    a64 = tuple(t.double() for t in a32)

    min_eig = []
    real = riccati.chol_solve_reference

    def recording(M, rhs, reg):
        min_eig.append(torch.linalg.eigvalsh(riccati._sym(M)).amin(-1))
        return real(M, rhs, reg)

    K = {}
    for mode in ("sequential", "associative"):
        K[mode, "ref32"] = ilqr.backward_pass(*a32, mode)[0]
        if mode == "sequential":
            monkeypatch.setattr(riccati, "chol_solve_reference", recording)
        K[mode, "ref64"] = ilqr.backward_pass(*a64, mode)[0]
        monkeypatch.setattr(riccati, "chol_solve_reference", real)
        K[mode, "kernel32"] = ilqr.backward_pass(*a32, mode,
                                                 cuda_chol=True)[0]
    riccati.reset_counts()
    indefinite = (torch.stack(min_eig, dim=1) < 0).sum(1)
    assert (indefinite > 0).all(), indefinite
    for mode in ("sequential", "associative"):
        own = _rel(K[mode, "ref32"], K[mode, "ref64"])
        assert (own <= GAIN_TOL).all(), (mode, own)
        # the shared failure rule: finite, and nothing like float64
        assert torch.isfinite(K[mode, "kernel32"]).all()
        assert _rel(K[mode, "kernel32"], K[mode, "ref64"])[0] > 1.0, mode
    split = _rel(K["associative", "ref64"], K["sequential", "ref64"])
    assert (split > 0.1).all(), split
