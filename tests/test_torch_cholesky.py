"""The port's batched-Cholesky kernel (its plain version, on the CPU)
against the TPU kernel ``make_batched_cholesky_solve`` in Pallas interpret
mode, and the Riccati sweep's kernel route, whole-batch fallback included,
against the reference's ``_chol_solve_vmap``.

Tolerance rtol = atol = 2e-3, as tests/test_kernels.py holds the TPU
kernel: both factor in float32 in the same order, but the batch of
random SPD systems has condition numbers up to ~1e2.  The fallback's
flags must agree exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aircraft_tpu.kernels.cholesky_kernel import make_batched_cholesky_solve
from aircraft_tpu.solvers import riccati as jriccati

from aircraft_tpu_torch.kernels import cholesky
from aircraft_tpu_torch.solvers import riccati

TOL = dict(rtol=2e-3, atol=2e-3)


def spd_batch(B, m, k, seed, shift=2.0):
    """A = W Wᵀ/m + shift·I and rhs ~ N(0, 1), as the reference tests
    build them."""
    rng = np.random.default_rng(seed)
    W = rng.normal(0, 1, (B, m, m)).astype(np.float32)
    A = (np.einsum("bij,bkj->bik", W, W) / m
         + shift * np.eye(m)[None]).astype(np.float32)
    return A, rng.normal(0, 1, (B, m, k)).astype(np.float32)


@pytest.mark.parametrize("m,k,seed", [(7, 15, 1), (8, 9, 4)])
def test_plain_kernel_matches_pallas_kernel(m, k, seed):
    """(m=7, k=15): the iLQR sweep's Quu and [Qu | Qux] at the MHTT state
    width 14; (m=8, k=9): tests/test_kernels.py's shape."""
    A, rhs = spd_batch(128, m, k, seed)
    ref = np.asarray(make_batched_cholesky_solve(m, k, interpret=True)(
        jnp.asarray(A), jnp.asarray(rhs)))
    X = cholesky.batched_cholesky_solve(torch.as_tensor(A),
                                        torch.as_tensor(rhs))
    np.testing.assert_allclose(X.numpy(), ref, **TOL)
    assert cholesky.batched_cholesky_solve.launches == 0   # CPU: plain version


def test_plain_kernel_has_no_fail_flag_and_propagates_nan():
    """Pivots are clamped at 1e-12 (a negative pivot is not flagged) and a
    NaN stays NaN, as jnp.maximum keeps it."""
    a = torch.eye(3).repeat(2, 1, 1)
    a[0, 1, 1] = -4.0
    a[1, 2, 2] = float("nan")
    X = cholesky.cholesky_solve_plain(a, torch.ones(2, 3, 1))
    assert float(X[0, 1, 0]) == pytest.approx(1e12, rel=1e-3)
    assert torch.isnan(X[1, 2, 0])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        cholesky.batched_cholesky_solve(torch.eye(17)[None],
                                        torch.ones(1, 17, 1))
    with pytest.raises(TypeError):
        cholesky.batched_cholesky_solve(torch.eye(3, dtype=torch.float64)[None],
                                        torch.ones(1, 3, 1, dtype=torch.float64))


def test_kernel_route_whole_batch_fallback_matches_reference():
    """One indefinite matrix (1e3 (ones - 2I): eigenvalues 2e3 and -2e3)
    in a batch of SPD ones: the clamped-pivot kernel overflows on it, so
    the whole batch takes the reference route (Cholesky, Gershgorin
    retry), in the port as in the reference's custom_vmap.  m = 4 keeps
    the interpret-mode kernel cheap."""
    B, m, k = 8, 4, 3
    M, rhs = spd_batch(B, m, k, seed=7)
    M[3] = 1e3 * (np.ones((m, m), np.float32) - 2.0 * np.eye(m, dtype=np.float32))
    reg = np.full(B, 1e-6, np.float32)
    try:
        jriccati.enable_pallas_chol(True, interpret=True)
        X_ref, bad_ref = jax.jit(jax.vmap(jriccati._chol_solve))(
            jnp.asarray(M), jnp.asarray(rhs), jnp.asarray(reg))
    finally:
        jriccati.enable_pallas_chol(False)
    tM, trhs, treg = (torch.as_tensor(t) for t in (M, rhs, reg))
    assert not bool(torch.isfinite(cholesky.batched_cholesky_solve(
        0.5 * (tM + tM.transpose(-1, -2)) + 1e-6 * torch.eye(m), trhs)).all())
    riccati.reset_counts()
    X, bad = riccati.chol_solve_kernel(tM, trhs, treg)
    assert riccati.read_fallbacks() == 1
    np.testing.assert_array_equal(bad.numpy(), np.asarray(bad_ref))
    np.testing.assert_allclose(X.numpy(), np.asarray(X_ref), **TOL)
    # the reference route alone gives the same
    X2, bad2 = riccati.chol_solve_reference(tM, trhs, treg)
    np.testing.assert_array_equal(bad2.numpy(), bad.numpy())
    np.testing.assert_allclose(X2.numpy(), X.numpy(), rtol=0, atol=0)


def test_kernel_route_keeps_a_healthy_batch():
    """No fallback on SPD systems: the kernel's X and no flags."""
    M, rhs = spd_batch(16, 7, 15, seed=8)
    tM, trhs = torch.as_tensor(M), torch.as_tensor(rhs)
    riccati.reset_counts()
    X, bad = riccati.chol_solve_kernel(tM, trhs, torch.full((16,), 1e-6))
    assert riccati.read_fallbacks() == 0 and not bool(bad.any())
    X_ref, bad_ref = riccati.chol_solve_reference(tM, trhs,
                                                  torch.full((16,), 1e-6))
    assert not bool(bad_ref.any())
    np.testing.assert_allclose(X.numpy(), X_ref.numpy(), **TOL)


def test_reference_route_flags_an_unrepairable_matrix():
    """A NaN matrix fails both factorisations: L = I (X = rhs) and the
    flag, as the reference's _chol_solve_base."""
    M = torch.eye(4).repeat(2, 1, 1)
    M[1, 0, 0] = float("nan")
    rhs = torch.arange(8.0).reshape(2, 4, 1)
    X, bad = riccati.chol_solve_reference(M, rhs, torch.full((2,), 1e-6))
    assert bad.tolist() == [False, True]
    np.testing.assert_allclose(X[1].numpy(), rhs[1].numpy())
