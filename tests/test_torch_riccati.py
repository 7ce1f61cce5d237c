"""The port's sequential Riccati sweep against ``jax.vmap`` of the
reference's ``riccati.backward_sequential``, on both Quu-solve routes:
the reference route (Cholesky with the Gershgorin retry) against the
reference's, and the kernel route (the batched-Cholesky kernel's plain
version) against the reference's Pallas kernel in interpret mode.

Problems: tests/test_riccati.py's batched one (3 scenarios, N=6, n=5,
m=3) and one at the MHTT shapes (n=14, m=7, N=6).  Held at atol 2e-3 as
tests/test_riccati.py holds the two reference routes.
"""

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
    assert riccati.chol_fallbacks == 0
    assert cholesky.batched_cholesky_solve.launches == 0   # CPU: plain version

