"""The port's error-state LQR and trim stability analysis against the
JAX package, about the reference's own trim of the default-aero glider
at 50 m/s (the reference's example and tests; the trim point is handed
to the port as numpy arrays).

The reference's functions run compiled (``jax.jit``): run op by op its
forward-mode Jacobians cost tens of seconds on the CPU.

Tolerances: ``inject`` / ``retract`` rtol = atol = 1e-5 (pure
functions); the error-step and step-map Jacobians 2e-4 (single steps);
DARE solutions and LQR gains within 1e-4 of their largest entry;
eigenvalues matched within 1e-3·(1 + |λ|).
"""

import os
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp

from aircraft_tpu.config import glider_config as jax_glider_config
from aircraft_tpu.dynamics.aircraft import AircraftParams as JaxParams
from aircraft_tpu.solvers import lqr as jlqr
from aircraft_tpu.solvers import trim as jtrim

from aircraft_tpu_torch.config import glider_config
from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
from aircraft_tpu_torch.solvers import lqr as tlqr
from aircraft_tpu_torch.solvers import trim as ttrim

PURE = dict(rtol=1e-5, atol=1e-5)
STEP = dict(rtol=2e-4, atol=2e-4)


def _rel_close(out, ref, tol=1e-4):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert np.abs(out - ref).max() <= tol * np.abs(ref).max(), (
        np.abs(out - ref).max(), np.abs(ref).max())


def _eig_close(out, ref):
    """Every eigenvalue of each set has a partner in the other within
    1e-3·(1 + |λ|)."""
    out, ref = np.ravel(out), np.ravel(ref)
    for a, b in ((out, ref), (ref, out)):
        d = np.abs(a[:, None] - b[None, :]).min(axis=1)
        assert np.all(d <= 1e-3 * (1.0 + np.abs(a))), d.max()


@pytest.fixture
def jit_reference(monkeypatch):
    """The reference's Jacobian functions compiled, called as before."""
    for name in ("continuous_jacobians", "discrete_jacobians"):
        monkeypatch.setattr(jtrim, name, jax.jit(
            getattr(jtrim, name),
            static_argnames=("substeps",) if "discrete" in name else ()))


@pytest.fixture(scope="module")
def op():
    """(jax params, port params, x_ref, u_ref (7), trim control (10)) at
    the reference's trim, the CoM frozen into both plants."""
    cfg = jax_glider_config()
    jp_trim = JaxParams.from_config(cfg.aircraft, com_in_control=True)
    res = jtrim.multistart_trim(jp_trim, jax.random.PRNGKey(0), n_starts=16,
                                target_airspeed=50.0)
    assert float(res.residual) < 1e-2
    jp = JaxParams.from_config(cfg.aircraft).replace(com=res.control[7:10])
    tp = AircraftParams.from_config(glider_config().aircraft, device="cpu")
    tp = replace(tp, com=torch.as_tensor(np.asarray(res.control[7:10])))
    x = np.asarray(res.state, np.float32)
    u10 = np.asarray(res.control, np.float32)
    return jp, tp, x, u10[:7], u10


def test_inject_retract():
    rng = np.random.default_rng(3)
    x_ref = np.array([0, 0, -200, 50, 0, 0, 0, 0, 0, 1, 0, 0, 0], np.float32)
    q = rng.standard_normal((8, 4)).astype(np.float32)
    xs = np.tile(x_ref, (8, 1))
    xs[:, 6:10] = q / np.linalg.norm(q, axis=1, keepdims=True)
    xs[:, :6] += rng.standard_normal((8, 6)).astype(np.float32)
    xi = rng.uniform(-0.5, 0.5, (8, 12)).astype(np.float32)
    np.testing.assert_allclose(
        tlqr.inject(torch.as_tensor(xs), torch.as_tensor(xi)).numpy(),
        np.asarray(jlqr.inject(jnp.asarray(xs), jnp.asarray(xi))), **PURE)
    np.testing.assert_allclose(
        tlqr.retract(torch.as_tensor(xs), torch.as_tensor(x_ref)).numpy(),
        np.asarray(jlqr.retract(jnp.asarray(xs), jnp.asarray(x_ref))),
        **PURE)
    back = tlqr.retract(tlqr.inject(torch.as_tensor(x_ref),
                                    torch.as_tensor(xi)),
                        torch.as_tensor(x_ref))
    np.testing.assert_allclose(back.numpy(), xi, atol=1e-5)


def test_dare_and_gain_on_random_systems():
    from scipy.linalg import solve_discrete_are

    for trial in range(3):
        rng = np.random.default_rng(trial)
        n, m = 8, 3
        A = (rng.normal(0, 0.4, (n, n)) + 0.6 * np.eye(n)).astype(np.float32)
        B = rng.normal(0, 1, (n, m)).astype(np.float32)
        Q, R = np.eye(n, dtype=np.float32), np.eye(m, dtype=np.float32)
        K, P = tlqr.dare_gain(*(torch.as_tensor(a) for a in (A, B, Q, R)))
        Kj, Pj = jlqr.dare_gain(*(jnp.asarray(a) for a in (A, B, Q, R)))
        _rel_close(P.numpy(), Pj)
        _rel_close(K.numpy(), Kj)
        _rel_close(P.numpy(), solve_discrete_are(A, B, Q, R))
    Kc, Pc = tlqr.continuous_lqr(A, B, Q, R)
    Kcj, Pcj = jlqr.continuous_lqr(A, B, Q, R)
    np.testing.assert_allclose(Kc, Kcj)
    np.testing.assert_allclose(Pc, Pcj)


def test_design_about_trim(op):
    """A, B of the error-step map (2e-4), then K and P (1e-4 of the
    largest entry), both at dt = 0.01 with 2 substeps."""
    jp, tp, x, u, _ = op
    jc = jax.jit(jlqr.design, static_argnames=("dt", "substeps"))(
        jp, jnp.asarray(x), jnp.asarray(u), dt=0.01, substeps=2)
    tc = tlqr.design(tp, x, u, dt=0.01, substeps=2, device="cpu")
    np.testing.assert_allclose(tc.A.numpy(), np.asarray(jc.A), **STEP)
    np.testing.assert_allclose(tc.B.numpy(), np.asarray(jc.B), **STEP)
    # the Riccati solve held on the same linearisation
    K, P = tlqr.dare_gain(torch.as_tensor(np.asarray(jc.A)),
                          torch.as_tensor(np.asarray(jc.B)),
                          torch.as_tensor(np.asarray(jnp.diag(jnp.asarray(
                              [0, 0, 0, 1, 1, 1, 50, 50, 50, 5, 5, 5.0]))),
                              dtype=torch.float32), torch.eye(7))
    _rel_close(P.numpy(), jc.P)
    _rel_close(K.numpy(), jc.K)
    _rel_close(tc.K.numpy(), jc.K, 1e-3)
    # the closed loop: three position modes on the unit circle, the rest
    # inside it
    cl = tc.A.double() - tc.B.double() @ tc.K.double()
    mags = np.sort(np.abs(np.linalg.eigvals(cl.numpy())))[::-1]
    np.testing.assert_allclose(mags[:3], 1.0, atol=1e-3)
    assert mags[3] < 1.0
    # control and the closed-loop step against the reference's
    rng = np.random.default_rng(5)
    xi = (0.05 * rng.standard_normal((4, 12))).astype(np.float32)
    xs = tlqr.inject(torch.as_tensor(x), torch.as_tensor(xi))
    np.testing.assert_allclose(
        tlqr.control(tc, xs).numpy(),
        np.asarray(jax.jit(jlqr.control)(jc, jnp.asarray(xs.numpy()))),
        **STEP)
    x1, _ = tlqr.closed_loop_step(tp, tc, 0.01, substeps=2)(xs, None)
    x1j = jax.jit(jax.vmap(lambda xx: jlqr.closed_loop_step(
        jp, jc, 0.01, 2)(xx, None)[0]))(jnp.asarray(xs.numpy()))
    np.testing.assert_allclose(x1.numpy(), np.asarray(x1j), **STEP)


def test_stability_eigenvalues(op, jit_reference):
    jp, tp, x, u, _ = op
    A, B = ttrim.continuous_jacobians(tp, torch.as_tensor(x),
                                      torch.as_tensor(u))
    Aj, Bj = jtrim.continuous_jacobians(jp, jnp.asarray(x), jnp.asarray(u))
    np.testing.assert_allclose(A.numpy(), np.asarray(Aj), **STEP)
    np.testing.assert_allclose(B.numpy(), np.asarray(Bj), **STEP)
    _eig_close(ttrim.stability_eigenvalues(tp, torch.as_tensor(x),
                                           torch.as_tensor(u)),
               jtrim.stability_eigenvalues(jp, jnp.asarray(x),
                                           jnp.asarray(u)))


def test_discrete_stability_analysis(op, jit_reference):
    """The perturbation cloud (numpy, the same seed in both) and the dt
    sweep at a reduced size: spectra, radii and condition numbers."""
    jp, tp, x, u, _ = op
    sweep = np.logspace(-3, -0.5, 6)
    kw = dict(dt=0.01, n_perturb=6, dt_sweep=sweep, seed=2)
    ref = jtrim.discrete_stability_analysis(jp, jnp.asarray(x),
                                            jnp.asarray(u), **kw)
    out = ttrim.discrete_stability_analysis(tp, x, u, device="cpu", **kw)
    for a, b in zip(out.eigenvalues, ref.eigenvalues):
        _eig_close(a, b)
    np.testing.assert_allclose(out.spectral_radius, ref.spectral_radius,
                               rtol=1e-3)
    np.testing.assert_allclose(out.dt_spectral_radius,
                               ref.dt_spectral_radius, rtol=1e-3)
    np.testing.assert_allclose(out.condition_numbers, ref.condition_numbers,
                               rtol=1e-2)
    np.testing.assert_array_equal(out.dt_sweep, sweep)
