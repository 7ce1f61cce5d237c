"""The port's SLSQP multiple-shooting oracle against the JAX package's on
the same problems, with inputs made by numpy.

  * the double integrator (float32 matrices @ the float64 decision
    vector): both against the exact finite-horizon Riccati controls at
    the reference test's 1e-5;
  * the quadrotor control problem (N=16, dt 0.08) in float64: port oracle
    against reference oracle at tests/test_reference_nlp.py's float64
    tolerances (max |du| < 1e-4, relative cost < 1e-9);
  * an MLP glider window (N=4, 5 SLSQP iterations), whose float32 MLP
    weights meet the float64 states in matrix products: the port's
    oracle evaluates everything in float64, the reference keeps the
    arithmetic among its float32 constants in float32, so the two
    problems part by that rounding (~1e-8 relative in the dynamics);
    held at 1e-5 in the controls, 1e-5 (1 + |x|) in the states and 1e-6
    relative in the cost.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax.numpy as jnp

from aircraft_tpu.control.quadrotor import build_quadrotor_ocp as jax_quad_ocp
from aircraft_tpu.solvers.ocp import OCPFunctions as JaxOCP
from aircraft_tpu.solvers.reference_nlp import solve_reference_nlp as jax_nlp

from aircraft_tpu_torch.control.quadrotor import build_quadrotor_ocp
from aircraft_tpu_torch.dynamics.coefficients import load_mlp, mlp_forward
from aircraft_tpu_torch.solvers.ocp import OCPFunctions
from aircraft_tpu_torch.solvers.reference_nlp import (_Float64,
                                                       solve_reference_nlp)

from torch_port_problem import build_pair, fleet_inputs

DT, N_LQR = 0.1, 20
A = np.array([[1.0, DT], [0.0, 1.0]], np.float32)
B = np.array([[0.5 * DT**2], [DT]], np.float32)
Q = np.diag([1.0, 0.1]).astype(np.float32)
R = np.array([[0.01]], np.float32)
QF = np.diag([100.0, 10.0]).astype(np.float32)


def _jax_lqr_ocp():
    a, b, q, r, qf = (jnp.asarray(m) for m in (A, B, Q, R, QF))
    return JaxOCP(step=lambda x, u, k: a @ x + b @ u,
                  stage_cost=lambda x, u, k: 0.5 * x @ q @ x + 0.5 * u @ r @ u,
                  terminal_cost=lambda x: 0.5 * x @ qf @ x)


def _port_lqr_ocp():
    a, b, q, r, qf = (torch.as_tensor(m) for m in (A, B, Q, R, QF))

    def quad(v, m):
        return 0.5 * torch.einsum("...i,ij,...j->...", v, m, v)

    return OCPFunctions(step=lambda x, u, k: x @ a.T + u @ b.T,
                        stage_cost=lambda x, u, k: quad(x, q) + quad(u, r),
                        terminal_cost=lambda x: quad(x, qf))


def _riccati_controls(x0):
    a, b = A.astype(np.float64), B.astype(np.float64)
    q, r = Q.astype(np.float64), R.astype(np.float64)
    P = QF.astype(np.float64)
    Ks = []
    for _ in range(N_LQR):
        K = np.linalg.solve(r + b.T @ P @ b, b.T @ P @ a)
        P = q + a.T @ P @ a - a.T @ P @ b @ K
        Ks.append(K)
    xs, us = [x0.astype(np.float64)], []
    for K in Ks[::-1]:
        us.append(-K @ xs[-1])
        xs.append(a @ xs[-1] + b @ us[-1])
    return np.stack(us)


def test_double_integrator_matches_riccati_and_the_reference():
    x0 = np.array([1.0, 0.0], np.float32)
    us0 = np.zeros((N_LQR, 1), np.float32)
    port = solve_reference_nlp(_port_lqr_ocp(), x0, us0, device="cpu")
    ref = jax_nlp(_jax_lqr_ocp(), x0, us0)
    assert port.success, port.message
    assert port.violation < 1e-10
    np.testing.assert_allclose(port.us, _riccati_controls(x0), atol=1e-5)
    np.testing.assert_allclose(port.us, ref.us, atol=1e-5)
    assert port.xs.dtype == port.us.dtype == np.float64


def test_quadrotor_control_matches_the_reference_oracle_f64():
    N, dt = 16, 0.08
    target = np.array([2.0, 1.0, -4.0], np.float32)
    x0 = np.zeros(13, np.float32)
    x0[6] = 1.0
    us0 = np.full((N, 4), 9.81 / 4.0, np.float32)
    ref = jax_nlp(jax_quad_ocp(target, dt=dt), x0, us0, maxiter=250)
    port = solve_reference_nlp(build_quadrotor_ocp(target, dt=dt,
                                                   device="cpu"),
                               x0, us0, maxiter=250, device="cpu")
    assert ref.success, ref.message
    assert port.success, port.message
    assert port.violation < 1e-8
    max_du = np.abs(port.us - ref.us).max()
    rel_cost = abs(port.cost - ref.cost) / abs(ref.cost)
    assert max_du < 1e-4, max_du
    assert rel_cost < 1e-9, rel_cost


def test_mixed_precision_products_run_in_float64():
    """float32 MLP weights @ float64 inputs: torch refuses the product on
    its own; under the oracle's promotion it runs, in float64, and equals
    a float64 numpy evaluation of the same float32 weights."""
    cp = load_mlp(device="cpu")
    x = np.random.default_rng(0).normal(0, 1, (8, 5)) * np.asarray(
        cp.input_std) + np.asarray(cp.input_mean)
    with _Float64():
        out = mlp_forward(cp, torch.as_tensor(x))
    assert out.dtype == torch.float64
    w = {k: np.asarray(getattr(cp, k), np.float64) for k in (
        "w0", "b0", "w1", "b1", "w2", "b2", "input_mean", "input_std",
        "output_mean", "output_std")}
    h = (x - w["input_mean"]) / w["input_std"]
    h = np.tanh((h @ w["w0"] + w["b0"]) @ w["w1"] + w["b1"])
    want = (h @ w["w2"] + w["b2"]) * w["output_std"] + w["output_mean"]
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-12, atol=1e-12)


def test_mlp_window_matches_the_reference_oracle():
    jax_side, port_side = build_pair("nn", squash=False)
    N = 4
    z, ws = fleet_inputs(1, N, reversed_lanes=0)
    ref = jax_nlp(jax_side["ocp"], z[0], ws[0], maxiter=5)
    port = solve_reference_nlp(port_side["ocp"], z[0], ws[0], maxiter=5,
                               device="cpu")
    assert port.nit == ref.nit == 5
    assert np.all(np.isfinite(port.xs)) and np.all(np.isfinite(port.us))
    np.testing.assert_allclose(port.us, ref.us, rtol=0, atol=1e-5)
    assert np.all(np.abs(port.xs - ref.xs) <= 1e-5 * (1 + np.abs(ref.xs)))
    assert abs(port.cost - ref.cost) <= 1e-6 * abs(ref.cost)
