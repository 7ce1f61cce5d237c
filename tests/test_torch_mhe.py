"""The port's moving-horizon wind estimator and PID attitude control
against the JAX package.

``estimate_wind``: measurements flown through the reference's plant in a
known wind (numpy arrays handed to both packages); the two estimates
agree within 1e-3 m/s and find the wind.  PID: the scalar step and the
attitude hold, rtol = atol = 1e-5 (pure functions), and a closed-loop
episode at 2e-4 (a rollout, ``tests/test_kernels.py:51``).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp

from aircraft_tpu.control import mhe as jmhe
from aircraft_tpu.control import pid as jpid
from aircraft_tpu.dynamics import aircraft as jac
from aircraft_tpu.solvers import integrators as jint

from aircraft_tpu_torch.control import mhe as tmhe
from aircraft_tpu_torch.control import pid as tpid

from torch_port_problem import jax_params, port_params

PURE = dict(rtol=1e-5, atol=1e-5)
X0 = np.array([0, 0, -200, 30, 0, 0, 0, 0, 0, 1, 0, 0, 0], np.float32)


@pytest.fixture(scope="module")
def plant():
    jp = jax_params("nn")
    return jp, port_params(jp)


def _measurements(jp, wind, W=12, dt=0.02, substeps=2, seed=0):
    """W + 1 states flown by the reference's plant in ``wind`` under small
    random controls, and the W controls."""
    rng = np.random.default_rng(seed)
    us = np.zeros((W, 7), np.float32)
    us[:, :3] = rng.uniform(-1.0, 1.0, (W, 3))
    step = jax.jit(lambda x, u: jint.step(
        jp, x, u, dt, substeps=substeps, normalize="step",
        derivative_fn=lambda xx, uu: jac.state_derivative(
            jp, xx, uu, wind=jnp.asarray(wind))))
    xs = [jnp.asarray(X0)]
    for u in us:
        xs.append(step(xs[-1], jnp.asarray(u)))
    return np.stack([np.asarray(x) for x in xs]), us


def test_estimate_wind(plant):
    jp, tp = plant
    wind = np.array([4.0, -3.0, 0.5], np.float32)
    xs, us = _measurements(jp, wind)
    ref = jmhe.estimate_wind(jp, jnp.asarray(xs), jnp.asarray(us),
                             jnp.asarray(0.02), 2, 8)
    out = tmhe.estimate_wind(tp, xs, us, 0.02, 2, 8, device="cpu")
    np.testing.assert_allclose(out.wind.numpy(), np.asarray(ref.wind),
                               atol=1e-3)
    np.testing.assert_allclose(out.wind.numpy(), wind, atol=0.1)
    assert bool(out.converged) and bool(ref.converged)
    np.testing.assert_allclose(float(out.residual), float(ref.residual),
                               rtol=1e-2, atol=1e-5)


def test_pid_step():
    g = tpid.PIDGains(kp=2.0, ki=0.1, kd=0.5)
    rng = np.random.default_rng(1)
    ts, js = tpid.pid_init(3, device="cpu"), jpid.pid_init(3)
    for _ in range(5):
        e = rng.uniform(-2.0, 2.0, 3).astype(np.float32)
        out, ts = tpid.pid_step(g, ts, torch.as_tensor(e), 0.05)
        ref, js = jpid.pid_step(jpid.PIDGains(*g), js, jnp.asarray(e), 0.05)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **PURE)
        np.testing.assert_allclose(ts.integral.numpy(),
                                   np.asarray(js.integral), **PURE)


def test_attitude_pid_control():
    rng = np.random.default_rng(2)
    x = X0.copy()
    q = rng.standard_normal(4).astype(np.float32)
    q[3] = abs(q[3]) + 2.0
    x[6:10] = q / np.linalg.norm(q)
    ts, js = tpid.attitude_pid_init("cpu"), jpid.attitude_pid_init()
    for roll, pitch in ((0.3, 0.1), (-0.2, 0.05)):
        u, ts = tpid.attitude_pid_control(torch.as_tensor(x), ts, roll,
                                          pitch, 0.02)
        ur, js = jpid.attitude_pid_control(jnp.asarray(x), js, roll, pitch,
                                           0.02)
        np.testing.assert_allclose(u.numpy(), np.asarray(ur), **PURE)


def test_simulate_pid(plant):
    jp, tp = plant
    T = 25
    roll = np.linspace(0.0, 0.3, T).astype(np.float32)
    pitch = np.full(T, 0.05, np.float32)
    xs, us = tpid.simulate_pid(tp, X0, roll, pitch, 0.02, substeps=2,
                               device="cpu")
    xj, uj = jax.jit(lambda x0, r, p: jpid.simulate_pid(
        jp, x0, r, p, 0.02, substeps=2))(jnp.asarray(X0), jnp.asarray(roll),
                                         jnp.asarray(pitch))
    np.testing.assert_allclose(xs.numpy(), np.asarray(xj), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(us.numpy(), np.asarray(uj), rtol=2e-4,
                               atol=2e-4)
