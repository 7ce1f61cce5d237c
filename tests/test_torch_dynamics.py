"""The port's quaternion algebra, flow state, 6-DoF derivative and RK4 step
against the JAX package on the same numpy inputs, under both coefficient
models the window kernels compute (the trained MLP and the default aero),
with states whose body-frame flow is reversed (u_rel < 0, alpha about ±π).

Tolerance: rtol = atol = 2e-4, the rollout tolerance of
tests/test_kernels.py, for float32 single evaluations and single steps.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax.numpy as jnp

from aircraft_tpu.dynamics import aircraft as jac
from aircraft_tpu.ops import quaternion as jq
from aircraft_tpu.solvers import integrators as jint

from aircraft_tpu_torch.dynamics import aircraft as tac
from aircraft_tpu_torch.ops import quaternion as tq
from aircraft_tpu_torch.solvers import integrators as tint

from torch_port_problem import jax_params, port_params

TOL = dict(rtol=2e-4, atol=2e-4)
B = 16


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def _quats(rng, n):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _states(seed=0):
    """Flight states at 20-40 m/s in random attitudes and rates; the last
    quarter flies backwards through the air."""
    rng = np.random.default_rng(seed)
    x = np.zeros((B, 13), np.float32)
    x[:, :3] = rng.uniform(-100, 100, (B, 3))
    x[:, 2] -= 200.0
    q = _quats(rng, B)
    q[:, 3] = np.abs(q[:, 3]) + 1.0                # near-level attitudes
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x[:, 6:10] = q
    v_body = np.stack([rng.uniform(20, 40, B), rng.uniform(-3, 3, B),
                       rng.uniform(-3, 3, B)], axis=1).astype(np.float32)
    v_body[-B // 4:, 0] *= -1.0
    x[:, 3:6] = np.asarray(jq.rotate(jnp.asarray(q), jnp.asarray(v_body)))
    x[:, 10:13] = rng.uniform(-0.5, 0.5, (B, 3))
    u = np.zeros((B, 7), np.float32)
    u[:, :3] = rng.uniform(-5, 5, (B, 3))
    u[:, 6] = rng.uniform(0, 1, B)
    return x, u


@pytest.mark.parametrize("name", ["multiply", "conjugate", "normalize",
                                  "rotate", "rotate_inv", "derivative",
                                  "expmap", "inverse", "to_rotation_matrix",
                                  "from_axis_angle", "integrate_expmap",
                                  "to_euler", "slerp"])
def test_quaternion_op(name):
    rng = np.random.default_rng(1)
    q1, q2 = _quats(rng, B), _quats(rng, B)
    v = rng.standard_normal((B, 3)).astype(np.float32)
    axis = v / np.linalg.norm(v, axis=1, keepdims=True)
    t = rng.uniform(0.0, 1.0, (B, 1)).astype(np.float32)
    q_near = q1 + 1e-7 * q2            # slerp's lerp branch on some rows
    q_near[B // 2:] = q2[B // 2:]
    args = {"multiply": (q1, q2), "conjugate": (q1,), "normalize": (2.0 * q1,),
            "rotate": (q1, v), "rotate_inv": (q1, v), "derivative": (q1, v),
            "expmap": (0.3 * v,), "inverse": (2.0 * q1,),
            "to_rotation_matrix": (q1,),
            "from_axis_angle": (axis, 3.0 * t[:, 0]),
            "integrate_expmap": (q1, v, np.float32(0.05)),
            "to_euler": (q1,), "slerp": (q1, q_near, t)}[name]
    _close(getattr(tq, name)(*map(torch.as_tensor, args)),
           getattr(jq, name)(*map(jnp.asarray, args)))


def test_quaternion_identity_and_per_row_step():
    """``identity``, and ``integrate_expmap`` with a dt per row."""
    rng = np.random.default_rng(2)
    q, w = _quats(rng, B), rng.standard_normal((B, 3)).astype(np.float32)
    dt = rng.uniform(0.01, 0.1, B).astype(np.float32)
    _close(tq.identity(), jq.identity())
    _close(tq.integrate_expmap(*map(torch.as_tensor, (q, w, dt))),
           jq.integrate_expmap(*map(jnp.asarray, (q, w, dt))))


@pytest.fixture(scope="module", params=["nn", "default"])
def plant(request):
    jp = jax_params(request.param)
    return jp, port_params(jp)


def test_states_include_reversed_flow(plant):
    jp, tp = plant
    x, u = _states()
    u_rel = np.asarray(jac.v_frd_rel(jp, jnp.asarray(x), jnp.asarray(u)))[:, 0]
    assert (u_rel[-B // 4:] < 0).all() and (u_rel[:-B // 4] > 0).all()


def test_aero_state(plant):
    jp, tp = plant
    x, u = _states()
    ja = jac.aero_state(jp, jnp.asarray(x), jnp.asarray(u))
    ta = tac.aero_state(tp, torch.as_tensor(x), torch.as_tensor(u))
    for field in ("qbar", "alpha", "beta", "elevator_alpha",
                  "left_wing_alpha", "right_wing_alpha", "rudder_beta",
                  "left_wing_qbar"):
        _close(getattr(ta, field), getattr(ja, field))
    # reversed flow reads alpha near ±π, as arctan2 does
    assert np.abs(ta.alpha[-B // 4:].numpy()).min() > np.pi / 2


def test_state_derivative(plant):
    jp, tp = plant
    x, u = _states()
    _close(tac.state_derivative(tp, torch.as_tensor(x), torch.as_tensor(u)),
           jac.state_derivative(jp, jnp.asarray(x), jnp.asarray(u)))


@pytest.mark.parametrize("substeps", [1, 2])
def test_rk4_step(plant, substeps):
    jp, tp = plant
    x, u = _states()
    jstep = jint.make_step_fn(jp, substeps=substeps, normalize="step")
    tstep = tint.make_step_fn(tp, substeps=substeps, normalize="step")
    _close(tstep(torch.as_tensor(x), torch.as_tensor(u), 0.01),
           jstep(jnp.asarray(x), jnp.asarray(u), 0.01))


def test_inertia_about_com(plant):
    from aircraft_tpu.dynamics import base as jbase
    from aircraft_tpu_torch.dynamics import base as tbase

    jp, tp = plant
    _close(tbase.inertia_about_com(tp.static_inertia, tp.mass, tp.com),
           jbase.inertia_about_com(jp.static_inertia, jp.mass, jp.com))


def test_mlp_loaded_from_npz_matches_reference():
    """The port reads data/networks/mlp.npz itself: the same network as
    the reference's loader."""
    from aircraft_tpu.dynamics.coefficients import default_nn_coeff, mlp_forward
    from aircraft_tpu_torch.dynamics.coefficients import load_mlp
    from aircraft_tpu_torch.dynamics.coefficients import mlp_forward as t_mlp

    j = default_nn_coeff()
    t = load_mlp(device="cpu")
    assert float(t.Cn_rudder) == pytest.approx(float(j.Cn_rudder))
    x = np.random.default_rng(3).standard_normal((B, 5)).astype(np.float32)
    x[:, 0] = 300.0 + 100.0 * x[:, 0]
    _close(t_mlp(t, torch.as_tensor(x)), mlp_forward(j, jnp.asarray(x)))
