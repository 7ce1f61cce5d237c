"""The port's aerodynamic frames and rotating-Earth accelerations against
the JAX package on numpy-seeded vectors and angles, and the Earth-rotation
wrapper of the aircraft plant's derivative.

Tolerance: rtol = atol = 1e-5 elementwise (pure functions).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax.numpy as jnp

from aircraft_tpu.dynamics import aircraft as jac
from aircraft_tpu.dynamics import frames as jf

from aircraft_tpu_torch.dynamics import aircraft as tac
from aircraft_tpu_torch.dynamics import frames as tf

from test_torch_dynamics import _states
from torch_port_problem import jax_params, port_params

TOL = dict(rtol=1e-5, atol=1e-5)
RNG = np.random.default_rng(11)
V = RNG.normal(0, 10, (32, 3)).astype(np.float32)
ALPHA = RNG.uniform(-1, 1, 32).astype(np.float32)
BETA = RNG.uniform(-1, 1, 32).astype(np.float32)
P = RNG.uniform(-500, 500, (32, 3)).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("name", ["body_to_stability", "stability_to_body",
                                  "body_to_wind", "wind_to_body"])
def test_frame_rotation(name):
    args = (V, ALPHA) if "stability" in name else (V, ALPHA, BETA)
    _close(getattr(tf, name)(*(torch.as_tensor(a) for a in args)),
           getattr(jf, name)(*(jnp.asarray(a) for a in args)))


def test_body_to_rdf_and_wind_axis():
    _close(tf.body_to_rdf(torch.as_tensor(V), torch.as_tensor(P)),
           jf.body_to_rdf(jnp.asarray(V), jnp.asarray(P)))
    v = torch.as_tensor(V) + torch.tensor([40.0, 0.0, 0.0])
    alpha = torch.atan2(v[:, 2], v[:, 0])
    beta = torch.asin(v[:, 1] / torch.linalg.norm(v, dim=-1))
    w = tf.body_to_wind(v, alpha, beta)
    np.testing.assert_allclose(w[:, 0].numpy(),
                               torch.linalg.norm(v, dim=-1).numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(w[:, 1:].numpy(), 0.0, atol=1e-4)


@pytest.mark.parametrize("lat", [0.0, 47.4, -90.0])
def test_earth_rotation_terms(lat):
    je = jf.EarthRotationParams.at_latitude(lat)
    te = tf.EarthRotationParams.at_latitude(lat, device="cpu")
    _close(te.rate_ned, je.rate_ned)
    _close(tf.coriolis_acceleration(te, torch.as_tensor(V)),
           jf.coriolis_acceleration(je, jnp.asarray(V)))
    _close(tf.centrifugal_acceleration(te, torch.as_tensor(P)),
           jf.centrifugal_acceleration(je, jnp.asarray(P)))
    _close(tf.fictitious_acceleration(te, torch.as_tensor(P),
                                      torch.as_tensor(V)),
           jf.fictitious_acceleration(je, jnp.asarray(P), jnp.asarray(V)))


@pytest.mark.parametrize("centrifugal", [False, True])
def test_with_earth_rotation(centrifugal):
    jp = jax_params("nn")
    tp = port_params(jp)
    je = jf.EarthRotationParams.at_latitude(52.0)
    te = tf.EarthRotationParams.at_latitude(52.0, device="cpu")
    x, u = _states(12)
    ref = jf.with_earth_rotation(jac.state_derivative, je, centrifugal)(
        jp, jnp.asarray(x), jnp.asarray(u))
    out = tf.with_earth_rotation(tac.state_derivative, te, centrifugal)(
        tp, torch.as_tensor(x), torch.as_tensor(u))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)
    # the wrapper adds exactly the rotating-frame term to the velocity rows
    plain = tac.state_derivative(tp, torch.as_tensor(x), torch.as_tensor(u))
    a = (tf.fictitious_acceleration(te, torch.as_tensor(x[:, :3]),
                                    torch.as_tensor(x[:, 3:6]))
         if centrifugal else
         tf.coriolis_acceleration(te, torch.as_tensor(x[:, 3:6])))
    _close(out[:, 3:6] - plain[:, 3:6], a.numpy())
    assert torch.equal(out[:, :3], plain[:, :3])
    assert torch.equal(out[:, 6:], plain[:, 6:])
