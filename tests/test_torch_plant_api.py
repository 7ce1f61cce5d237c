"""The port's plant API against the JAX package: the public aero
coefficients, body forces and body moments, the state accessors, and the
per-plant dispatch of ``state_derivative`` and ``control_dim`` that the
integrators go through, on numpy-seeded flight states (some flying
backwards through the air) under the trained MLP and the default aero.

Tolerance: rtol = atol = 1e-5 elementwise (pure functions); the public
functions and the window path's ``forces_moments`` must agree exactly.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax.numpy as jnp

from aircraft_tpu.dynamics import aircraft as jac
from aircraft_tpu.dynamics import base as jbase
from aircraft_tpu.solvers import integrators as jint

from aircraft_tpu_torch.config import glider_config
from aircraft_tpu_torch.dynamics import aircraft as tac
from aircraft_tpu_torch.dynamics import base as tbase
from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
from aircraft_tpu_torch.dynamics.quadrotor import QuadrotorParams
from aircraft_tpu_torch.solvers import integrators as tint

from test_torch_dynamics import _states
from torch_port_problem import jax_params, port_params

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", params=["nn", "default"])
def plant(request):
    jp = jax_params(request.param)
    return jp, port_params(jp)


@pytest.mark.parametrize("name", ["coefficients", "forces_frd",
                                  "moments_frd"])
def test_public_aero_function(plant, name):
    jp, tp = plant
    x, u = _states(3)
    wind = np.array([3.0, -2.0, 0.5], np.float32)
    for w in (None, wind):
        ref = getattr(jac, name)(jp, jnp.asarray(x), jnp.asarray(u),
                                 None if w is None else jnp.asarray(w))
        out = getattr(tac, name)(tp, torch.as_tensor(x), torch.as_tensor(u),
                                 None if w is None else torch.as_tensor(w))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_public_functions_are_the_window_path(plant):
    """forces_frd / moments_frd are ``forces_moments``' halves, bit for
    bit: the window path's numbers do not move."""
    _, tp = plant
    x, u = (torch.as_tensor(a) for a in _states(4))
    f, m = tac.forces_moments(tp, x, u)
    assert torch.equal(tac.forces_frd(tp, x, u), f)
    assert torch.equal(tac.moments_frd(tp, x, u), m)


def test_state_accessors():
    x = np.random.default_rng(5).standard_normal((6, 13)).astype(np.float32)
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    for name in ("position", "velocity", "orientation", "angular_velocity"):
        np.testing.assert_array_equal(getattr(tbase, name)(xt).numpy(),
                                      np.asarray(getattr(jbase, name)(xj)))
    parts = [tbase.position(xt), tbase.velocity(xt), tbase.orientation(xt),
             tbase.angular_velocity(xt)]
    ref = jbase.pack_state(*(jnp.asarray(p.numpy()) for p in parts))
    np.testing.assert_array_equal(tbase.pack_state(*parts).numpy(),
                                  np.asarray(ref))
    assert tbase.STATE_DIM == jbase.STATE_DIM == 13


def test_dispatch_per_plant(plant):
    jp, tp = plant
    x, u = (torch.as_tensor(a) for a in _states(6))
    assert torch.equal(tbase.state_derivative(tp, x, u),
                       tac.state_derivative(tp, x, u))
    np.testing.assert_allclose(
        tbase.state_derivative(tp, x, u).numpy(),
        np.asarray(jbase.state_derivative(jp, jnp.asarray(x.numpy()),
                                          jnp.asarray(u.numpy()))),
        rtol=2e-4, atol=2e-4)
    assert tbase.control_dim(tp) == jbase.control_dim(jp) == 7
    cfg = glider_config()
    trim_p = AircraftParams.from_config(cfg.aircraft, device="cpu",
                                        com_in_control=True)
    assert tbase.control_dim(trim_p) == 10
    assert tbase.control_dim(QuadrotorParams.default("cpu")) == 4
    with pytest.raises(TypeError):
        tbase.state_derivative(object(), x, u)
    with pytest.raises(TypeError):
        tbase.control_dim(object())


def test_integrator_goes_through_the_dispatch(plant):
    """``integrators.step`` without a derivative_fn takes the registered
    plant; its step matches the reference's (2e-4, a single step)."""
    jp, tp = plant
    x, u = _states(7)
    ref = jint.step(jp, jnp.asarray(x), jnp.asarray(u), 0.01, substeps=2)
    out = tint.step(tp, torch.as_tensor(x), torch.as_tensor(u), 0.01,
                    substeps=2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


class _Decay:
    """A plant type registered only here: ẋ = -x."""


tbase.state_derivative.register(_Decay, lambda p, x, u: -x)


def test_integrator_takes_any_registered_plant():
    """A new plant type registered with ``state_derivative`` is what
    ``integrators.step`` integrates when no derivative_fn is given."""
    x = torch.ones(3, 13)
    out = tint.step(_Decay(), x, torch.zeros(3, 4), 0.1)
    ref = tint.step(None, x, torch.zeros(3, 4), 0.1,
                    derivative_fn=lambda xx, uu: -xx)
    assert torch.equal(out, ref)
    np.testing.assert_allclose(out.numpy(), np.exp(-0.1), rtol=1e-6)
