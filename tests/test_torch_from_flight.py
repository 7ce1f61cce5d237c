"""The port's flight-data system identification against the JAX package's
on the flight tests/test_from_flight.py simulates: 3 s of excited flight
of the default-aero glider at dt = 0.002 (multi-sine surface excitation
on top of body-rate damping), recorded by the reference's plant.

Tolerances: the extracted samples 1e-5 (1 + |ref|) (one float32 inversion
of the same recorded states; the envelope mask identical); the linear and
polynomial fits on them 1e-4 (1 + |ref|) in parameters and R², the MLP
fit (two epochs from the same JAX-drawn initial weights) 1e-3.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from aircraft_tpu.dynamics.coefficients import MLPCoeffParams as JaxMLP
from aircraft_tpu.surrogates import from_flight as jf

from aircraft_tpu_torch.dynamics.coefficients import MLP_KEYS, mlp_from_numpy
from aircraft_tpu_torch.surrogates import from_flight as tf

from test_from_flight import DT, flight, params  # noqa: F401  (fixtures)
from torch_port_problem import port_params


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= tol * (1 + np.abs(want))), np.max(
        np.abs(got - want))


@pytest.fixture(scope="module")
def both(params, flight):  # noqa: F811
    return params, port_params(params), flight


def test_extract_coefficients_matches(both):
    jp, tp, (xs, us) = both
    want = jf.extract_coefficients(jp, xs, us, DT)
    got = tf.extract_coefficients(tp, xs, us, DT)
    assert got.inputs.shape[0] > 1000
    for name in ("inputs", "coefficients", "qbar"):
        assert getattr(got, name).dtype == np.float32
        _close(getattr(got, name), getattr(want, name), 1e-5)


def test_extract_with_controls_one_shorter(both):
    jp, tp, (xs, us) = both
    want = jf.extract_coefficients(jp, xs[:300], us[:299], DT)
    got = tf.extract_coefficients(tp, xs[:300], us[:299], DT)
    _close(got.coefficients, want.coefficients, 1e-5)


@pytest.mark.parametrize("model,kw", [("linear", {}), ("poly", {"degree": 3})])
def test_identify_classical_fits_match(both, model, kw):
    jp, tp, (xs, us) = both
    cut = 2 * xs.shape[0] // 3
    want = jf.identify(jp, xs[:cut], us[:cut], DT, model=model, **kw)
    got = tf.identify(tp, xs[:cut], us[:cut], DT, model=model, **kw)
    _close(got.r2, want.r2, 1e-4)
    if model == "linear":
        _close(got.params.matrix.numpy(), want.params.matrix, 1e-4)
    else:
        _close(got.params.weights.numpy(), want.params.weights, 1e-4)
        _close(got.params.intercept.numpy(), want.params.intercept, 1e-4)
    assert got.r2[1] > 0.95 and got.r2[2] > 0.95


def test_identify_nn_matches(both):
    jp, tp, (xs, us) = both
    key = jax.random.PRNGKey(7)
    init = JaxMLP.init(key)
    want = jf.identify(jp, xs, us, DT, model="nn", key=key, epochs=2)
    got = tf.identify(tp, xs, us, DT, model="nn", epochs=2,
                      init=mlp_from_numpy({k: np.asarray(getattr(init, k))
                                           for k in MLP_KEYS}, device="cpu"))
    _close(got.r2, want.r2, 1e-3)
    for k in MLP_KEYS:
        _close(getattr(got.params, k).numpy(), getattr(want.params, k), 1e-3)


def test_identified_linear_model_plugs_into_the_plant(both):
    """The fitted params drop straight into the port's plant."""
    from dataclasses import replace

    from aircraft_tpu_torch.solvers import integrators

    _, tp, (xs, us) = both
    report = tf.identify(tp, xs, us, DT, model="linear")
    ident = replace(tp, coeff=report.params)
    x = torch.tensor(xs[0])
    for k in range(20):
        x = integrators.step(ident, x, torch.tensor(us[k]), DT,
                             normalize="step")
    assert np.linalg.norm(x[:3].numpy() - xs[20, :3]) < 0.2
