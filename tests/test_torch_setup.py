"""The port's headline set-up against the reference bench's.

The bench's problem hangs on a set-up found by trim searches: the plant's
best-glide speed and L/D (which lay out the track) and the fleet trim
that seeds the controls.  The port runs those searches on the host in
float64 from the reference's own start clouds (``jax.random.PRNGKey(0)``
draws, stored in ``aircraft_tpu_torch/solvers/trim_starts.npz``), so
every device builds the same problem:

* the stored clouds equal a fresh ``jax.random`` draw clipped as the
  reference clips it (``aircraft_tpu/solvers/trim.py:140-145``), exactly;
* ``bench.build_problem("cpu")`` picks v_ref = 32.0 and a glide_ld within
  1% of the reference bench's (``chain_crossing.REFERENCE_GLIDE``);
* the fleet trim is an equilibrium of the reference's dynamics
  (‖[v̇, ω̇]‖ < 1e-3, as ``tests/test_torch_ocp.py`` holds a trim) at
  v_ref + 2 m/s; the trims form a flat valley, so its controls are not
  held to the reference's;
* two calls give the same set-up, bit for bit;
* the host search's float64 cast keeps a plant's integer tensors (the
  polynomial model's factor indices) and evaluates in float64.
"""

import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import jax
import jax.numpy as jnp

from aircraft_tpu.solvers import trim as jtrim

from aircraft_tpu_torch import bench
from aircraft_tpu_torch.solvers import trim as ttrim

from chain_crossing import REFERENCE_GLIDE
from torch_port_problem import jax_params


def _setup():
    """build_problem("cpu") and its fleet trim; the (v_ref, glide_ld) it
    found, caught on its way through plant_best_glide."""
    found = []
    real = bench.plant_best_glide

    def spy(*args, **kw):
        found.append(real(*args, **kw))
        return found[-1]

    bench.plant_best_glide = spy
    try:
        _, params, _, track, v_ref, _ = bench.build_problem("cpu")
    finally:
        bench.plant_best_glide = real
    _, trim = bench.fleet_states(params, track, 1, v_ref)
    return dict(glide=found[0], v_ref=v_ref, track=track.track_points,
                trim=trim)


@pytest.fixture(scope="module")
def setups():
    return _setup(), _setup()


@pytest.mark.parametrize("n_starts", [8, 32])
def test_reference_start_clouds_equal_a_fresh_draw(n_starts):
    lb, ub = jtrim.default_trim_bounds()
    draw = jnp.clip(jnp.asarray(ttrim.START_MID)
                    + jnp.asarray(ttrim.START_SPREAD)
                    * jax.random.normal(jax.random.PRNGKey(0), (n_starts, 12)),
                    lb, ub)
    stored = ttrim.reference_start_cloud(n_starts)
    assert stored.dtype == np.float32
    np.testing.assert_array_equal(stored, np.asarray(draw))


def test_headline_setup_is_the_references(setups):
    s = setups[0]
    assert s["v_ref"] == REFERENCE_GLIDE[0] == 32.0
    assert s["glide"][0] == s["v_ref"]
    assert s["glide"][1] == pytest.approx(REFERENCE_GLIDE[1], rel=1e-2)


def test_fleet_trim_is_an_equilibrium_of_the_reference(setups):
    from aircraft_tpu.dynamics import aircraft as jac

    trim = setups[0]["trim"]
    assert bool(trim.converged)
    assert trim.state.dtype == torch.float32
    xdot = np.asarray(jac.state_derivative(
        jax_params("nn"), jnp.asarray(trim.state.numpy()),
        jnp.asarray(trim.control.numpy())))
    assert np.linalg.norm(np.concatenate([xdot[3:6], xdot[10:13]])) < 1e-3
    speed = float(np.linalg.norm(trim.state[3:6].numpy()))
    assert speed == pytest.approx(setups[0]["v_ref"] + 2.0, abs=1e-2)


def test_two_calls_build_the_same_setup(setups):
    a, b = setups
    assert a["glide"] == b["glide"] and a["v_ref"] == b["v_ref"]
    np.testing.assert_array_equal(a["track"].numpy(), b["track"].numpy())
    for x, y in zip(a["trim"], b["trim"]):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_float64_cast_keeps_integer_tensors():
    from aircraft_tpu_torch.config import glider_config
    from aircraft_tpu_torch.dynamics import aircraft as ac
    from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
    from aircraft_tpu_torch.dynamics.coefficients import (
        default_artifact_coeff)

    p32 = AircraftParams.from_config(
        glider_config().aircraft,
        coeff=default_artifact_coeff("poly", device="cpu"), device="cpu")
    p64 = p32.to(torch.float64)
    assert p64.coeff.factor_index.dtype == p32.coeff.factor_index.dtype
    assert p64.coeff.weights.dtype == p64.mass.dtype == torch.float64
    x = torch.tensor([0.0, 0.0, -200.0, 30.0, 0.0, 2.0, 0.0, 0.0, 0.0, 1.0,
                      0.0, 0.0, 0.0], dtype=torch.float64)
    xdot = ac.state_derivative(p64, x, torch.zeros(10, dtype=torch.float64))
    assert xdot.dtype == torch.float64 and bool(torch.isfinite(xdot).all())
