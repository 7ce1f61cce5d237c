"""The port's openloop_sim example against the reference's, tiny, on the
CPU (waypoint_racing and full_course: test_torch_example_racing.py and
test_torch_example_course.py).

* ``openloop_sim.run`` at T=50 from the reference's trim (the reference
  example's 64-start search) within 2e-4 (1 + |ref|) of the reference's
  rollout of the same roll script (5 substeps); ``main`` writes the h5
  file and the dashboard.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aircraft_tpu.config import glider_config as jglider
from aircraft_tpu.dynamics.aircraft import AircraftParams as JParams
from aircraft_tpu.solvers import integrators as jint
from aircraft_tpu.solvers.rollout import rollout as jrollout
from aircraft_tpu.solvers.trim import multistart_trim as jtrim

from aircraft_tpu_torch.examples import openloop_sim
from aircraft_tpu_torch.utils import TrajectoryData

TOL = 2e-4


def _err(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    assert a.shape == ref.shape
    return float(np.max(np.abs(a - ref) / (1.0 + np.abs(ref))))


@pytest.fixture(scope="module")
def openloop():
    jp = JParams.from_config(jglider().aircraft)
    trim = jtrim(jp, jax.random.PRNGKey(0), n_starts=64, target_airspeed=50.0)
    u_trim = np.asarray(trim.control[:7])
    return jp, u_trim, openloop_sim.run(T=50, u_trim=u_trim, device="cpu")


def test_openloop_sim_matches_reference(openloop):
    jp, u_trim, port = openloop
    us = openloop_sim.roll_script(u_trim, 50)
    np.testing.assert_array_equal(port["us"], us)
    step = jint.make_step_fn(jp, substeps=openloop_sim.SUBSTEPS,
                             normalize="step")
    x0 = jnp.asarray(jglider().waypoints.initial_state, jnp.float32)
    ref = np.asarray(jrollout(jax.jit(step), x0, jnp.asarray(us),
                              openloop_sim.DT))
    assert port["first_nan"] is None
    assert _err(port["xs"], ref) <= TOL
    assert port["elevator_column"].shape == (13,)
    assert np.isfinite(port["elevator_column"]).all()


def test_openloop_sim_main_writes_its_files(openloop, tmp_path, capsys,
                                            monkeypatch):
    res = dict(openloop[2], trim_residual=0.0)
    monkeypatch.setattr(openloop_sim, "run", lambda **kw: res)
    assert openloop_sim.main(["--device", "cpu", "--steps", "50",
                              "--out", str(tmp_path)]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["finite"] and len(rec["written"]) == 2
    back = TrajectoryData.load_h5(tmp_path / "openloop.h5")
    np.testing.assert_array_equal(back.state, res["xs"])
    assert (tmp_path / "openloop.png").exists()
