"""The port's configuration and utility remainders against the reference's.

* ``write_glider_problem_json`` of both packages writes the same bytes,
  equal to ``data/glider/problem_definition.json``; ``GLIDER_PROBLEM``,
  the mode tuples, the scales, ``VISUPATH``'s leaf, ``RHO`` and
  ``GRAVITY`` equal.
* ``TrajectoryConfig.to_dict`` equal between the packages and a round
  trip of a 3D set; ``save_json`` read back by the reference.
* ``TranscriptionConfig`` takes and refuses the same modes.
* ``TrajectoryData`` HDF5 files read across the packages both ways.
* ``state_from_aero`` and the u/v/w conversions within 1e-6 (1 + |ref|)
  on seeded flow conditions; ``State`` / ``Control`` vectors equal.
"""

import json

import numpy as np
import pytest

from aircraft_tpu import config as jcfg
from aircraft_tpu import utils as jutils
from aircraft_tpu.dynamics import base as jbase

from aircraft_tpu_torch import config as tcfg
from aircraft_tpu_torch import utils as tutils
from aircraft_tpu_torch.dynamics import base as tbase

RACING = {
    "waypoints": {
        "waypoints": [[120.0, 10.0, -195.0], [240.0, -10.0, -190.0]],
        "initial_state": [0, 0, -200, 50, 0, 0, 0, 0, 0, 1, 0, 0, 0],
        "default_velocity": 45,
        "waypoint_indices": [0, 1, 2],
        "waypoint_tolerance": 10.0,
    },
    "aircraft": jcfg.GLIDER_PROBLEM["aircraft"],
    "state": {"alpha": [-15, 15], "beta": [-15, 15], "airspeed": [30, 100]},
    "control": {
        "aileron_limit": [-10, 10],
        "elevator_limit": [-10, 10],
        "rudder_limit": [-10, 10],
        "throttle_limit": [[0, 0, 0], [0, 0, 0]],
        "flaps_limit": [0, 1],
        "centre_of_mass_limit": [[-0.5, -0.1, -0.1], [0.5, 0.1, 0.1]],
    },
}


def test_problem_json_is_byte_equal(tmp_path):
    jcfg.write_glider_problem_json(tmp_path / "ref.json")
    port = tcfg.write_glider_problem_json(tmp_path / "port.json")
    shipped = tcfg.GLIDER_PROBLEM_PATH.read_bytes()
    assert port.read_bytes() == (tmp_path / "ref.json").read_bytes() == shipped
    assert tcfg.GLIDER_PROBLEM == jcfg.GLIDER_PROBLEM


def test_problem_json_default_path_is_under_build():
    default = tcfg.write_glider_problem_json.__defaults__[0]
    assert default.is_relative_to(tcfg.BASEPATH / "build" / "aircraft_tpu_torch")


def test_constants_match():
    assert tcfg.TIME_MODES == jcfg.TIME_MODES
    assert tcfg.QUATERNION_MODES == jcfg.QUATERNION_MODES
    assert tcfg.INTEGRATION_MODES == jcfg.INTEGRATION_MODES
    np.testing.assert_array_equal(tcfg.DEFAULT_STATE_SCALE,
                                  jcfg.DEFAULT_STATE_SCALE)
    np.testing.assert_array_equal(tcfg.DEFAULT_CONTROL_SCALE,
                                  jcfg.DEFAULT_CONTROL_SCALE)
    assert tcfg.VISUPATH.name == jcfg.VISUPATH.name
    assert tutils.RHO == jutils.RHO == tcfg.RHO
    np.testing.assert_array_equal(tbase.GRAVITY.numpy(),
                                  np.asarray(jbase.GRAVITY))


@pytest.mark.parametrize("problem", ["glider", "racing"])
def test_to_dict_matches_reference(problem, tmp_path):
    d = jcfg.GLIDER_PROBLEM if problem == "glider" else RACING
    port = tcfg.TrajectoryConfig.from_dict(d)
    ref = jcfg.TrajectoryConfig.from_dict(d)
    assert json.dumps(port.to_dict()) == json.dumps(ref.to_dict())
    if problem == "racing":       # a 3D set round-trips
        assert tcfg.TrajectoryConfig.from_dict(port.to_dict()) == port
    port.save_json(tmp_path / "cfg.json")
    assert jcfg.TrajectoryConfig.from_json(tmp_path / "cfg.json") == \
        jcfg.TrajectoryConfig.from_dict(ref.to_dict())


@pytest.mark.parametrize("kw", [
    {}, {"time": "progress"}, {"time": "adaptive", "quaternion": ""},
    {"quaternion": "baumgarte", "integration": "implicit"},
    {"time": "free"}, {"quaternion": "expmap"}, {"integration": "rk4"}])
def test_transcription_config_modes(kw):
    try:
        jcfg.TranscriptionConfig(**kw)
        ref_ok = True
    except AssertionError:
        ref_ok = False
    if ref_ok:
        port = tcfg.TranscriptionConfig(**kw)
        assert port.__dict__ == jcfg.TranscriptionConfig(**kw).__dict__
    else:
        with pytest.raises(AssertionError):
            tcfg.TranscriptionConfig(**kw)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_h5_files_cross_read(writer, tmp_path):
    rng = np.random.default_rng(3)
    arrays = dict(state=rng.standard_normal((11, 13)).astype(np.float32),
                  control=rng.standard_normal((10, 7)).astype(np.float32),
                  time=np.arange(11, dtype=np.float32) * 0.01)
    W, R = ((tutils.TrajectoryData, jutils.TrajectoryData) if writer == "port"
            else (jutils.TrajectoryData, tutils.TrajectoryData))
    path = tmp_path / "t.h5"
    W(**arrays).save_h5(path)
    second = W(state=arrays["state"] + 1.0)
    second.save_h5(path, iteration=3)
    back = R.load_h5(path, iteration=0)
    for k, v in arrays.items():
        np.testing.assert_array_equal(getattr(back, k), v)
    last = R.load_h5(path)
    np.testing.assert_array_equal(last.state, arrays["state"] + 1.0)
    assert last.control is None and last.time is None


def test_aero_conversions_match():
    rng = np.random.default_rng(0)
    qbar = rng.uniform(50.0, 6000.0, 64)
    alpha = np.deg2rad(rng.uniform(-15.0, 15.0, 64))
    beta = np.deg2rad(rng.uniform(-15.0, 15.0, 64))
    for name in ("u_from_aero", "v_from_aero", "w_from_aero"):
        a = getattr(tutils, name)(qbar, alpha, beta)
        b = getattr(jutils, name)(qbar, alpha, beta)
        assert np.max(np.abs(a - b) / (1 + np.abs(b))) <= 1e-6
    for q, a, b in zip(qbar[:8], alpha[:8], beta[:8]):
        x, ref = tutils.state_from_aero(q, a, b), jutils.state_from_aero(q, a, b)
        assert x.dtype == ref.dtype == np.float32
        assert np.max(np.abs(x - ref) / (1 + np.abs(ref))) <= 1e-6


def test_state_and_control_vectors_match():
    x = np.random.default_rng(1).standard_normal(13)
    s, r = tutils.State.from_vector(x), jutils.State.from_vector(x)
    np.testing.assert_array_equal(s.as_vector(), r.as_vector())
    np.testing.assert_array_equal(tutils.State().as_vector(),
                                  jutils.State().as_vector())
    for kw in ({}, {"aileron": 1.5, "elevator": -2.0, "flaps": 0.3},
               {"rudder": 0.5, "centre_of_mass": np.array([0.1, 0.0, -0.02])}):
        np.testing.assert_array_equal(tutils.Control(**kw).as_vector(),
                                      jutils.Control(**kw).as_vector())


def test_missing_packages_finds_without_importing():
    assert tutils.missing_packages("numpy", "no_such_package_here") == [
        "no_such_package_here"]
