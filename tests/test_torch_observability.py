"""The port's observability remainders against the reference's.

* ``locate_nan_in_jacobian`` names the same bad entries and rows on the
  reference's own case (``tests/test_extras.py::test_nan_locator``).
* ``check_jacobian`` agrees on ``ok`` for the reference's two cases
  (``tests/test_extras.py::TestFDJacobian``); ``fd_jacobian`` of the
  glider's state derivative within 5e-2 (1 + |ref|) of the reference's
  (both difference float32 evaluations over a step of 1e-4).
* The port's forward-mode ``jacfwd`` of the glider's state derivative
  within 2e-4 (1 + |ref|) of ``jax.jacfwd`` at seeded states and
  controls.
* ``make_logger``, ``timed_jit_call`` and ``profile_trace`` on the CPU.
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import torch

from aircraft_tpu import observability as jobs
from aircraft_tpu.config import glider_config as jglider
from aircraft_tpu.dynamics.aircraft import AircraftParams as JParams
from aircraft_tpu.dynamics.aircraft import state_derivative as jderiv

from aircraft_tpu_torch import observability as tobs
from aircraft_tpu_torch.config import glider_config
from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
from aircraft_tpu_torch.dynamics.aircraft import state_derivative

TOL = 2e-4


def _states(n=4, seed=0):
    """Perturbed copies of the problem's initial state (unit quaternions)."""
    rng = np.random.default_rng(seed)
    x0 = np.asarray(glider_config().waypoints.initial_state, np.float64)
    xs = np.tile(x0, (n, 1))
    xs[:, 3:6] += rng.normal(0.0, 3.0, (n, 3))
    xs[:, 6:10] += rng.normal(0.0, 0.05, (n, 4))
    xs[:, 6:10] /= np.linalg.norm(xs[:, 6:10], axis=1, keepdims=True)
    xs[:, 10:13] = rng.normal(0.0, 0.2, (n, 3))
    us = rng.normal(0.0, 2.0, (n, 7))
    us[:, 3:6] = 0.0
    return xs.astype(np.float32), us.astype(np.float32)


def test_nan_locator_matches_reference():
    ref = jobs.locate_nan_in_jacobian(lambda x, u: x / u, jnp.ones(3),
                                      jnp.array([1.0, 0.0, 2.0]))
    port = tobs.locate_nan_in_jacobian(lambda x, u: x / u, torch.ones(3),
                                       torch.tensor([1.0, 0.0, 2.0]))
    assert port == ref
    assert 1 in port["B_bad_rows"]


def test_check_jacobian_plant_ok_as_reference():
    cfg = jglider()
    jp = JParams.from_config(cfg.aircraft)
    xj = jnp.asarray(cfg.waypoints.initial_state, dtype=jnp.float32)
    # jitted: the reference evaluates it 27 times
    ref = jobs.check_jacobian(jax.jit(lambda xx: jderiv(jp, xx, jnp.zeros(7))),
                              xj)
    params = AircraftParams.from_config(glider_config().aircraft, device="cpu")
    u = torch.zeros(7)
    port = tobs.check_jacobian(lambda xx: state_derivative(params, xx, u),
                               torch.tensor(np.asarray(xj)))
    assert port["ok"] == ref["ok"] is True
    assert port["max_abs_err"] <= 2 * ref["max_abs_err"] + 1e-3


def test_check_jacobian_detects_a_wrong_jacobian_as_reference():
    ref = jobs.check_jacobian(lambda x: jnp.where(x > 0, x, 0.0) ** 0.5 + x,
                              jnp.asarray([1e-9, 2e-9]))
    port = tobs.check_jacobian(
        lambda x: torch.where(x > 0, x, 0.0) ** 0.5 + x,
        np.asarray([1e-9, 2e-9]), device="cpu")
    assert port["ok"] == ref["ok"] is False


def test_fd_jacobian_matches_reference():
    cfg = jglider()
    jp = JParams.from_config(cfg.aircraft)
    params = AircraftParams.from_config(glider_config().aircraft, device="cpu")
    xs, us = _states(1, seed=5)
    ref = jobs.fd_jacobian(lambda xx: jderiv(jp, xx, jnp.asarray(us[0])),
                           jnp.asarray(xs[0]))
    u = torch.as_tensor(us[0])
    port = tobs.fd_jacobian(lambda xx: state_derivative(params, xx, u),
                            xs[0], device="cpu")
    assert port.shape == ref.shape == (13, 13)
    assert np.max(np.abs(port - ref) / (1 + np.abs(ref))) <= 0.05


def test_jacfwd_matches_jax():
    jp = JParams.from_config(jglider().aircraft)
    params = AircraftParams.from_config(glider_config().aircraft, device="cpu")
    xs, us = _states(3, seed=1)
    jac = jax.jit(lambda x, u: (jax.jacfwd(lambda a: jderiv(jp, a, u))(x),
                                jax.jacfwd(lambda b: jderiv(jp, x, b))(u)))
    for x, u in zip(xs, us):
        rA, rB = (np.asarray(a) for a in jac(jnp.asarray(x), jnp.asarray(u)))
        xt, ut = torch.as_tensor(x), torch.as_tensor(u)
        A = tobs.jacfwd(lambda a: state_derivative(params, a, ut), xt).numpy()
        B = tobs.jacfwd(lambda b: state_derivative(params, xt, b), ut).numpy()
        assert A.dtype == np.float32 and A.shape == rA.shape == (13, 13)
        assert np.max(np.abs(A - rA) / (1 + np.abs(rA))) <= TOL
        assert np.max(np.abs(B - rB) / (1 + np.abs(rB))) <= TOL


def test_make_logger_writes_a_timestamped_file(tmp_path):
    log = tobs.make_logger("aircraft_tpu_torch_test_logger", str(tmp_path))
    log.info("window 3 committed")
    for h in log.handlers:
        h.flush()
    files = list(tmp_path.glob("aircraft_tpu_torch_test_logger_*.log"))
    assert len(files) == 1 and "window 3 committed" in files[0].read_text()
    assert tobs.make_logger("aircraft_tpu_torch_test_logger") is log
    quiet = tobs.make_logger("aircraft_tpu_torch_test_quiet")
    assert isinstance(quiet.handlers[0], logging.NullHandler)


def test_timed_call_and_profile_trace(tmp_path):
    calls = []

    def fn(a):
        calls.append(1)
        return {"y": (a * 2.0,)}

    run = tobs.timed_jit_call(fn, torch.ones(4), reps=3)
    assert len(calls) == 4 and run.execute_s >= 0.0
    torch.testing.assert_close(run.result["y"][0], torch.full((4,), 2.0))
    with tobs.profile_trace(tmp_path / "tr") as tr:
        torch.ones(64).cumsum(0)
    assert tr.path.parent == tmp_path / "tr" and tr.path.exists()
    events = json.loads(tr.path.read_text())["traceEvents"]
    assert events and tr.kernel_records() == 0     # no card here
