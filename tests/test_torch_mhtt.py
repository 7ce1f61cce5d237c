"""The receding-horizon controller of the port (``control/mhtt.py::MHTT``)
and the course flight around it (``control/course.py``), on the CPU.

On the reference controller tests' short course and small window (N=25,
dt=0.02, overlap 15, 2 substeps), with the reference path on both sides
(``fused=False``) and the plant carried across through numpy:

* one ``_serve_step`` from the same numpy-drawn state and controls at a
  1 AL round x 2 inner iteration budget gives the reference's blob: the
  same length and tail layout, every entry within 1e-3 (1 + |ref|);
* ``waypoint_misses`` of the same states is exact.

Then the port's own contracts, as the reference's tests state them
(``tests/test_control.py``), at the 1 x 2 budget except where noted:
pipelined and synchronous ``run`` commit the same bits, the retry path
included; ``run_batch_scan`` advances progress as ``run_batch`` does; the
dual carry cuts the steady-state violation; a 3-candidate ``run`` flies;
``fused=True`` runs the kernels' plain versions; the window post-mortem
reports; and ``solve_full_course`` returns the reference's keys.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp

from aircraft_tpu.config import SolverConfig as JaxSolverConfig
from aircraft_tpu.config import glider_config as jax_glider_config
from aircraft_tpu.control.course import waypoint_misses as jax_waypoint_misses
from aircraft_tpu.control.mhtt import MHTT as JaxMHTT

from aircraft_tpu_torch.config import SolverConfig, glider_config
from aircraft_tpu_torch.control import course
from aircraft_tpu_torch.control.mhtt import MHTT, finish_pull
from aircraft_tpu_torch.kernels import window as win

from torch_port_problem import short_course_pair

WINDOW = dict(num_nodes=25, dt=0.02, overlap=15, substeps=2)
BUDGET = dict(max_al_iters=1, max_inner_iters=2, hessian="gauss_newton")
N, COMMIT = 25, 10


@pytest.fixture(scope="module")
def pair():
    return short_course_pair()


@pytest.fixture(scope="module")
def port(pair):
    _, pt = pair
    m = MHTT(pt["params"], pt["config"], pt["track"], **WINDOW,
             solver_config=SolverConfig(**BUDGET), fused=False, device="cpu")
    x0 = np.asarray(pt["config"].waypoints.initial_state, np.float32)
    return m, x0


def _draw(seed=0):
    """A state near the course start (s = 0.05) and small controls."""
    rng = np.random.default_rng(seed)
    x0 = np.asarray([0, 0, -200, 50, 0, 0, 0, 0, 0, 1, 0, 0, 0], np.float32)
    z0 = np.concatenate([x0 + 0.01 * rng.standard_normal(13), [0.05]])
    us = 0.05 * rng.standard_normal((N, 7))
    return z0.astype(np.float32), us.astype(np.float32)


def test_serve_step_matches_the_reference(pair, port):
    jx, _ = pair
    m, _ = port
    ref_m = JaxMHTT(jx["params"], jx["config"], jx["track"], **WINDOW,
                    solver_config=JaxSolverConfig(**BUDGET), fused=False)
    z0, us = _draw()
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(ref_m._serve_step(jnp.asarray(z0), jnp.asarray(us),
                                           ref_m._al0)[3])
    got = finish_pull(m._serve_step(torch.as_tensor(z0), torch.as_tensor(us),
                                    m._al0)[3])
    assert got.shape == ref.shape == (COMMIT * 21 + 4,)
    # tail [cost, violation, finite, s_next]; s_next is the last committed
    # knot's progress
    for blob in (got, ref):
        assert blob[-2] == 1.0
        assert blob[-1] == blob[COMMIT * 14 - 1]
    err = np.abs(got - ref) / (1.0 + np.abs(ref))
    assert err.max() <= 1e-3, (int(err.argmax()), got[err.argmax()],
                               ref[err.argmax()])


def test_waypoint_misses_match_the_reference():
    rng = np.random.default_rng(4)
    cfg = glider_config()
    wps = np.asarray(cfg.waypoints.array())
    # a flown-looking path: past every waypoint in order, with noise
    path = np.concatenate([np.linspace(a, b, 40) for a, b in
                           zip(wps[:-1], wps[1:])])
    states = np.zeros((len(path), 13))
    states[:, :3] = path + 3.0 * rng.standard_normal(path.shape)
    assert course.waypoint_misses(states, cfg) == jax_waypoint_misses(
        states, jax_glider_config())


@pytest.mark.parametrize("branch", ["carry", "retry"])
def test_pipelined_run_matches_synchronous(port, branch):
    """Pipelining only overlaps the blob's pull with the next solve: the
    commits are bit-equal.  The retry case forces the retry comparison on
    every window (abort_violation 0, the dual carry off so the clean reset
    can win): a taken retry discards the speculative dispatch."""
    m, x0 = port
    kw = dict(max_windows=2, progress_target=2.0)
    if branch == "retry":
        kw.update(us_init=np.tile(np.asarray([0.0, 0.5, 0, 0, 0, 0, 0],
                                             np.float32), (N, 1)),
                  abort_violation=0.0, abort_patience=100)
    m.dual_carry = branch == "carry"
    try:
        a = m.run(x0, pipeline=True, **kw)
        b = m.run(x0, pipeline=False, **kw)
    finally:
        m.dual_carry = True
    assert a["windows"] == b["windows"] == 2
    assert a["retries"] == b["retries"]
    if branch == "retry":
        assert a["retries"] > 0
    np.testing.assert_array_equal(a["states"], b["states"])
    np.testing.assert_array_equal(a["controls"], b["controls"])
    assert a["progress"] == b["progress"]
    assert np.all(np.isfinite(a["states"]))


def test_scan_chain_matches_host_loop(port):
    m, x0 = port
    x0s = np.tile(x0[None], (3, 1))
    scan_out = m.run_batch_scan(x0s, 2)
    loop_out = m.run_batch(x0s, max_windows=2, progress_target=2.0)
    assert scan_out["windows"] == loop_out["windows"] == 2
    assert np.all(np.isfinite(scan_out["final_states"]))
    assert np.all(scan_out["progress"] > 0.0)
    np.testing.assert_allclose(scan_out["progress"], loop_out["progress"],
                               atol=1e-4)
    np.testing.assert_allclose(scan_out["progress_history"],
                               loop_out["progress_history"][1:], atol=1e-4)


def test_dual_carry_cuts_steady_state_violation(pair):
    """Shifted multipliers lower the window chain's steady-state violation
    against cold duals at the same budget.  At 1 x 2 over 5 windows the
    port measured 0.81x (windows 2-4: 0.376 -> 0.305)."""
    _, pt = pair
    z0 = torch.as_tensor(np.concatenate(
        [pt["config"].waypoints.initial_state, [0.0]]).astype(np.float32))
    viols = {}
    for dual in (False, True):
        m = MHTT(pt["params"], pt["config"], pt["track"], **WINDOW,
                 solver_config=SolverConfig(**BUDGET), dual_carry=dual,
                 fused=False, device="cpu")
        z, us, al = z0, torch.zeros(N, 7), m._al0
        vs = []
        for _ in range(5):
            z, us, al, pull = m._serve_step(z, us, al)
            vs.append(float(finish_pull(pull)[-3]))
        viols[dual] = np.asarray(vs)
    ss_off, ss_on = viols[False][2:].mean(), viols[True][2:].mean()
    assert ss_on < 0.9 * ss_off, (ss_off, ss_on)
    assert np.all(np.isfinite(viols[True]))


@pytest.mark.slow
def test_dual_carry_meets_the_reference_contract(pair):
    """The reference's own dual-carry contract
    (tests/test_control.py::TestDualWarmStart): at 2 AL rounds x 10 inner
    iterations with the exact Hessian (the SolverConfig default), over 12
    windows, the carried duals' steady-state violation (windows 4-11)
    below 0.75x the cold duals'.  Minutes on a CPU, hence slow."""
    _, pt = pair
    z0 = torch.as_tensor(np.concatenate(
        [pt["config"].waypoints.initial_state, [0.0]]).astype(np.float32))
    viols = {}
    for dual in (False, True):
        m = MHTT(pt["params"], pt["config"], pt["track"], **WINDOW,
                 solver_config=SolverConfig(max_al_iters=2,
                                            max_inner_iters=10),
                 dual_carry=dual, fused=False, device="cpu")
        z, us, al = z0, torch.zeros(N, 7), m._al0
        vs = []
        for _ in range(12):
            z, us, al, pull = m._serve_step(z, us, al)
            vs.append(float(finish_pull(pull)[-3]))
        viols[dual] = np.asarray(vs)
    ss_off, ss_on = viols[False][4:].mean(), viols[True][4:].mean()
    print(f"dual carry: cold {viols[False].tolist()}, carried "
          f"{viols[True].tolist()}; steady state {ss_off} -> {ss_on} "
          f"({ss_on / ss_off:.3f}x)")
    assert ss_on < 0.75 * ss_off, (ss_off, ss_on)
    assert np.all(np.isfinite(viols[True]))


def test_multi_candidate_run(port):
    m, x0 = port
    out = m.run(x0, max_windows=2, progress_target=0.95,
                us_init=np.zeros((N, 7), np.float32), n_candidates=3)
    assert out["windows"] == 2
    assert np.all(np.isfinite(out["states"]))
    assert out["progress"] > 0.0
    assert out["abort_reason"] is None
    assert out["retries"] == 0


def test_fused_run_on_the_cpu(pair):
    """fused=True on the CPU runs the window kernels' plain versions."""
    _, pt = pair
    m = MHTT(pt["params"], pt["config"], pt["track"], **WINDOW,
             solver_config=SolverConfig(**BUDGET), fused=True, device="cpu")
    win.reset_launch_counts()
    x0 = np.asarray(pt["config"].waypoints.initial_state, np.float32)
    out = m.run(x0, max_windows=1, progress_target=2.0, pipeline=False)
    assert out["windows"] == 1
    assert out["states"].shape == (1 + COMMIT, 13)
    assert np.all(np.isfinite(out["states"]))
    assert np.all(np.isfinite(out["controls"]))
    assert win.window_backward.launches == win.window_forward.launches == 0


def test_diagnose_window_reports(port):
    m, x0 = port
    rep = m.diagnose_window(np.concatenate([x0, [0.0]]),
                            np.zeros((N, 7), np.float32))
    assert rep["worst_defect"] == 0.0
    assert rep["nonfinite_states"] == 0
    assert "max" in rep["quu_cond"], rep["quu_cond"]
    assert rep["active_constraints"] and rep["active_constraints"][0]["name"]
    assert rep["envelope_traces"]["airspeed_min"] > 0.0
    assert rep["text"].startswith("solve: cost=")


# the reference's solve_full_course keys (control/course.py:269-298)
COURSE_KEYS = {
    "states", "controls", "progress", "windows", "abort_reason", "retries",
    "track", "trim", "misses", "success", "mpc_healthy", "tolerance",
    "speed_range", "final_altitude", "first_window_wall_s",
    "p50_window_wall_s", "p90_window_wall_s", "window_walls_s"}


def test_full_course_returns_the_reference_keys():
    """Two windows of the course at a 1 x 1 budget, trimmed from a start
    cloud drawn as the reference draws it (``jax.random``)."""
    from aircraft_tpu.solvers import trim as jtrim

    from aircraft_tpu_torch.solvers import trim as ttrim

    lb, ub = jtrim.default_trim_bounds()
    cloud = jnp.clip(jnp.asarray(ttrim.START_MID) + jnp.asarray(
        ttrim.START_SPREAD) * jax.random.normal(jax.random.PRNGKey(0), (8, 12)),
        lb, ub)
    out = course.solve_full_course(
        glider_config(), max_windows=2, device="cpu",
        trim_cloud=torch.as_tensor(np.array(cloud)),
        solver_config=SolverConfig(max_al_iters=1, max_inner_iters=1,
                                   hessian="gauss_newton"))
    assert set(out) == COURSE_KEYS
    assert out["windows"] == 2
    assert len(out["misses"]) == len(glider_config().waypoints.waypoints)
    assert np.all(np.isfinite(out["states"]))
    assert len(out["window_walls_s"]) == 2
