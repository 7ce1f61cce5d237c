"""The port's whole-trajectory problem against the JAX package on the same
numpy inputs:

* ``goal_cost``'s two losses, and ``build_aircraft_ocp`` in each ported
  quaternion mode (with a wind, an extra inequality and terminal rows):
  the RK4 step at rtol = atol = 2e-4, the other rows at 1e-5 relative;
* ``ocp.rollout_defect`` (2e-4, a float32 RK4 step per knot);
* ``waypoints.receding_warm_start`` (N=12, window 6, overlap 3, 1 x 1
  Gauss-Newton) through its first window: the reference's ``MHTT`` window
  solve from the same start, its committed controls at 2e-4;
* the exponential map and implicit Euler through ``build_aircraft_ocp``
  (they raised before the plant breadth was ported): the step at 2e-4;
* the port alone: ``ilqr.solve`` is ``solve_impl`` on a batch of one,
  ``python -m aircraft_tpu_torch.bench
  --mode whole`` prints the reference's keys on the CPU at a tiny size,
  and the new entry points raise without a card when not asked for the
  CPU.

Every reference function is vmapped over the batch, eagerly or in a small
jit.  Inputs come from numpy with a seed.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp

from aircraft_tpu.config import glider_config as jax_glider_config
from aircraft_tpu.control import aircraft as jac
from aircraft_tpu.solvers import ocp as jocp

from aircraft_tpu_torch.config import SolverConfig, glider_config
from aircraft_tpu_torch.control import aircraft as tac
from aircraft_tpu_torch.solvers import ilqr
from aircraft_tpu_torch.solvers import ocp as tocp

from torch_port_problem import jax_params, port_params, short_course_pair

STEP_TOL = dict(rtol=2e-4, atol=2e-4)
ROW_TOL = dict(rtol=1e-5, atol=1e-5)
B, N, DT = 6, 5, 0.01
GOAL = np.array([146.0, 8.0, -195.0], np.float32)
WIND = np.array([2.0, -1.0, 0.5], np.float32)


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


def _inputs(seed=0):
    """Glider states near the course start at 30-50 m/s, small attitude
    and rate perturbations, and controls inside the surfaces' range."""
    rng = np.random.default_rng(seed)
    x0 = np.asarray(jax_glider_config().waypoints.initial_state, np.float32)
    x = np.tile(x0[None], (B, 1)) + 0.02 * rng.standard_normal((B, 13))
    x[:, 3:6] *= rng.uniform(30, 50, (B, 1)) / np.linalg.norm(
        x[:, 3:6], axis=1, keepdims=True)
    x[:, 6:10] /= np.linalg.norm(x[:, 6:10], axis=1, keepdims=True) * (
        1.0 + 0.01 * rng.standard_normal((B, 1)))     # |q| off 1 a little
    u = np.zeros((B, 7))
    u[:, :3] = rng.uniform(-3, 3, (B, 3))
    u[:, 6] = rng.uniform(0, 1, B)
    return x.astype(np.float32), u.astype(np.float32)


@pytest.fixture(scope="module")
def plant():
    jp = jax_params("default")
    return jp, port_params(jp)


def test_goal_cost():
    xs, us = _inputs(1)
    js, jt = jac.goal_cost(jnp.asarray(GOAL), w_goal=1e-2, w_control=0.3)
    ts, tt = tac.goal_cost(GOAL, w_goal=1e-2, w_control=0.3, device="cpu")
    k = jnp.zeros(B, jnp.int32)
    _close(ts(torch.as_tensor(xs), torch.as_tensor(us), torch.zeros(B)),
           jax.vmap(js)(xs, us, k), ROW_TOL)
    _close(tt(torch.as_tensor(xs)), jax.vmap(jt)(xs), ROW_TOL)


def _extra_ineq(lib):
    def extra(x, u, k):
        return lib.stack([x[..., 2] + 150.0, u[..., 0] - 4.0], axis=-1)
    return extra


@pytest.mark.parametrize("quaternion,wind", [
    ("integration", False), ("constraint", True), ("baumgarte", True),
    ("", False)])
def test_build_aircraft_ocp(plant, quaternion, wind):
    jp, pp = plant
    js, jt = jac.goal_cost(jnp.asarray(GOAL))
    ts, tt = tac.goal_cost(GOAL, device="cpu")
    j_term = lambda x: jnp.stack([x[0] - 200.0])
    t_term = lambda x: x[..., :1] - 200.0
    jo = jac.build_aircraft_ocp(
        jp, jax_glider_config(), dt=DT, stage_cost=js, terminal_cost=jt,
        substeps=2, quaternion=quaternion,
        wind=jnp.asarray(WIND) if wind else None,
        extra_ineq=lambda x, u, k: jnp.stack([x[2] + 150.0, u[0] - 4.0]),
        terminal_ineq=j_term, terminal_eq=j_term)
    to = tac.build_aircraft_ocp(
        pp, glider_config(), dt=DT, stage_cost=ts, terminal_cost=tt,
        substeps=2, quaternion=quaternion,
        wind=torch.as_tensor(WIND) if wind else None,
        extra_ineq=lambda x, u, k: torch.stack([x[..., 2] + 150.0,
                                                u[..., 0] - 4.0], dim=-1),
        terminal_ineq=t_term, terminal_eq=t_term)
    xs, us = _inputs(2)
    x, u = torch.as_tensor(xs), torch.as_tensor(us)
    k, jk = torch.zeros(B, dtype=torch.int64), jnp.zeros(B, jnp.int32)
    _close(to.step(x, u, k), jax.vmap(jo.step)(xs, us, jk), STEP_TOL)
    for name in ("stage_cost", "ineq", "eq"):
        _close(getattr(to, name)(x, u, k),
               jax.vmap(getattr(jo, name))(xs, us, jk), ROW_TOL)
    for name in ("terminal_cost", "terminal_ineq", "terminal_eq"):
        _close(getattr(to, name)(x), jax.vmap(getattr(jo, name))(xs),
               ROW_TOL)


@pytest.mark.parametrize("kw", [dict(quaternion="expmap"),
                                dict(integration="implicit")])
def test_unported_integrator_options_raise(plant, kw):
    """The two options that raised NotImplementedError before the plant
    breadth was ported: each now builds the reference's OCP, its step
    held at 2e-4."""
    jp, pp = plant
    js, jt = jac.goal_cost(jnp.asarray(GOAL))
    ts, tt = tac.goal_cost(GOAL, device="cpu")
    jo = jac.build_aircraft_ocp(jp, jax_glider_config(), dt=DT,
                                stage_cost=js, terminal_cost=jt, **kw)
    to = tac.build_aircraft_ocp(pp, glider_config(), dt=DT, stage_cost=ts,
                                terminal_cost=tt, **kw)
    xs, us = _inputs(4)
    k = torch.zeros(B, dtype=torch.int64)
    _close(to.step(torch.as_tensor(xs), torch.as_tensor(us), k),
           jax.jit(jax.vmap(jo.step))(xs, us, jnp.zeros(B, jnp.int32)),
           STEP_TOL)


def test_rollout_defect(plant):
    jp, pp = plant
    js, jt = jac.goal_cost(jnp.asarray(GOAL))
    ts, tt = tac.goal_cost(GOAL, device="cpu")
    jo = jac.build_aircraft_ocp(jp, jax_glider_config(), dt=DT,
                                stage_cost=js, terminal_cost=jt)
    to = tac.build_aircraft_ocp(pp, glider_config(), dt=DT, stage_cost=ts,
                                terminal_cost=tt)
    rng = np.random.default_rng(3)
    x0, _ = _inputs(3)
    us = (0.5 * rng.standard_normal((B, N, 7))).astype(np.float32)
    # a rollout with a kick at one knot of each trajectory
    xs = [torch.as_tensor(x0)]
    for k in range(N):
        xs.append(to.step(xs[-1], torch.as_tensor(us[:, k]), k))
    xs = torch.stack(xs, dim=1).numpy()
    xs[np.arange(B), rng.integers(1, N + 1, B), 0] += rng.uniform(0, 3, B)
    ref = jax.vmap(lambda x, u: jocp.rollout_defect(jo, x, u))(xs, us)
    _close(tocp.rollout_defect(to, torch.as_tensor(xs), torch.as_tensor(us)),
           ref, STEP_TOL)


def test_solve_is_solve_impl_on_a_batch_of_one(plant):
    _, pp = plant
    ts, tt = tac.goal_cost(GOAL, w_goal=1e-2, device="cpu")
    to = tac.build_aircraft_ocp(pp, glider_config(), dt=DT, stage_cost=ts,
                                terminal_cost=tt, quaternion="constraint")
    x0, u0 = _inputs(4)
    x0, us = torch.as_tensor(x0[0]), torch.as_tensor(u0[:1]).repeat(N, 1)
    cfg = SolverConfig(max_al_iters=1, max_inner_iters=2)
    one = ilqr.solve(to, x0, us, cfg)
    batch = ilqr.solve_impl(to, x0[None], us[None], cfg)
    assert one.xs.shape == (N + 1, 13) and one.cost.ndim == 0
    assert one.al.mu.ndim == 0 and one.al.lam_eq.shape == (N, 1)
    for a, b in zip(one[:-1], batch[:-1]):
        assert torch.equal(a, b[0])


def test_receding_warm_start_first_window():
    """The port's warm start (pipelined ``MHTT.run``) commits, in its first
    window, the reference ``MHTT``'s solve of that window from the same
    start, zero controls and cold duals."""
    from aircraft_tpu.config import SolverConfig as JaxSolverConfig
    from aircraft_tpu.control.mhtt import MHTT as JaxMHTT

    from aircraft_tpu_torch.control.waypoints import receding_warm_start

    jx, pt = short_course_pair()
    window, overlap, Nw, dt = 6, 3, 12, 0.02
    us = receding_warm_start(
        pt["params"], pt["config"], num_nodes=Nw, dt=dt, window=window,
        overlap=overlap, device="cpu", solver_config=SolverConfig(
            max_al_iters=1, max_inner_iters=1, hessian="gauss_newton"))
    assert us.shape == (Nw, 7) and bool(torch.isfinite(us).all())
    jm = JaxMHTT(jx["params"], jx["config"], jx["track"], num_nodes=window,
                 dt=dt, overlap=overlap, solver_config=JaxSolverConfig(
                     max_al_iters=1, max_inner_iters=1,
                     hessian="gauss_newton"))
    x0 = jnp.asarray(jx["config"].waypoints.initial_state, jnp.float32)
    first = jm.solve_window(x0, 0.0, jnp.zeros((window, 7), jnp.float32))
    commit = window - overlap
    _close(us[:commit], first.us[:commit], STEP_TOL)


WHOLE_FIELDS = ("metric", "value", "unit", "vs_baseline",
                "ref_wall_with_callback_s", "horizon", "goal_miss_m", "cost",
                "violation", "iterations", "compile_wall_s",
                "warm_start_wall_s", "device")


def test_bench_whole_mode_prints_the_reference_fields(capsys):
    from aircraft_tpu_torch import bench

    bench.main(["--device", "cpu", "--mode", "whole", "--horizon", "8",
                "--al-iters", "1", "--inner-iters", "1", "--window", "6",
                "--overlap", "3", "--warm-iters", "1,1", "--reps", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(WHOLE_FIELDS) <= set(line)
    assert line["metric"] == "whole_trajectory_solve_s_N8"
    assert line["device"] == "cpu" and line["horizon"] == 8
    assert line["finite"] and np.isfinite(line["goal_miss_m"])


@pytest.mark.parametrize("entry", ["bench_whole", "probe", "racing"])
def test_entry_points_raise_without_a_card(entry, monkeypatch):
    """Asked for the default device on a machine without a card, the new
    entry points raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from aircraft_tpu_torch import bench
    from aircraft_tpu_torch.control import waypoints
    from aircraft_tpu_torch.examples import glider_time_probe

    calls = {
        "bench_whole": lambda: bench.main(["--mode", "whole"]),
        "probe": lambda: glider_time_probe.main([]),
        "racing": lambda: waypoints.solve_time_optimal(
            port_params(jax_params("default")),
            glider_time_probe.short_course_config()),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()
