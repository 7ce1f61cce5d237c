"""The port's quadrotor plant and its fixed-time, dynamic-target and
variable-time OCPs against the JAX package, on a goal the vehicle reaches
in about a second (N = 20 knots of 0.1 s).

Tolerances: the plant's derivative rtol = atol = 1e-5 (a pure function);
the OCPs' steps and rows 2e-4 (single steps); a fixed-time solve at 2 x 5
(the plant is benign), final xs / us within 1e-3 relative and the cost
within 1e-4 relative; the time-optimal ladder at scales (0.5, 1.0), 2 x 5:
the same feasible set and the same ``dt_uniform``, and both free-time
refinements' times within 1e-3 relative, the returned schedule's xs / us
within 1e-3 relative.
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
from aircraft_tpu.control import quadrotor as jq
from aircraft_tpu.dynamics import quadrotor as jqd

from aircraft_tpu_torch.config import SolverConfig
from aircraft_tpu_torch.control import quadrotor as tq
from aircraft_tpu_torch.dynamics import base as tbase
from aircraft_tpu_torch.dynamics import quadrotor as tqd

PURE = dict(rtol=1e-5, atol=1e-5)
STEP = dict(rtol=2e-4, atol=2e-4)
TARGET = [4.0, 3.0, -2.0]
BUDGET = dict(max_al_iters=2, max_inner_iters=5)


def _params():
    jp = jqd.QuadrotorParams.default()
    return jp, tqd.quadrotor_from_numpy(
        {k: np.asarray(getattr(jp, k)) for k in ("mass", "inertia",
                                                 "gravity")}, device="cpu")


def _inputs(B=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 13)).astype(np.float32)
    x[:, 6:10] /= np.linalg.norm(x[:, 6:10], axis=1, keepdims=True)
    u = rng.uniform(0.0, 6.0, (B, 4)).astype(np.float32)
    return x, u


def test_plant():
    jp, tp = _params()
    x, u = _inputs()
    for name in ("forces_frd", "moments_frd", "state_derivative"):
        np.testing.assert_allclose(
            getattr(tqd, name)(tp, torch.as_tensor(x),
                               torch.as_tensor(u)).numpy(),
            np.asarray(getattr(jqd, name)(jp, jnp.asarray(x),
                                          jnp.asarray(u))), **PURE)
    assert torch.equal(tbase.state_derivative(tp, torch.as_tensor(x),
                                              torch.as_tensor(u)),
                       tqd.state_derivative(tp, torch.as_tensor(x),
                                            torch.as_tensor(u)))
    np.testing.assert_array_equal(tq.initial_state_inverted("cpu").numpy(),
                                  np.asarray(jq.initial_state_inverted()))


def test_ocp_rows():
    """Each OCP's step, costs and rows, per knot as the reference
    evaluates them and batched in the port."""
    jp, tp = _params()
    x, u = _inputs(seed=1)
    tgt = np.tile(np.asarray(TARGET, np.float32), (len(x), 1))
    v = np.concatenate([u, np.full((len(x), 1), 0.3, np.float32)], axis=1)
    z = np.concatenate([x, tgt], axis=1)
    cases = [
        (jq.build_quadrotor_ocp(TARGET, dt=0.1),
         tq.build_quadrotor_ocp(TARGET, dt=0.1, params=tp, device="cpu"),
         x, u),
        (jq.build_quadrotor_ocp_dynamic(dt=0.1),
         tq.build_quadrotor_ocp_dynamic(dt=0.1, params=tp, device="cpu"),
         z, u),
        (jq.build_quadrotor_ocp_variable_time(TARGET, dt_bounds=(0.02, 0.2)),
         tq.build_quadrotor_ocp_variable_time(TARGET, dt_bounds=(0.02, 0.2),
                                              params=tp, device="cpu"),
         x, v)]
    for jocp, tocp, xx, uu in cases:
        for name in ("step", "stage_cost", "ineq"):
            ref = jax.vmap(getattr(jocp, name), in_axes=(0, 0, None))(
                jnp.asarray(xx), jnp.asarray(uu), 0)
            out = getattr(tocp, name)(torch.as_tensor(xx),
                                      torch.as_tensor(uu),
                                      torch.zeros(len(xx), dtype=torch.int64))
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), **STEP,
                                       err_msg=name)
        np.testing.assert_allclose(
            tocp.terminal_cost(torch.as_tensor(xx)).numpy(),
            np.asarray(jax.vmap(jocp.terminal_cost)(jnp.asarray(xx))), **STEP)
        assert tocp.feedback_mask == jocp.feedback_mask


def test_fixed_time_solve():
    js = jq.solve_quadrotor_control(TARGET, num_nodes=20, dt=0.1,
                                    solver_config=JaxSolverConfig(**BUDGET))
    ts = tq.solve_quadrotor_control(TARGET, num_nodes=20, dt=0.1,
                                    solver_config=SolverConfig(**BUDGET),
                                    device="cpu")
    scale = lambda a: np.abs(np.asarray(a)).max()
    assert np.abs(ts.xs.numpy() - np.asarray(js.xs)).max() <= 1e-3 * scale(
        js.xs)
    assert np.abs(ts.us.numpy() - np.asarray(js.us)).max() <= 1e-3 * scale(
        js.us)
    assert float(ts.cost) == pytest.approx(float(js.cost), rel=1e-4)
    assert float(ts.violation) < 1e-2


def test_time_optimal_ladder():
    """The ladder's feasible set and fastest schedule, and both free-time
    refinements (the m = 5 solves from the ladder's winner and from the
    nominal), match the reference's."""
    jo = jq.solve_quadrotor_time_optimal(
        TARGET, num_nodes=20, scales=(0.5, 1.0),
        solver_config=JaxSolverConfig(hessian="gauss_newton", **BUDGET))
    to = tq.solve_quadrotor_time_optimal(
        TARGET, num_nodes=20, scales=(0.5, 1.0),
        solver_config=SolverConfig(hessian="gauss_newton", **BUDGET),
        device="cpu")
    assert ([r["feasible"] for r in to["candidates"]]
            == [r["feasible"] for r in jo["candidates"]])
    assert any(r["feasible"] for r in to["candidates"])
    assert to["dt_uniform"] == jo["dt_uniform"]
    assert to["variable_accepted"] == jo["variable_accepted"]
    for key in ("T_variable", "T_final", "T_variable_from_nominal"):
        assert to[key] == pytest.approx(jo[key], rel=1e-3), key
    assert to["T_final"] <= to["T_uniform"]
    scale = lambda a: np.abs(np.asarray(a)).max()
    sol, ref = to["solution"], jo["solution"]
    assert sol.us.shape == ref.us.shape
    assert np.abs(sol.xs.numpy() - np.asarray(ref.xs)).max() <= 1e-3 * scale(
        ref.xs)
    assert np.abs(sol.us.numpy() - np.asarray(ref.us)).max() <= 1e-3 * scale(
        ref.us)
