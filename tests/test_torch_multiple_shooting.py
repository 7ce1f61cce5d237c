"""The port's multiple-shooting transform and inverse-dynamics OCP
against the JAX package.

Multiple shooting: the wrapped step, stage cost, inequality and defect
rows of the glider's window OCP at segment starts and between them, and
the transform's own check on a double integrator.  Inverse dynamics: the rigid-body step on decision forces and
the force/moment matching rows, and a short solve by both packages.

Tolerance: 2e-4 (``tests/test_kernels.py:51``) for steps, rows and
defects; the solves' final states within 1e-3 relative (a benign, short
problem).
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
from aircraft_tpu.control import inverse_dynamics as jid
from aircraft_tpu.control import multiple_shooting as jms

from aircraft_tpu_torch.config import SolverConfig, glider_config
from aircraft_tpu_torch.control import inverse_dynamics as tid
from aircraft_tpu_torch.control import multiple_shooting as tms
from aircraft_tpu_torch.solvers import ilqr as tilqr
from aircraft_tpu_torch.solvers.ocp import OCPFunctions

from test_torch_dynamics import _states
from torch_port_problem import build_pair, fleet_inputs

TOL = dict(rtol=2e-4, atol=2e-4)
SEG = 3


@pytest.fixture(scope="module")
def window_pair():
    jd, td = build_pair("nn")
    n = 14
    return (jms.multiple_shooting_ocp(jd["ocp"], n, 7, SEG),
            tms.multiple_shooting_ocp(td["ocp"], n, 7, SEG))


def test_wrapped_window_rows(window_pair):
    """At every knot of a short horizon, each row is the base OCP's at the
    effective state, plus the defect at segment starts."""
    jocp, tocp = window_pair
    z, ws = fleet_inputs(4, 4, seed=3, reversed_lanes=1)
    rng = np.random.default_rng(4)
    s = z[:, None, :] + 0.5 * rng.standard_normal((4, 4, 14)).astype(
        np.float32)
    for k in range(4):
        v = np.concatenate([ws[:, k], s[:, k]], axis=-1)
        jv, tv = jnp.asarray(v), torch.as_tensor(v)
        jz, tz = jnp.asarray(z), torch.as_tensor(z)
        kt = torch.full((4,), k)
        for name in ("step", "stage_cost", "ineq", "eq"):
            ref = jax.vmap(getattr(jocp, name), in_axes=(0, 0, None))(
                jz, jv, k)
            out = getattr(tocp, name)(tz, tv, kt).numpy()
            np.testing.assert_allclose(out, ref, **TOL, err_msg=f"{name} {k}")
        eq = tocp.eq(tz, tv, kt).numpy()[:, -14:]
        if k > 0 and k % SEG == 0:
            np.testing.assert_allclose(eq, z - s[:, k], **TOL)
        else:
            assert not eq.any()


def test_state_guess_assembly():
    us = np.random.default_rng(0).standard_normal((6, 2)).astype(np.float32)
    guess = np.random.default_rng(1).standard_normal((7, 3)).astype(
        np.float32)
    ref = jms.controls_with_state_guess(jnp.asarray(us), jnp.asarray(guess),
                                        3)
    out = tms.controls_with_state_guess(torch.as_tensor(us),
                                        torch.as_tensor(guess), 3)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _double_integrator(target, dt, torch_side=True):
    A = torch.tensor([[1.0, dt], [0.0, 1.0]])
    B = torch.tensor([[0.5 * dt ** 2], [dt]])
    tgt = torch.as_tensor(target)
    return OCPFunctions(
        step=lambda x, u, k: x @ A.T + u @ B.T,
        stage_cost=lambda x, u, k: 0.01 * torch.sum(u * u, dim=-1),
        terminal_cost=lambda x: 100.0 * torch.sum((x - tgt) ** 2, dim=-1))


def test_double_integrator_from_a_state_guess():
    """The reference's own check of the transform, on the port: from a
    straight-line state guess the defects close (violation < 1e-2) and
    the end state is single shooting's."""
    N, dt, seg = 20, 0.1, 5
    target = np.array([1.0, 0.0], np.float32)
    base = _double_integrator(target, dt, True)
    cfg = SolverConfig(max_al_iters=5, max_inner_iters=6)
    single = tilqr.solve(base, torch.zeros(2), torch.zeros(N, 1), cfg)
    guess = torch.as_tensor(np.linspace(0.0, 1.0, N + 1)[:, None] * target,
                            dtype=torch.float32)
    vs = tms.controls_with_state_guess(torch.zeros(N, 1), guess, seg)
    sol = tilqr.solve(tms.multiple_shooting_ocp(base, 2, 1, seg),
                      torch.zeros(2), vs, cfg)
    assert float(sol.violation) < 1e-2
    np.testing.assert_allclose(sol.xs[-1].numpy(), single.xs[-1].numpy(),
                               atol=5e-2)


@pytest.fixture(scope="module")
def inverse_pair():
    jd, td = build_pair("nn")
    goal = np.array([120.0, 10.0, -195.0], np.float32)
    jcost = (lambda x, u, k: 1e-3 * jnp.sum(u[:3] ** 2),
             lambda x: 1e-2 * jnp.sum((x[:3] - jnp.asarray(goal)) ** 2))
    tcost = (lambda x, u, k: 1e-3 * torch.sum(u[..., :3] ** 2, dim=-1),
             lambda x: 1e-2 * torch.sum((x[..., :3] - torch.as_tensor(goal))
                                        ** 2, dim=-1))
    jocp = jid.build_inverse_dynamics_ocp(
        jd["params"], jax_glider_config(), dt=0.05, substeps=2,
        stage_cost=jcost[0], terminal_cost=jcost[1])
    tocp = tid.build_inverse_dynamics_ocp(
        td["params"], glider_config(), dt=0.05, substeps=2,
        stage_cost=tcost[0], terminal_cost=tcost[1])
    return jd, td, jocp, tocp


def test_inverse_dynamics_rows(inverse_pair):
    jd, td, jocp, tocp = inverse_pair
    x, u = _states(8)
    fm = np.random.default_rng(9).standard_normal((len(x), 6)).astype(
        np.float32)
    v = np.concatenate([u, fm], axis=1)
    for name in ("step", "stage_cost", "ineq", "eq"):
        ref = jax.vmap(getattr(jocp, name), in_axes=(0, 0, None))(
            jnp.asarray(x), jnp.asarray(v), 0)
        out = getattr(tocp, name)(torch.as_tensor(x), torch.as_tensor(v),
                                  torch.zeros(len(x), dtype=torch.int64))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL,
                                   err_msg=name)
    np.testing.assert_allclose(
        tocp.terminal_cost(torch.as_tensor(x)).numpy(),
        np.asarray(jax.vmap(jocp.terminal_cost)(jnp.asarray(x))), **TOL)


def test_inverse_dynamics_solve(inverse_pair):
    """``solve_inverse_dynamics`` from the configured start, N=6, 1 x 3:
    the port's solution rolls out through its own OCP and agrees with
    the reference's within 1e-3 relative."""
    jd, td, _, _ = inverse_pair
    goal = [60.0, 5.0, -198.0]
    kw = dict(num_nodes=6, dt=0.05, substeps=2)
    jsol = jid.solve_inverse_dynamics(
        jd["params"], jax_glider_config(), goal,
        solver_config=JaxSolverConfig(max_al_iters=1, max_inner_iters=3),
        **kw)
    tsol = tid.solve_inverse_dynamics(
        td["params"], glider_config(), goal,
        solver_config=SolverConfig(max_al_iters=1, max_inner_iters=3),
        device="cpu", **kw)
    assert torch.isfinite(tsol.xs).all()
    np.testing.assert_allclose(tsol.xs.numpy(), np.asarray(jsol.xs),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(float(tsol.cost), float(jsol.cost), rtol=1e-3)
