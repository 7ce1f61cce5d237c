"""The pieces of the port's batched iLQR (solvers/ilqr.py) against the
reference's, elementwise, on one well-posed fleet window (N=4, B=4, no
reversed-flow scenarios) built in both packages from the same numbers:

* ``linearize``: the step Jacobians A, B at rtol = atol = 2e-4 (a float32
  forward-mode derivative through RK4 and the MLP);
* ``quadraticize_gn``, residual and stage-cost-Hessian forms, and the
  residual form with a stage equality and terminal constraints (blocks the
  fused solver refuses): within 1e-3 relative to 1 + max |ref| of each
  block;
* one inner iteration's gains K, k from the port's linearize,
  quadraticize and Riccati sweep against the reference's: within 1e-2
  relative, the gain tolerance of tests/test_window_kernel.py (a chaotic
  plant's derivatives through N knots of Riccati conditioning);
* the line search on that iteration's gains returns a true rollout no
  dearer than the incumbent (the whole solve is held against the
  reference's in tests/test_torch_fused.py);
* the exact expansion (``quadraticize``, ``hessian='exact'``) against the
  reference's ``_quadraticize`` elementwise, and one inner iteration's
  gains on it within 1e-2;
* the options once refused now solve, and a trajectory warm start is
  pinned at x0 and replaced by a true rollout;
* ``solve_batch(batch_minor=True)`` equals ``batch_minor=False`` bit for
  bit, and matches the reference's ``batch_minor=True`` at the population
  tolerance of tests/test_window_kernel.py (mean cost within 5%, mean
  violation within 0.3·(1 + v)) on the quadrotor's goal-batched OCP.

Each reference piece is its own small jit.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp

from aircraft_tpu.solvers import ilqr as jilqr
from aircraft_tpu.solvers import ocp as jocp_mod
from aircraft_tpu.solvers import riccati as jriccati

from aircraft_tpu_torch.config import SolverConfig
from aircraft_tpu_torch.solvers import ilqr
from aircraft_tpu_torch.solvers import ocp as t_ocp

from torch_port_problem import build_pair, fleet_inputs

N, B = 4, 4


def _rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return float(np.max(np.abs(a - ref))) / (1.0 + float(np.max(np.abs(ref))))


@pytest.fixture(scope="module")
def case():
    """A rollout of the fleet through the port's step and the multipliers
    after one update with the per-row ratchet (live active sets)."""
    jx, pt = build_pair("nn")
    z0s, ws = fleet_inputs(B, N, seed=5, reversed_lanes=0)
    tocp = pt["ocp"]
    xs = [torch.as_tensor(z0s)]
    for k in range(N):
        xs.append(tocp.step(xs[-1], torch.as_tensor(ws[:, k]), torch.tensor(k)))
    xs = torch.stack(xs, dim=1)
    assert bool(torch.isfinite(xs).all())
    al = t_ocp.init_al_state(tocp, xs[:, 0], torch.as_tensor(ws[:, 0]), N)
    al = t_ocp.update_multipliers(tocp, al, xs, torch.as_tensor(ws), 10.0,
                                  1e8, row_adapt=True)
    # multipliers of the constrained variant: every block live
    tocp_c = _constrained(tocp)
    al_c = t_ocp.init_al_state(tocp_c, xs[:, 0], torch.as_tensor(ws[:, 0]), N)
    al_c = t_ocp.update_multipliers(tocp_c, al_c, xs, torch.as_tensor(ws),
                                    10.0, 1e8, row_adapt=True)
    to_jax = lambda a: jocp_mod.ALState(**{
        f: jnp.asarray(getattr(a, f).numpy()) for f in t_ocp._AL_FIELDS})
    return dict(jocp=jx["ocp"], tocp=tocp, xs=xs, ws=torch.as_tensor(ws),
                al=al, jal=to_jax(al), al_c=al_c, jal_c=to_jax(al_c))


@pytest.fixture(scope="module")
def linearized(case):
    def lin(x, u, k):
        return jax.jacfwd(lambda xx, uu: case["jocp"].step(xx, uu, k),
                          argnums=(0, 1))(x, u)

    with jax.default_matmul_precision("highest"):
        A, Bm = jax.jit(jax.vmap(jax.vmap(lin)))(
            jnp.asarray(case["xs"][:, :-1].numpy()),
            jnp.asarray(case["ws"].numpy()),
            jnp.tile(jnp.arange(N)[None], (B, 1)))
    return (np.asarray(A), np.asarray(Bm)), ilqr.linearize(
        case["tocp"], case["xs"], case["ws"])


def test_linearize(linearized):
    (A_ref, B_ref), (A, Bm) = linearized
    assert A.shape == (B, N, 14, 14) and Bm.shape == (B, N, 14, 7)
    np.testing.assert_allclose(A.numpy(), A_ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(Bm.numpy(), B_ref, rtol=2e-4, atol=2e-4)


def _constrained(ocp):
    """The window OCP plus a stage equality and terminal constraints (the
    configurations the fused solver refuses), written so the same lambdas
    serve both packages."""
    return dataclasses.replace(
        ocp, eq=lambda x, u, k: x[..., 2:3] + 200.0,
        terminal_ineq=lambda x: x[..., 13:14] - 0.15,
        terminal_eq=lambda x: x[..., 0:1] - 10.0)


def _quad_ref(case, use_residuals, constrained):
    jocp = _constrained(case["jocp"]) if constrained else case["jocp"]
    jal = case["jal_c"] if constrained else case["jal"]
    f = jax.jit(jax.vmap(lambda x, w, a: jilqr._quadraticize_gn(
        jocp, a, x, w, use_residuals=use_residuals)))
    with jax.default_matmul_precision("highest"):
        return [np.asarray(t) for t in f(jnp.asarray(case["xs"].numpy()),
                                         jnp.asarray(case["ws"].numpy()),
                                         jal)]


@pytest.fixture(scope="module")
def quad_residual(case):
    return _quad_ref(case, True, False)


@pytest.mark.parametrize("variant", ["residual", "stage_hessian",
                                     "equalities_and_terminal"])
def test_quadraticize_gn(case, quad_residual, variant):
    use_res = variant != "stage_hessian"
    constrained = variant == "equalities_and_terminal"
    ref = (quad_residual if variant == "residual"
           else _quad_ref(case, use_res, constrained))
    tocp = _constrained(case["tocp"]) if constrained else case["tocp"]
    al = case["al_c"] if constrained else case["al"]
    out = ilqr.quadraticize_gn(tocp, al, case["xs"], case["ws"],
                               use_residuals=use_res)
    for name, o, r in zip(("lx", "lu", "lxx", "luu", "lux", "vx", "vxx"),
                          out, ref):
        assert o.shape == r.shape, name
        assert _rel(o.numpy(), r) < 1e-3, (name, _rel(o.numpy(), r))


@pytest.fixture(scope="module")
def quad_exact(case):
    """The reference's exact expansion (``_quadraticize``) and the
    port's."""
    f = jax.jit(jax.vmap(lambda x, w, a: jilqr._quadraticize(
        case["jocp"], a, x, w)))
    with jax.default_matmul_precision("highest"):
        ref = [np.asarray(t) for t in f(jnp.asarray(case["xs"].numpy()),
                                         jnp.asarray(case["ws"].numpy()),
                                         case["jal"])]
    return ref, ilqr.quadraticize(case["tocp"], case["al"], case["xs"],
                                  case["ws"])


def test_quadraticize_exact(quad_exact):
    """Elementwise within 1e-3 relative plus 1e-3 of each block's largest
    entry: float32 second derivatives of the AL, whose penalty terms
    scale some rows by mu · mu_row up to 1e2 here."""
    ref, out = quad_exact
    for name, o, r in zip(("lx", "lu", "lxx", "luu", "lux", "vx", "vxx"),
                          out, ref):
        assert o.shape == r.shape, name
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-3,
                                   atol=1e-3 * (1.0 + np.abs(r).max()),
                                   err_msg=name)


@pytest.mark.parametrize("sweep", ["sequential", "associative"])
def test_one_exact_inner_iteration_gains(linearized, quad_exact, sweep):
    """One inner iteration with the exact expansion: the port's gains
    against the reference's sweep of the same kind on the reference's
    expansion, within 1e-2 relative as the Gauss-Newton iteration is
    held.  (The two sweeps need not agree with each other on an
    indefinite expansion; each is held to its reference.)"""
    san = lambda t, lim: jnp.clip(
        jnp.nan_to_num(jnp.asarray(t), nan=0.0, posinf=0.0, neginf=0.0),
        -lim, lim)
    (A_ref, B_ref), (A, Bm) = linearized
    ref, out = quad_exact
    with jax.default_matmul_precision("highest"):
        K_ref, k_ref, *_, fail_ref = jax.jit(jax.vmap(
            getattr(jriccati, f"backward_{sweep}")))(
            san(A_ref, 1e6), san(B_ref, 1e6), *(san(t, 1e8) for t in ref),
            jnp.full((B,), 1e-6, jnp.float32))
    K, k, *_, fail = ilqr.backward_pass(A, Bm, *(ilqr._san(t, 1e8)
                                                 for t in out),
                                        torch.full((B,), 1e-6), sweep)
    np.testing.assert_array_equal(fail.numpy(), np.asarray(fail_ref))
    assert _rel(K.numpy(), K_ref) < 1e-2
    assert _rel(k.numpy(), k_ref) < 1e-2


@pytest.fixture(scope="module")
def gains(case, linearized):
    """One inner iteration's backward pass in the port."""
    _, (A, Bm) = linearized
    quad = ilqr.quadraticize_gn(case["tocp"], case["al"], case["xs"],
                                case["ws"])
    return ilqr.backward_pass(A, Bm, *(ilqr._san(t, 1e8) for t in quad),
                              torch.full((B,), 1e-6))


def test_one_inner_iteration_gains(linearized, quad_residual, gains):
    san = lambda t, lim: jnp.clip(
        jnp.nan_to_num(jnp.asarray(t), nan=0.0, posinf=0.0, neginf=0.0),
        -lim, lim)
    (A_ref, B_ref), _ = linearized
    with jax.default_matmul_precision("highest"):
        K_ref, k_ref, *_ = jax.jit(jax.vmap(jriccati.backward_sequential))(
            san(A_ref, 1e6), san(B_ref, 1e6),
            *(san(t, 1e8) for t in quad_residual),
            jnp.full((B,), 1e-6, jnp.float32))
    K, k, *_rest, fail = gains
    assert not bool(fail.any())
    assert _rel(K.numpy(), K_ref) < 1e-2
    assert _rel(k.numpy(), k_ref) < 1e-2


def test_forward_pass_picks_a_true_rollout_no_worse_than_the_incumbent(
        case, gains):
    """The port's line search on that iteration's gains returns a true
    closed-loop rollout of its controls, costed by al_total_cost, no
    dearer than the α = 0 candidate (here the incumbent itself, a true
    rollout of the warm start)."""
    K, kff = (torch.clamp(t, -1e4, 1e4) for t in gains[:2])
    tocp, al = case["tocp"], case["al"]
    xs_n, us_n, cost, nfro = ilqr.forward_pass(
        tocp, al, case["xs"], case["ws"], K, kff,
        torch.tensor(ilqr.line_search_alphas(4)))
    assert not bool(nfro.any())
    for k in range(N):
        np.testing.assert_allclose(
            xs_n[:, k + 1].numpy(),
            tocp.step(xs_n[:, k], us_n[:, k], torch.tensor(k)).numpy(),
            rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        cost.numpy(), t_ocp.al_total_cost(tocp, al, xs_n, us_n).numpy(),
        rtol=1e-6)
    incumbent = t_ocp.al_total_cost(tocp, al, case["xs"], case["ws"])
    assert bool((cost <= incumbent).all())


def test_forward_pass_honours_the_feedback_mask(case, gains):
    """A zero feedback mask drops every feedback gain."""
    K, kff = (torch.clamp(t, -1e4, 1e4) for t in gains[:2])
    alphas = torch.tensor(ilqr.line_search_alphas(3))
    masked = ilqr.forward_pass(
        dataclasses.replace(case["tocp"], feedback_mask=(0.0,) * 7),
        case["al"], case["xs"], case["ws"], K, kff, alphas)
    open_loop = ilqr.forward_pass(case["tocp"], case["al"], case["xs"],
                                  case["ws"], torch.zeros_like(K), kff, alphas)
    for a, b in zip(masked, open_loop):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("kw", [dict(hessian="exact"),
                                dict(hessian="gauss_newton",
                                     riccati="associative")],
                         ids=["hessian_exact", "riccati_associative"])
def test_unported_options_raise(case, kw):
    """Both options were refused before the port had them; each now
    solves, to finite results."""
    cfg = SolverConfig(max_al_iters=1, max_inner_iters=2,
                       line_search_steps=3, **kw)
    sol = ilqr.solve_batch(case["tocp"], case["xs"][:, 0], case["ws"], cfg)
    for t in (sol.xs, sol.us, sol.cost, sol.violation, sol.grad_norm):
        assert bool(torch.isfinite(t).all())
    assert SolverConfig().hessian == "exact"    # the default now solves


def test_batch_minor_raises(case):
    """``batch_minor`` raised before it was ported; it now solves, to the
    same answer as the batch-leading call, bit for bit."""
    cfg = SolverConfig(hessian="gauss_newton", max_al_iters=1,
                       max_inner_iters=1, line_search_steps=3)
    args = (case["tocp"], case["xs"][:, 0], case["ws"], cfg)
    minor = ilqr.solve_batch(*args, batch_minor=True)
    leading = ilqr.solve_batch(*args)
    for a, b in zip(minor[:-1], leading[:-1]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for f in t_ocp._AL_FIELDS:
        np.testing.assert_array_equal(getattr(minor.al, f).numpy(),
                                      getattr(leading.al, f).numpy())


def test_batch_minor_matches_the_reference():
    """The port's ``solve_batch(batch_minor=True)`` against the
    reference's on four goals of the quadrotor's goal-batched OCP (N=10,
    1 x 4).  The quadrotor, not the glider window: the reference traces
    the window's solve for ~60 s on this CPU, the quadrotor's for ~15 s."""
    from aircraft_tpu.config import SolverConfig as JaxSolverConfig
    from aircraft_tpu.control import quadrotor as jq
    from aircraft_tpu.dynamics import quadrotor as jqd

    from aircraft_tpu_torch.control import quadrotor as tq
    from aircraft_tpu_torch.dynamics import quadrotor as tqd

    jp = jqd.QuadrotorParams.default()
    tp = tqd.quadrotor_from_numpy(
        {k: np.asarray(getattr(jp, k)) for k in ("mass", "inertia",
                                                 "gravity")}, device="cpu")
    nb, nn = 4, 10
    z0 = np.zeros((nb, 16), np.float32)
    z0[:, 6] = 1.0     # the quadrotor's hover attitude
    z0[:, 13:] = np.random.default_rng(0).uniform(-4.0, 4.0, (nb, 3))
    us = np.full((nb, nn, 4), 2.5, np.float32)
    budget = dict(max_al_iters=1, max_inner_iters=4, hessian="gauss_newton")
    with jax.default_matmul_precision("highest"):
        ref = jilqr.solve_batch(jq.build_quadrotor_ocp_dynamic(dt=0.1),
                                jnp.asarray(z0), jnp.asarray(us),
                                JaxSolverConfig(**budget), batch_minor=True)
    sol = ilqr.solve_batch(
        tq.build_quadrotor_ocp_dynamic(dt=0.1, params=tp, device="cpu"),
        torch.as_tensor(z0), torch.as_tensor(us), SolverConfig(**budget),
        batch_minor=True)
    assert sol.xs.shape == ref.xs.shape and sol.us.shape == ref.us.shape
    cost, viol = np.asarray(ref.cost), np.asarray(ref.violation)
    assert abs(float(sol.cost.mean()) - cost.mean()) <= 0.05 * abs(
        cost.mean())
    assert abs(float(sol.violation.mean()) - viol.mean()) <= 0.3 * (
        1.0 + viol.mean())


def test_trajectory_warm_start_is_pinned_and_taken(case):
    """xs_init's row 0 is pinned to x0, and the first forward pass (a true
    rollout) replaces the seed."""
    cfg = SolverConfig(hessian="gauss_newton", max_al_iters=1,
                       max_inner_iters=1, line_search_steps=3)
    seed = case["xs"].clone()
    seed[:, 0] += 1.0
    sol = ilqr.solve_impl(case["tocp"], case["xs"][:, 0], case["ws"], cfg,
                          xs_init=seed)
    np.testing.assert_array_equal(sol.xs[:, 0].numpy(),
                                  case["xs"][:, 0].numpy())
    roll = [sol.xs[:, 0]]
    for k in range(N):
        roll.append(case["tocp"].step(roll[-1], sol.us[:, k], torch.tensor(k)))
    np.testing.assert_allclose(sol.xs.numpy(), torch.stack(roll, 1).numpy(),
                               rtol=1e-5, atol=1e-5)
