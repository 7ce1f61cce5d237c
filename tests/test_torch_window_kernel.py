"""The plain versions of the port's window kernels (kernels/window.py)
against the reference's jnp oracle on the same problem, at N=4, B=8.

The backward pass is held against ``ilqr._quadraticize_gn`` (residual
form) + ``riccati.backward_sequential``, the oracle that
tests/test_window_kernel.py composes for the TPU kernel: gains within
1e-2 relative, for the same reason given there (the derivative of a
chaotic plant through N knots of Riccati conditioning).  The forward pass
is held against a JAX rollout composed from ``ocp.step``,
``al_stage_cost`` and the window's terminal cost: candidate costs and the
stored trajectory within 2e-4 relative, the chosen α exactly.  The batch
includes scenarios whose body-frame flow is reversed (u_rel < 0).
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

from aircraft_tpu.solvers import ilqr, riccati
from aircraft_tpu.solvers import ocp as jocp_mod

from aircraft_tpu_torch.config import SolverConfig
from aircraft_tpu_torch.kernels import window as win
from aircraft_tpu_torch.solvers.fused import make_fused_solver
from aircraft_tpu_torch.solvers import ocp as t_ocp
from aircraft_tpu_torch.solvers.ocp import ALState

from torch_port_problem import build_pair, fleet_inputs

N, B = 4, 8
ALPHAS = win.line_search_alphas(4)
GAIN_RTOL = 1e-2    # relative to 1 + max |gain| of the oracle
COST_RTOL = 2e-4


@pytest.fixture(scope="module")
def case():
    """Inputs made once and handed to both packages: a rollout of the
    fleet through the port's step (test_torch_ocp holds that step to the
    reference's) and the multipliers after one update with the per-row
    ratchet, so the active sets are live."""
    jx, pt = build_pair("nn")
    z0s, ws = fleet_inputs(B, N, seed=1)
    tocp = pt["ocp"]
    xs = [torch.as_tensor(z0s)]
    for k in range(N):
        xs.append(tocp.step(xs[-1], torch.as_tensor(ws[:, k]), torch.tensor(k)))
    xs = torch.stack(xs, dim=1)
    assert bool(torch.isfinite(xs).all())
    al = t_ocp.init_al_state(tocp, xs[:, 0], torch.as_tensor(ws[:, 0]), N)
    al = t_ocp.update_multipliers(tocp, al, xs, torch.as_tensor(ws), 10.0,
                                  1e8, row_adapt=True)
    jal = jocp_mod.ALState(**{f: jnp.asarray(getattr(al, f).numpy()) for f in (
        "lam_ineq", "lam_eq", "lam_t_ineq", "lam_t_eq", "mu", "mu_row")})
    op = win.make_window_operands(pt["spec"], N, alphas=ALPHAS, device="cpu")
    return dict(jx=jx, pt=pt, op=op, xs=xs.numpy(), ws=ws, al=jal,
                t_xs=xs.contiguous(), t_ws=torch.as_tensor(ws),
                t_lam=al.lam_ineq.contiguous(), t_mu=al.mu.contiguous(),
                t_murow=al.mu_row.contiguous())


@pytest.fixture(scope="module")
def backward(case):
    jocp = case["jx"]["ocp"]
    xs, ws, al = jnp.asarray(case["xs"]), jnp.asarray(case["ws"]), case["al"]
    reg = jnp.full((B,), 1e-6, jnp.float32)

    # the oracle in three programs: XLA compiles them far faster than one
    quad = jax.jit(jax.vmap(lambda x, w, a: ilqr._quadraticize_gn(
        jocp, a, x, w, use_residuals=True)))

    def lin(x, u, k):
        return jax.jacfwd(lambda xx, uu: jocp.step(xx, uu, k),
                          argnums=(0, 1))(x, u)

    san = lambda t, lim: jnp.clip(
        jnp.nan_to_num(t, nan=0.0, posinf=0.0, neginf=0.0), -lim, lim)
    with jax.default_matmul_precision("highest"):
        lx, lu, lxx, luu, lux, vx, vxx = (san(t, 1e8) for t in quad(xs, ws, al))
        A, Bm = jax.jit(jax.vmap(jax.vmap(lin)))(
            xs[:, :-1], ws, jnp.tile(jnp.arange(N)[None], (B, 1)))
        K, kff, dv1, dv2, qu, _ = jax.jit(jax.vmap(riccati.backward_sequential))(
            san(A, 1e6), san(Bm, 1e6), lx, lu, lxx, luu, lux, vx, vxx, reg)
    ref = (K, kff, qu, dv1, dv2)
    out = win.window_backward(
        case["op"], case["t_xs"], case["t_ws"], case["t_lam"], case["t_mu"],
        torch.full((B,), 1e-6), case["t_murow"], torch.as_tensor(vx),
        torch.as_tensor(vxx))
    return [np.asarray(r) for r in ref], [o.numpy() for o in out]


def _rel(a, ref):
    return float(np.max(np.abs(a - ref))) / (1.0 + float(np.max(np.abs(ref))))


def test_backward_gains_match_jnp_oracle(backward):
    (K_ref, k_ref, qu_ref, dv1_ref, dv2_ref), (K, k, dv1, dv2, qu, fail) = backward
    assert not fail.any()
    assert _rel(K, K_ref) < GAIN_RTOL
    assert _rel(k, k_ref) < GAIN_RTOL
    assert float(np.max(np.abs(qu - qu_ref) / (1.0 + qu_ref))) < GAIN_RTOL
    assert _rel(dv1, dv1_ref) < GAIN_RTOL
    assert _rel(dv2, dv2_ref) < GAIN_RTOL


def _forward_jax(case, K, kff):
    """Every candidate rolled out with ocp.step and costed with
    al_stage_cost + the terminal cost, the kernel's freeze rule."""
    jocp = case["jx"]["ocp"]
    xs, ws, al = jnp.asarray(case["xs"]), jnp.asarray(case["ws"]), case["al"]
    K, kff = jnp.asarray(K), jnp.asarray(kff)

    def one(xs_i, ws_i, K_i, k_i, al_i, alpha):
        def body(carry, inp):
            x, cost, nfro = carry
            u_r, x_r, Kk, kk, k = inp
            u = u_r + alpha * kk + Kk @ (x - x_r)
            c = jocp_mod.al_stage_cost(jocp, al_i, x, u, k)
            xn = jocp.step(x, u, k)
            fin = jnp.all(jnp.isfinite(xn)) & (jnp.max(jnp.abs(xn)) < 1e6)
            xn = jnp.where(fin, xn, x)
            return (xn, cost + c, nfro + (1.0 - fin)), (xn, u)

        (x, cost, nfro), (xo, uo) = jax.lax.scan(
            body, (xs_i[0], 0.0, 0.0), (ws_i, xs_i[:-1], K_i, k_i, jnp.arange(N)))
        cost = cost + jocp.terminal_cost(x)
        cost = jnp.where(jnp.isnan(cost), jnp.inf, cost) + 1e7 * nfro
        return cost, jnp.concatenate([xs_i[:1], xo]), uo

    f = jax.jit(jax.vmap(jax.vmap(one, in_axes=(None,) * 5 + (0,)),
                         in_axes=(0,) * 5 + (None,)))
    with jax.default_matmul_precision("highest"):
        costs, xs_c, us_c = f(xs, ws, K, kff, al, jnp.asarray(ALPHAS))
    return np.asarray(costs), np.asarray(xs_c), np.asarray(us_c)


def test_forward_matches_jax_rollout(case, backward):
    _, (K, kff, *_rest) = backward
    costs_ref, xs_ref, us_ref = _forward_jax(case, K, kff)
    xs_new, ws_new, misc = (o.numpy() for o in win.window_forward(
        case["op"], case["t_xs"], case["t_ws"], torch.as_tensor(K),
        torch.as_tensor(kff), case["t_lam"], case["t_mu"], case["t_murow"]))
    A = len(ALPHAS)
    assert np.all(np.isfinite(costs_ref))
    np.testing.assert_allclose(misc[:, :A], costs_ref, rtol=COST_RTOL,
                               atol=COST_RTOL)
    best = np.argmin(costs_ref, axis=1)      # first minimum = the tie rule
    np.testing.assert_array_equal(misc[:, A + 2], np.asarray(ALPHAS)[best])
    np.testing.assert_allclose(misc[:, A], costs_ref[np.arange(B), best],
                               rtol=COST_RTOL, atol=COST_RTOL)
    for b in range(B):
        np.testing.assert_allclose(xs_new[b], xs_ref[b, best[b]],
                                   rtol=COST_RTOL, atol=COST_RTOL)
        np.testing.assert_allclose(ws_new[b], us_ref[b, best[b]],
                                   rtol=COST_RTOL, atol=COST_RTOL)


def test_batch_has_reversed_flow(case):
    """The last scenarios fly with body-frame u_rel < 0 at the first knot
    (alpha reads about ±π there)."""
    from aircraft_tpu_torch.dynamics.aircraft import v_frd_rel

    x = case["t_xs"][:, 0, :13]
    u_rel = v_frd_rel(case["pt"]["params"], x, torch.zeros(B, 7))[:, 0]
    assert bool((u_rel[-2:] < 0).all()) and bool((u_rel[:-2] > 0).all())


def test_wrapper_rejects_tensors_off_the_operands_device(case):
    """A wrapper given tensors on another device than its operands raises
    instead of moving work."""
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        win.window_forward(case["op"], case["t_xs"].to(meta), case["t_ws"],
                           None, None, None, None, None)


def test_forward_wrapper_refuses_a_horizon_beyond_shared_memory(case):
    """The forward kernel holds a scenario's reference in one block's shared
    memory: the headline horizon fits without opting in above 48 KB, and
    the wrapper raises ValueError, CPU tensors included, for the first
    horizon that does not fit in a block's 227 KB."""
    ng, A = case["op"].ng, len(ALPHAS)
    assert win.forward_smem_bytes(50, ng, A) <= 48 * 1024
    n_big = next(n for n in range(1, 1000)
                 if win.forward_smem_bytes(n, ng, A) > win.SMEM_MAX)
    op = win.make_window_operands(case["pt"]["spec"], n_big, alphas=ALPHAS,
                                  device="cpu")
    z = lambda *s: torch.zeros(s)
    with pytest.raises(ValueError, match="shared memory"):
        win.window_forward(op, z(1, n_big + 1, 14), z(1, n_big, 7),
                           z(1, n_big, 7, 14), z(1, n_big, 7),
                           z(1, n_big, ng), torch.ones(1), torch.ones(1, ng))


# ---------------------------------------------------------------------------
# configurations the fused solver refuses
# ---------------------------------------------------------------------------


def _refused_cases():
    gn = dict(hessian="gauss_newton")
    return {
        "hessian_exact": ({"hessian": "exact"}, None, None),
        "no_residual_gn": ({**gn, "use_residual_gn": False}, None, None),
        "riccati_associative": ({**gn, "riccati": "associative"}, None, None),
        "feedback_mask": (gn, {"feedback_mask": (1,) * 7}, None),
        "no_residuals": (gn, {"stage_residuals": None}, None),
        "terminal_ineq": (gn, {"terminal_ineq":
                               lambda x: x[..., :1] - 1.0}, None),
        "terminal_eq": (gn, {"terminal_eq": lambda x: x[..., :1]}, None),
        "wind_channels": (gn, None, {"wind_channels": True}),
        "no_envelope": (gn, None, {"envelope": None}),
        "coefficient_model": (gn, None, {"params": "poly"}),
    }


@pytest.mark.parametrize("name", sorted(_refused_cases()))
def test_fused_solver_refuses_unsupported_config(name):
    from torch_port_problem import port_params, jax_params
    from aircraft_tpu_torch.config import glider_config
    from aircraft_tpu_torch.control.mhtt import build_mhtt_ocp

    cfg_kw, ocp_kw, spec_kw = _refused_cases()[name]
    params = port_params(jax_params("default"))
    pts = torch.stack([torch.linspace(0, 100, 8), torch.zeros(8),
                       torch.full((8,), -100.0)], dim=1)
    spec = {}
    ocp = build_mhtt_ocp(params, glider_config(), pts, 100.0, dt=0.01,
                         spec_out=spec)
    if ocp_kw:
        ocp = dataclasses.replace(ocp, **ocp_kw)
    if spec_kw:
        spec = dict(spec, **spec_kw)
        if spec.get("params") == "poly":
            spec["params"] = dataclasses.replace(params, coeff=object())
    with pytest.raises(NotImplementedError):
        make_fused_solver(ocp, spec, 2, SolverConfig(**cfg_kw))


def test_fused_solver_accepts_the_headline_config():
    from torch_port_problem import port_params, jax_params
    from aircraft_tpu_torch.config import glider_config
    from aircraft_tpu_torch.control.mhtt import build_mhtt_ocp

    params = port_params(jax_params("default"))
    pts = torch.stack([torch.linspace(0, 100, 8), torch.zeros(8),
                       torch.full((8,), -100.0)], dim=1)
    spec = {}
    ocp = build_mhtt_ocp(params, glider_config(), pts, 100.0, dt=0.01,
                         spec_out=spec)
    solve = make_fused_solver(ocp, spec, 2, SolverConfig(
        hessian="gauss_newton", max_al_iters=1, max_inner_iters=1,
        line_search_steps=3))
    z0 = torch.tensor([[0.0, 0.0, -100.0, 30.0, 0, 0, 0, 0, 0, 1.0, 0, 0, 0,
                        0.1]])
    sol = solve(z0, torch.zeros(1, 2, 7))
    assert sol.xs.shape == (1, 3, 14) and bool(torch.isfinite(sol.cost).all())
    assert isinstance(sol.al, ALState)
