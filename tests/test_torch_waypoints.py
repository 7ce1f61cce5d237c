"""The port's waypoint-racing formulation (``control/waypoints.py``)
against the JAX package on the short two-waypoint course, the same numpy
inputs in both:

* ``build_waypoint_ocp`` in every ``time_mode``: the RK4 step at
  rtol = atol = 2e-4, the stage cost, the inequality rows (with the
  adaptive mode's two forward-mode products) and the terminal rows at
  1e-5 relative;
* ``initial_guess`` and ``_place_mu_impulses``, exactly;
* the exact AL expansion (``ilqr.quadraticize``) at the initial guess,
  where many rows sit at g + λ/μ = 0 (λ at 1, μ at 0), against the
  reference's ``_quadraticize``: within 1e-4 of each block's largest
  entry (a float32 Hessian of the stage rows);
* the per-scenario dt: the OCP's rows at dt (B,) equal B OCPs at each dt,
  bit for bit.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp

from aircraft_tpu.control import waypoints as jwp

from aircraft_tpu_torch.control import waypoints as wp

from torch_port_problem import short_course_pair

STEP_TOL = dict(rtol=2e-4, atol=2e-4)
ROW_TOL = dict(rtol=1e-5, atol=1e-5)
B, N, DT, SUBSTEPS = 5, 8, 0.1, 10     # the probe's knot: 10 RK4 substeps
MODES = ("fixed", "progress", "variable", "adaptive", "sweep")


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


@pytest.fixture(scope="module")
def course():
    return short_course_pair()


def _inputs(course, mode, seed):
    """Augmented states and controls around the course start: states at
    40-50 m/s, λ in [0, 1], μ impulses, ν near the nominal dt's."""
    jx, _ = course
    rng = np.random.default_rng(seed)
    x0 = np.asarray(jx["config"].waypoints.initial_state, np.float32)
    x = np.tile(x0[None], (B, 1)) + 0.02 * rng.standard_normal((B, 13))
    x[:, :3] += rng.uniform(0, 200, (B, 3)) * [1, 0.1, 0.02]
    x[:, 6:10] /= np.linalg.norm(x[:, 6:10], axis=1, keepdims=True)
    z = [x, rng.uniform(0, 1, (B, 2))]
    if mode == "sweep":
        z.append(rng.uniform(0.05, 0.15, (B, 1)))
    v = [rng.uniform(-3, 3, (B, 3)), np.zeros((B, 3)),
         rng.uniform(0, 1, (B, 1)), rng.uniform(0, 1, (B, 2))]
    if mode == "progress":
        v.append(1.0 / np.sqrt(rng.uniform(0.05, 0.15, (B, 1))))
    elif mode in ("variable", "adaptive"):
        v.append(np.sqrt(rng.uniform(0.05, 0.15, (B, 1))))
    return (np.concatenate(z, 1).astype(np.float32),
            np.concatenate(v, 1).astype(np.float32))


@pytest.mark.parametrize("mode", MODES)
def test_build_waypoint_ocp(course, mode):
    jx, pt = course
    kw = dict(dt=DT, num_nodes=N, substeps=SUBSTEPS, time_mode=mode,
              dt_bounds=(0.02, 0.3))
    jo = jwp.build_waypoint_ocp(jx["params"], jx["config"], **kw)
    to = wp.build_waypoint_ocp(pt["params"], pt["config"], **kw)
    zs, vs = _inputs(course, mode, seed=MODES.index(mode))
    z, v = torch.as_tensor(zs), torch.as_tensor(vs)
    k, jk = torch.zeros(B, dtype=torch.int64), jnp.zeros(B, jnp.int32)
    _close(to.step(z, v, k), jax.vmap(jo.step)(zs, vs, jk), STEP_TOL)
    for name in ("stage_cost", "ineq"):
        out = getattr(to, name)(z, v, k)
        assert out.dtype == torch.float32
        _close(out, jax.vmap(getattr(jo, name))(zs, vs, jk), ROW_TOL)
    for name in ("terminal_cost", "terminal_eq"):
        _close(getattr(to, name)(z), jax.vmap(getattr(jo, name))(zs),
               ROW_TOL)
    assert to.feedback_mask == jo.feedback_mask


@pytest.mark.parametrize("mode", MODES)
def test_initial_guess(course, mode):
    jx, pt = course
    jz, jv = jwp.initial_guess(jx["config"], 11, time_mode=mode, dt=0.02)
    tz, tv = wp.initial_guess(pt["config"], 11, time_mode=mode, dt=0.02,
                              device="cpu")
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_place_mu_impulses(course):
    jx, _ = course
    rng = np.random.default_rng(5)
    wps = np.asarray(jx["config"].waypoints.array(), np.float32)
    # a path that passes the second waypoint's closest point first
    xs = np.zeros((N + 1, 15), np.float32)
    xs[:, :3] = np.linspace([0, 0, -200], [260, 0, -190], N + 1)
    xs[2, :3] = wps[1] + 1.0
    vs = rng.uniform(0, 1, (N, 9)).astype(np.float32)
    idx = list(jx["config"].waypoints.waypoint_indices)
    ref = jwp._place_mu_impulses(jnp.asarray(vs), jnp.asarray(xs),
                                 jnp.asarray(wps), jnp.asarray(idx), 2)
    out = wp._place_mu_impulses(torch.as_tensor(vs), torch.as_tensor(xs),
                                torch.as_tensor(wps), idx, 2)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_exact_expansion_at_the_initial_guess(course):
    """At the initial guess the ordering, bound and complementarity rows sit
    exactly at g + λ/μ = 0; the reference's ``jnp.maximum`` splits the
    derivative there, so those rows weigh ¼ μ ∇g∇gᵀ in the Hessian."""
    from aircraft_tpu.solvers import ilqr as jilqr
    from aircraft_tpu.solvers import ocp as jocp

    from aircraft_tpu_torch.solvers import ilqr
    from aircraft_tpu_torch.solvers import ocp as tocp

    jx, pt = course
    jo = jwp.build_waypoint_ocp(jx["params"], jx["config"], dt=DT,
                                num_nodes=N, substeps=SUBSTEPS)
    to = wp.build_waypoint_ocp(pt["params"], pt["config"], dt=DT,
                               num_nodes=N, substeps=SUBSTEPS)
    z0, vs = wp.initial_guess(pt["config"], N, dt=DT, device="cpu")
    xs, _ = ilqr.initial_rollout(to, z0[None], vs[None])
    al = tocp.init_al_state(to, z0[None], vs[:1], N)
    out = ilqr.quadraticize(to, al, xs, vs[None])
    jal = jocp.init_al_state(jo, jnp.asarray(z0.numpy()),
                             jnp.asarray(vs[0].numpy()), N)
    ref = jax.jit(lambda x, u: jilqr._quadraticize(jo, jal, x, u))(
        jnp.asarray(xs[0].numpy()), jnp.asarray(vs.numpy()))
    for o, r in zip(out, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(o[0].detach().numpy(), r, rtol=0,
                                   atol=1e-4 * (1.0 + np.abs(r).max()))


def test_per_scenario_dt_rows_equal_one_problem_per_dt(course):
    """The OCP at dt (B,) evaluates row r at scenario r // (rows / B)'s dt:
    for B·N knot rows, and for (B, N) batches."""
    _, pt = course
    dts = torch.tensor([0.06, 0.1, 0.13])
    batched = wp.build_waypoint_ocp(pt["params"], pt["config"], dt=dts,
                                    num_nodes=N, substeps=SUBSTEPS)
    zs, vs = _inputs(course, "fixed", seed=9)
    z = torch.as_tensor(zs)[:3, None].repeat(1, N, 1)
    v = torch.as_tensor(vs)[:3, None].repeat(1, N, 1)
    ks = torch.arange(N)
    rows = batched.step(z.reshape(-1, 15), v.reshape(-1, 9), ks.repeat(3))
    grid = batched.step(z, v, ks)
    for i, dt in enumerate(dts):
        one = wp.build_waypoint_ocp(pt["params"], pt["config"],
                                    dt=float(dt), num_nodes=N,
                                    substeps=SUBSTEPS)
        want = one.step(z[i], v[i], ks)
        assert torch.equal(rows.reshape(3, N, 15)[i], want)
        assert torch.equal(grid[i], want)
    with pytest.raises(ValueError):
        batched.step(z[0], v[0], ks)      # 8 rows do not split into 3
    # rows that need no dt take any count (the solver probes one row)
    one = wp.build_waypoint_ocp(pt["params"], pt["config"], dt=0.1,
                                num_nodes=N, substeps=SUBSTEPS)
    for name in ("ineq", "stage_cost"):
        assert torch.equal(getattr(batched, name)(z[0, :1], v[0, :1], ks[:1]),
                           getattr(one, name)(z[0, :1], v[0, :1], ks[:1]))
