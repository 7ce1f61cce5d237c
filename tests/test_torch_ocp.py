"""The port's window formulation against the JAX package on the same
numpy inputs: the course track and its state guess at the bench knobs,
build_mhtt_ocp's step, residual, inequality and cost rows, the AL pieces
(stage and terminal cost, max_violation, update_multipliers with the
per-row ratchet, the dual shift), and multistart_trim on the start cloud
the reference draws.

Tolerance: rtol = atol = 2e-4 for float32 evaluations, 1e-3 relative on
track points (positions of hundreds of metres through an arc-length
resample); trims by their residual, airspeed and glide angle.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp

from aircraft_tpu.config import glider_config as jax_glider_config
from aircraft_tpu.control.course import course_track as jax_course_track
from aircraft_tpu.solvers import ocp as jo
from aircraft_tpu.solvers import trim as jtrim

from aircraft_tpu_torch.config import glider_config
from aircraft_tpu_torch.control.course import course_track
from aircraft_tpu_torch.solvers import ocp as to
from aircraft_tpu_torch.solvers import trim as ttrim

from torch_port_problem import build_pair, fleet_inputs, jax_params, port_params

TOL = dict(rtol=2e-4, atol=2e-4)
N, B = 4, 8


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or TOL))


@pytest.fixture(scope="module")
def tracks():
    # the bench lays the track out at its plant's best glide
    kw = dict(v_ref=28.0, glide_ld=8.5)
    return course_track(glider_config(), **kw), jax_course_track(
        jax_glider_config(), **kw)


def test_course_track_points(tracks):
    t, j = tracks
    assert t.length() == pytest.approx(j.length(), rel=1e-6)
    _close(t.track_points, j.track_points, rtol=1e-3, atol=1e-2)


def test_state_guess(tracks):
    t, j = tracks
    np.testing.assert_allclose(t.state_guess(50), j.state_guess(50),
                               rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def window():
    jx, pt = build_pair("nn")
    z0, ws = fleet_inputs(B, N, seed=2)
    jocp, tocp = jx["ocp"], pt["ocp"]
    # the port rolls the inputs out (test_step holds its step to JAX's)
    xs = [torch.as_tensor(z0)]
    for k in range(N):
        xs.append(tocp.step(xs[-1], torch.as_tensor(ws[:, k]), torch.tensor(k)))
    xs = torch.stack(xs, dim=1).numpy()
    return dict(jocp=jocp, tocp=tocp, xs=xs, ws=ws, jspec=jx["spec"],
                tspec=pt["spec"])


@pytest.mark.parametrize("fn", ["stage_residuals", "ineq", "stage_rest",
                                "stage_cost"])
def test_stage_rows(window, fn):
    x, w = window["xs"][:, 1], window["ws"][:, 1]
    j = jax.vmap(lambda a, b: getattr(window["jocp"], fn)(a, b, 1))(
        jnp.asarray(x), jnp.asarray(w))
    t = getattr(window["tocp"], fn)(torch.as_tensor(x), torch.as_tensor(w),
                                    torch.tensor(1))
    _close(t, j)


def test_step(window):
    x, w = window["xs"][:, 2], window["ws"][:, 2]
    j = jax.vmap(lambda a, b: window["jocp"].step(a, b, 2))(
        jnp.asarray(x), jnp.asarray(w))
    _close(window["tocp"].step(torch.as_tensor(x), torch.as_tensor(w),
                               torch.tensor(2)), j)


def test_terminal_cost(window):
    x = window["xs"][:, -1]
    _close(window["tocp"].terminal_cost(torch.as_tensor(x)),
           jax.vmap(window["jocp"].terminal_cost)(jnp.asarray(x)))


def test_spec_out_keys_and_values(window):
    j, t = window["jspec"], window["tspec"]
    assert set(j) == set(t)
    for k in ("dt", "substeps", "progress_correction", "track_dims", "v_ref",
              "w_speed", "w_rate", "alpha_guard_deg", "beta_guard_deg",
              "stall_guard", "tail_damp", "wind_channels", "squash_box"):
        assert j[k] == t[k], k
    for k in ("speed_bounds", "alpha_lim", "beta_lim", "lo_scale", "hi_scale",
              "include_control_box"):
        assert j["envelope"][k] == pytest.approx(t["envelope"][k]), k


@pytest.fixture(scope="module")
def al_pair(window):
    jocp, tocp = window["jocp"], window["tocp"]
    xs, ws = window["xs"], window["ws"]
    jal = jax.vmap(lambda x, u: jo.init_al_state(jocp, x, u, N))(
        jnp.asarray(xs[:, 0]), jnp.asarray(ws[:, 0]))
    tal = to.init_al_state(tocp, torch.as_tensor(xs[:, 0]),
                           torch.as_tensor(ws[:, 0]), N)
    return jal, tal


def _al_close(tal, jal):
    for f in ("lam_ineq", "lam_eq", "lam_t_ineq", "lam_t_eq", "mu", "mu_row"):
        _close(getattr(tal, f), getattr(jal, f))


def test_init_al_state(al_pair):
    _al_close(al_pair[1], al_pair[0])


@pytest.mark.parametrize("row_adapt", [False, True])
def test_update_multipliers(window, al_pair, row_adapt):
    jal, tal = al_pair
    xs, ws = window["xs"], window["ws"]
    jn = jax.vmap(lambda a, x, u: jo.update_multipliers(
        window["jocp"], a, x, u, 10.0, 1e8, row_adapt=row_adapt))(
        jal, jnp.asarray(xs), jnp.asarray(ws))
    tn = to.update_multipliers(window["tocp"], tal, torch.as_tensor(xs),
                               torch.as_tensor(ws), 10.0, 1e8,
                               row_adapt=row_adapt)
    _al_close(tn, jn)
    if row_adapt:
        assert float(tn.mu_row.max()) > 1.0     # some row ratcheted


@pytest.fixture(scope="module")
def al_updated(window, al_pair):
    jal, tal = al_pair
    xs, ws = window["xs"], window["ws"]
    jn = jax.vmap(lambda a, x, u: jo.update_multipliers(
        window["jocp"], a, x, u, 10.0, 1e8, row_adapt=True))(
        jal, jnp.asarray(xs), jnp.asarray(ws))
    tn = to.update_multipliers(window["tocp"], tal, torch.as_tensor(xs),
                               torch.as_tensor(ws), 10.0, 1e8, row_adapt=True)
    return jn, tn


@pytest.mark.parametrize("k", [0, N - 1])
def test_al_stage_cost(window, al_updated, k):
    jal, tal = al_updated
    x, w = window["xs"][:, k], window["ws"][:, k]
    j = jax.vmap(lambda a, xx, uu: jo.al_stage_cost(window["jocp"], a, xx, uu, k))(
        jal, jnp.asarray(x), jnp.asarray(w))
    _close(to.al_stage_cost(window["tocp"], tal, torch.as_tensor(x),
                            torch.as_tensor(w), k), j)


def test_al_terminal_cost(window, al_updated):
    jal, tal = al_updated
    x = window["xs"][:, -1]
    j = jax.vmap(lambda a, xx: jo.al_terminal_cost(window["jocp"], a, xx))(
        jal, jnp.asarray(x))
    _close(to.al_terminal_cost(window["tocp"], tal, torch.as_tensor(x)), j)


@pytest.mark.parametrize("fn", ["max_violation", "true_cost"])
def test_trajectory_measures(window, fn):
    xs, ws = window["xs"], window["ws"]
    j = jax.vmap(lambda x, u: getattr(jo, fn)(window["jocp"], x, u))(
        jnp.asarray(xs), jnp.asarray(ws))
    _close(getattr(to, fn)(window["tocp"], torch.as_tensor(xs),
                           torch.as_tensor(ws)), j)


def test_shift_al_state_and_gate(al_updated):
    jal, tal = al_updated
    viol = np.linspace(0.0, 10.0, B).astype(np.float32)
    jd = jo.gated_decay(jnp.asarray(viol), 5.0)
    td = to.gated_decay(torch.as_tensor(viol), 5.0)
    _close(td, jd)
    js = jax.vmap(lambda a, d: jo.shift_al_state(a, 2, mu0=10.0, decay=d))(
        jal, jd)
    _al_close(to.shift_al_state(tal, 2, mu0=10.0, decay=td), js)


def test_squash_maps_round_trip():
    lb, ub = glider_config().control.bounds(7)
    js, ju = jo.make_squash_maps(lb, ub)
    ts, tu = to.make_squash_maps(lb, ub, device="cpu")
    u = np.random.default_rng(4).uniform(lb, ub, (B, 7)).astype(np.float32)
    _close(tu(torch.as_tensor(u)), ju(jnp.asarray(u)))
    _close(ts(tu(torch.as_tensor(u))), js(ju(jnp.asarray(u))))


def test_multistart_trim_on_the_reference_cloud():
    """Both packages from the start cloud the reference draws: 8 starts
    at 28 m/s, coordinated pick."""
    jp = jax_params("nn")
    key = jax.random.PRNGKey(0)
    j = jtrim.multistart_trim(jp, key, n_starts=8, target_airspeed=28.0,
                              prefer_coordinated=True)
    lb, ub = jtrim.default_trim_bounds()
    z0s = jnp.clip(jnp.asarray(ttrim.START_MID) + jnp.asarray(ttrim.START_SPREAD)
                   * jax.random.normal(key, (8, 12)), lb, ub)
    t = ttrim.multistart_trim(port_params(jp), torch.as_tensor(np.asarray(z0s)),
                              target_airspeed=28.0, prefer_coordinated=True)
    assert bool(t.converged) and bool(j.converged)
    # the trims form a flat valley (heading, and a sideslip-rudder trade
    # the com entries do not see), so the two solves may stop at different
    # points of it: hold the port's pick to being an equilibrium of the
    # reference's dynamics, at the reference's airspeed and glide angle
    from aircraft_tpu.dynamics import aircraft as jac

    xdot = np.asarray(jac.state_derivative(
        jp, jnp.asarray(t.state.numpy()), jnp.asarray(t.control.numpy())))
    assert np.linalg.norm(np.concatenate([xdot[3:6], xdot[10:13]])) < 1e-3
    vt, vj = t.state[3:6].numpy(), np.asarray(j.state)[3:6]
    assert np.linalg.norm(vt) == pytest.approx(np.linalg.norm(vj), abs=1e-2)
    gamma = lambda v: np.arctan2(v[2], np.hypot(v[0], v[1]))
    assert gamma(vt) == pytest.approx(gamma(vj), abs=5e-3)
