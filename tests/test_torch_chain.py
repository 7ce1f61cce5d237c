"""The port's headline serving chain against the reference's, chained:
the first two windows of the fused chain (``bench.headline_chain``, the
window kernels' plain versions on the CPU) and of the reference bench's
chain (``ilqr.solve_batch``, what it runs off the TPU), from the same
fleet of 8 gliders along the course track, the same trim controls and
the headline budget (3 AL x 12 inner, row penalty, 6 step sizes, commit
20, reset at 5.0).

The set-up is the reference's (``chain_crossing.REFERENCE_GLIDE`` and
``REFERENCE_TRIM_CONTROL``, as ``chain_crossing.py --arm setup`` finds them):
its best glide for ``data/networks/mlp.npz`` (32 m/s, the track laid out
at 90% of L/D 10.4938) and its fleet trim's controls; the stations are
every 32nd of the 256-glider fleet.  ``chain_crossing.py`` runs the 10-window
crossing of both set-ups with both packages' solvers.

Tolerance: population level, per window, mean cost within 5% and mean
violation within 0.3·(1 + v) (``tests/test_window_kernel.py:171-195``).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chain_crossing as cc

from aircraft_tpu.solvers import ocp as jocp

from aircraft_tpu_torch import bench
from aircraft_tpu_torch.config import glider_config
from aircraft_tpu_torch.control.course import course_track
from aircraft_tpu_torch.solvers import ocp as tocp

REF_GLIDE = cc.REFERENCE_GLIDE
REF_TRIM_CONTROL = np.array(cc.REFERENCE_TRIM_CONTROL, np.float32)
WINDOWS = 2


def _stations():
    v_ref, glide_ld = REF_GLIDE
    track = course_track(glider_config(), v_ref=v_ref, glide_ld=glide_ld)
    track.track_points = track.track_points.clone()
    track.track_points[:, 2] -= max(
        0.0, float(track.track_points[:, 2].max()) + 20.0)
    return bench.fleet_rows(track, cc.FLEET, v_ref)[::32]


def test_first_two_chained_windows():
    z0s = _stations()
    assert z0s.shape == (8, 14)
    ref = cc.reference_chain(*REF_GLIDE, z0s, REF_TRIM_CONTROL, WINDOWS)
    port = cc.port_chain(*REF_GLIDE, z0s, REF_TRIM_CONTROL, WINDOWS, "fused")
    for r, q in zip(port, ref):
        assert np.isfinite(r["cost"]).all()
        assert r["mean_cost"] == pytest.approx(q["mean_cost"], rel=0.05), (
            r["window"], r["mean_cost"], q["mean_cost"])
        assert abs(r["mean_violation"] - q["mean_violation"]) <= 0.3 * (
            1.0 + q["mean_violation"])
    assert cc.tracks(port, ref) == [True] * WINDOWS


def test_squash_saturates_as_the_reference():
    """The control squash u = mid + half·tanh(w) and its slope against the
    reference's at pre-images where a chained window leaves saturated
    channels: the reference's float32 tanh is exactly ±1 with zero slope
    from |w| = 7.9989, and the port's must be too.  (A slope of 1e-7 left
    there is what the Riccati step divided by its ~1e-6 regulariser,
    swinging the flap channel from bound to bound: from the reference's
    own carry into window 1, 15 of 32 gliders' costs parted by up to 5.7%,
    ``chain_crossing.py --arm same-port-ilqr@ref``.)"""
    lb = np.array([-5.0, -5.0, -5.0, 0.0, 0.0, 0.0, 0.0], np.float32)
    ub = np.array([5.0, 5.0, 5.0, 0.0, 0.0, 0.0, 1.0], np.float32)
    w = np.array([[0.3, -2.0, 7.5, 0.0, 0.0, 0.0, 7.9],
                  [8.0, -8.5, 9.0, 1.0, 1.0, 1.0, 8.7],
                  [-7.9988, 7.9989, -9.3, 0.0, 0.0, 0.0, -12.0]],
                 np.float32)
    jsq, _ = jocp.make_squash_maps(lb, ub)
    tsq, _ = tocp.make_squash_maps(lb, ub, device="cpu")
    ones = np.ones_like(w)
    ju, jdu = jax.vmap(lambda r, t: jax.jvp(jsq, (r,), (t,)))(
        jnp.asarray(w), jnp.asarray(ones))
    tu, tdu = torch.func.jvp(tsq, (torch.as_tensor(w),),
                             (torch.as_tensor(ones),))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-6,
                               atol=1e-6)
    flat = np.asarray(jdu) == 0.0
    assert flat[1].all() and flat[2, 1:].all()
    np.testing.assert_array_equal(tdu.numpy()[flat], 0.0)
    # elsewhere the slopes agree to the two tanh's last-bit differences
    np.testing.assert_allclose(tdu.numpy(), np.asarray(jdu), rtol=1e-5,
                               atol=1e-6)
