"""The port's 3D Dubins length bounds and pitch-clamped vertical profiles
against the JAX package's (both plain numpy) on seeded endpoints, the
reference scenarios, and the cases where a bound is inf or 0.0 or no
vertical profile exists.

Tolerance: 1e-9 absolute and relative (the same float64 arithmetic).
"""

import numpy as np
import pytest

from aircraft_tpu.dubins import dubins3d as jd
from aircraft_tpu.dubins import vertical as jv

from aircraft_tpu_torch.dubins import dubins3d as td
from aircraft_tpu_torch.dubins import vertical as tv

TOL = dict(rtol=1e-9, atol=1e-9)


def _seeded(n=24, seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        qi = np.array([0, 0, rng.uniform(-20, 20), rng.uniform(-np.pi, np.pi),
                       rng.uniform(-0.2, 0.2)])
        qf = np.array([rng.uniform(-900, 900), rng.uniform(-400, 400),
                       rng.uniform(-80, 80), rng.uniform(-np.pi, np.pi),
                       rng.uniform(-0.2, 0.2)])
        out.append((qi, qf, rng.uniform(5.0, 60.0)))
    return out


PITCHES = [(-np.pi / 4, np.pi / 2), (-np.deg2rad(20), np.deg2rad(20)),
           (-np.deg2rad(10), np.deg2rad(15))]

SPECIAL = [
    # upper bound inf: endpoints within 4·√2·rho
    (np.array([0, 0, 0, 0, 0.0]), np.array([10.0, 0, 0, 0, 0.0]), 40.0),
    # a long straight transfer: both bounds near the distance
    (np.array([0, 0, 0, 0, 0.0]), np.array([2000.0, 0, 0, 0, 0.0]), 40.0),
    # a very steep transfer: the clamped vertical profile
    (np.array([0, 0, 0, 0, 0.0]), np.array([60.0, 10.0, 55.0, 0.5, 0.0]), 20.0),
    # start climb angle outside every envelope below: lower bound 0.0
    (np.array([0, 0, 0, 0, 1.2]), np.array([30.0, 5.0, 60.0, 0.3, 0.0]), 20.0),
    # reference scenarios (short hops, steep ends)
    (np.array([0, 0, 0, 0, 0.0]), np.array([10, 10, 5, np.pi / 2, np.pi / 6]), 2.0),
    (np.array([0, 0, 0, np.pi / 4, 0.2]), np.array([6, -4, -9, 3.0, -0.3]), 1.5),
    (np.array([0, 0, 2, 0, 0.0]), np.array([6, 4, 2, np.pi, 0.0]), 1.0),
]


def _bounds(mod, qi, qf, rho, pitch):
    return mod.lower_bound(qi, qf, rho, pitch), mod.upper_bound(qi, qf, rho,
                                                                pitch)


@pytest.mark.parametrize("pitch", PITCHES, ids=["default", "pm20", "asym"])
def test_bounds_match_on_seeded_endpoints(pitch):
    for qi, qf, rho in _seeded():
        np.testing.assert_allclose(_bounds(td, qi, qf, rho, pitch),
                                   _bounds(jd, qi, qf, rho, pitch), **TOL)


@pytest.mark.parametrize("case", range(len(SPECIAL)))
@pytest.mark.parametrize("pitch", PITCHES, ids=["default", "pm20", "asym"])
def test_bounds_match_on_special_cases(case, pitch):
    qi, qf, rho = SPECIAL[case]
    got, want = _bounds(td, qi, qf, rho, pitch), _bounds(jd, qi, qf, rho, pitch)
    np.testing.assert_allclose(got, want, **TOL)


def test_the_inf_and_zero_cases_are_reached():
    qi, qf, rho = SPECIAL[0]
    assert td.upper_bound(qi, qf, rho) == float("inf") == jd.upper_bound(
        qi, qf, rho)
    qi, qf, rho = SPECIAL[3]
    pitch = PITCHES[1]
    assert td.lower_bound(qi, qf, rho, pitch) == 0.0 == jd.lower_bound(
        qi, qf, rho, pitch)
    assert td.upper_bound(qi, qf, rho, pitch) == float("inf")


VERTICAL = [
    ([0.0, 0.0, 0.0], [100.0, 10.0, 0.0], 30.0, (-np.deg2rad(20), np.deg2rad(20))),
    ([0.0, 0.0, 0.0], [40.0, 30.0, 0.0], 20.0, (-np.deg2rad(15), np.deg2rad(15))),
    ([0.0, 5.0, 0.1], [80.0, -30.0, -0.1], 15.0, (-np.deg2rad(15), np.deg2rad(15))),
    ([0.0, 0.0, 0.0], [50.0, -45.0, 0.0], 10.0, (-np.deg2rad(30), np.deg2rad(10))),
    ([0.0, 0.0, 0.0], [50.0, 0.0, 0.0], 10.0, (0.0, np.deg2rad(10))),
    ([0.0, 0.0, 0.5], [50.0, 10.0, 0.0], 10.0, (-0.2, 0.2)),   # None
]


def _profile_fields(m):
    if m is None:
        return None
    return (np.array([m.r, m.theta, *m.sweeps, m.straight, m.length]),
            m.exact, m.sample_many(17))


@pytest.mark.parametrize("case", range(len(VERTICAL)))
def test_vertical_profile_matches(case):
    qi, qf, r, lims = VERTICAL[case]
    got = _profile_fields(tv.vertical_profile(qi, qf, r, lims))
    want = _profile_fields(jv.vertical_profile(qi, qf, r, lims))
    assert (got is None) == (want is None)
    if want is None:
        assert case == len(VERTICAL) - 1
        return
    np.testing.assert_allclose(got[0], want[0], **TOL)
    assert got[1] == want[1]
    np.testing.assert_allclose(got[2], want[2], **TOL)


def test_vertical_profile_seeded_thetas():
    rng = np.random.default_rng(3)
    for _ in range(40):
        qi = np.array([0.0, rng.uniform(-10, 10), rng.uniform(-0.3, 0.3)])
        qf = np.array([rng.uniform(20, 200), rng.uniform(-60, 60),
                       rng.uniform(-0.3, 0.3)])
        theta = rng.uniform(-0.5, 0.5)
        r = rng.uniform(5, 40)
        got = _profile_fields(tv._csc_at_theta(qi, qf, r, theta))
        want = _profile_fields(jv._csc_at_theta(qi, qf, r, theta))
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_allclose(got[0], want[0], **TOL)
            assert got[1] == want[1]
            np.testing.assert_allclose(got[2], want[2], **TOL)
