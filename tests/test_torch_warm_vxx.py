"""Where the warm mode's value Hessian turns indefinite, held against the
reference on the inputs the card saved.

``warm_fallbacks.py`` on the H100 (``bench --mode warm --cuda-chol``,
B=256, 2 x 6, two warm windows) found every Cholesky fallback in one
glider's second warm window, and its Vxx indefinite from knot 21 of that
pass on.  ``tests/data/warm_vxx_indefinite.npz`` holds that glider and
its 7 neighbours there: the window's inputs, the expansion point (xs,
us, the AL state, reg) and the sweep's inputs as the solver handed them
over.  On them (``warm_vxx_crossing.hold``):

* the port's sequential sweep and the reference's
  (``aircraft_tpu/solvers/riccati.py::backward_sequential``) turn
  indefinite at the card's knot, their Vxx within 1e-5 of each other
  (of 1 + max |Vxx|) at every knot up to it;
* at that knot each package's own Gauss-Newton lxx is positive
  semidefinite to rounding but has entries above 1e8, and the
  elementwise clamp at 1e8 both apply to the expansion
  (``aircraft_tpu/solvers/ilqr.py:359-361``) makes it indefinite; on the
  unclamped expansion neither sweep turns indefinite.

So the indefinite Vxx, and the fallbacks downstream of it, are the
reference's own rule, not a fault of the port.
"""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: F401  (the reference side runs on the CPU)

import warm_fallbacks
import warm_vxx_crossing

DATA = os.path.join(HERE, "data", "warm_vxx_indefinite.npz")


@pytest.fixture(scope="module")
def held():
    return warm_vxx_crossing.hold(DATA)


def test_both_sweeps_turn_indefinite_at_the_cards_knot(held):
    onset = held["onset"]
    assert onset["card"] >= 0
    assert onset["port"] == onset["reference"] == onset["card"]
    assert held["vxx_parts_up_to_onset"] < 1e-5
    for ratio in held["ratio_at_onset"].values():
        assert ratio < -warm_fallbacks.INDEF_TOL


def test_the_expansion_clamp_makes_lxx_indefinite_in_both(held):
    tol = warm_fallbacks.INDEF_TOL
    for pkg in ("reference", "port"):
        e = held["expansion_at_onset"][pkg]
        assert e["entries_above_1e8"] > 0, pkg
        assert e["lxx_ratio_unclipped"] > -tol, pkg
        assert e["lxx_ratio_clipped"] < -tol, pkg
    assert held["expansion_at_onset"]["port_vs_reference_lxx"] < 1e-3
    assert set(held["onset_without_the_1e8_clamp"].values()) == {-1}
