"""The port's exponential-map quaternion update and implicit-Euler step
against the JAX package on numpy-seeded flight states (the trained MLP
plant): each step, and its Jacobian in (x, u) by ``batched_jacfwd``
against JAX's ``jacfwd`` (through the three unrolled Newton iterations of
the implicit step, second derivatives of the plant included).  Then the
implicit step's own properties: the exact fixed point on ẋ = −a·x, a stiff
dt that stays finite and moves the aircraft, and ``make_step_fn``'s
routing.

Tolerance: rtol = atol = 2e-4, the rollout tolerance of
tests/test_kernels.py, for float32 single steps and their Jacobians.
dt = 0.01 (the headline window's): at dt = 0.05 and one substep three
Newton iterations leave some of these random states unconverged, where
one ulp decides the result.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax

from aircraft_tpu.solvers import integrators as jint

from aircraft_tpu_torch.config import glider_config
from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
from aircraft_tpu_torch.ops.autodiff import batched_jacfwd
from aircraft_tpu_torch.solvers import integrators as tint
from aircraft_tpu_torch.solvers.rollout import rollout

from test_torch_dynamics import _states
from torch_port_problem import jax_params, port_params

TOL = dict(rtol=2e-4, atol=2e-4)
DT = 0.01


@pytest.fixture(scope="module")
def plant():
    jp = jax_params("nn")
    return jp, port_params(jp)


SLOW = pytest.mark.slow


@pytest.mark.parametrize("integration,normalize,substeps,jac", [
    ("explicit", "expmap", 1, True), ("explicit", "expmap", 3, False),
    ("implicit", "step", 1, True), ("implicit", "expmap", 3, False),
    pytest.param("explicit", "expmap", 3, True, marks=SLOW),
    pytest.param("implicit", "expmap", 1, True, marks=SLOW),
    pytest.param("implicit", "step", 3, True, marks=SLOW),
    pytest.param("implicit", "expmap", 3, True, marks=SLOW)])
def test_step_and_jacobian(plant, integration, normalize, substeps, jac):
    """Each step against the reference's; with ``jac`` its Jacobian too.
    The reference's Jacobians cost 6-35 s of XLA compile each, so tier-1
    holds one per integrator at one substep and the rest are ``slow``."""
    jp, tp = plant
    x, u = _states(4)
    kw = dict(substeps=substeps, normalize=normalize, integration=integration)
    jstep = jint.make_step_fn(jp, **kw)
    tstep = tint.make_step_fn(tp, **kw)
    xt, ut = torch.as_tensor(x), torch.as_tensor(u)
    if jac:
        f = lambda a, b: (jstep(a, b, DT),) * 2
        (jx, ju), ref = jax.jit(jax.vmap(jax.jacfwd(
            f, argnums=(0, 1), has_aux=True)))(x, u)
        J = batched_jacfwd(lambda a, b: tstep(a, b, DT), xt, ut)
        assert J.dtype == torch.float32
        np.testing.assert_allclose(
            J.numpy(), np.concatenate([np.asarray(jx), np.asarray(ju)], -1),
            **TOL)
    else:
        ref = jax.jit(jax.vmap(lambda a, b: jstep(a, b, DT)))(x, u)
    out = tstep(xt, ut, DT)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    if normalize == "expmap":
        np.testing.assert_allclose(
            torch.linalg.norm(out[:, 6:10], dim=-1).numpy(), 1.0, atol=1e-6)


def test_implicit_linear_decay_exact():
    """On ẋ = −a x the implicit fixed point is x/(1 + a dt); per substep,
    with a dt per row."""
    a = 5.0
    f = lambda x, u: -a * x
    x0 = torch.ones(4, 3)
    x1 = tint.implicit_euler_step(f, x0, torch.zeros(4, 1), 0.05,
                                  newton_iters=8)
    np.testing.assert_allclose(x1.numpy(), 1.0 / (1 + a * 0.05), rtol=1e-5)
    dts = torch.tensor([0.01, 0.02, 0.05, 0.1])
    x3 = tint.step_implicit(None, x0, torch.zeros(4, 1), dts, substeps=3,
                            derivative_fn=f)
    want = (1.0 / (1.0 + a * dts.numpy() / 3.0)) ** 3
    np.testing.assert_allclose(x3.numpy(), np.repeat(want[:, None], 3, 1),
                               rtol=1e-5)


def test_implicit_stable_and_advances_at_stiff_dt():
    """At dt = 0.05 a fixed-point iteration diverges on the stiff
    rotational modes (|eig| up to ~100 s⁻¹); the Newton solve stays
    finite, bounded, and moves the aircraft."""
    params = AircraftParams.from_config(glider_config().aircraft,
                                        device="cpu")
    step = tint.make_step_fn(params, substeps=1, normalize="step",
                             integration="implicit")
    x0 = torch.tensor([0, 0, -200, 50, 0, 0, 0, 0, 0, 1, 0, 0, 0],
                      dtype=torch.float32)
    xs = rollout(step, x0, torch.zeros(40, 7), 0.05).numpy()
    assert np.all(np.isfinite(xs))
    assert np.abs(xs).max() < 1e4
    moved = np.linalg.norm(xs[-1, :3] - xs[0, :3])
    assert moved > 50.0, moved     # 2 s of ~50 m/s flight, not a freeze


def test_make_step_fn_routes(plant, monkeypatch):
    _, tp = plant
    x, u = map(torch.as_tensor, _states(5))
    calls = []
    real = tint.implicit_euler_step

    def spy(*a, **k):
        calls.append(k["newton_iters"])
        return real(*a, **k)

    monkeypatch.setattr(tint, "implicit_euler_step", spy)
    implicit = tint.make_step_fn(tp, substeps=2, normalize="step",
                                 integration="implicit")
    assert torch.equal(implicit(x, u, DT),
                       tint.step_implicit(tp, x, u, DT, substeps=2,
                                          normalize="step"))
    assert calls == [3] * 4
    calls.clear()
    explicit = tint.make_step_fn(tp, substeps=2, normalize="expmap")
    assert torch.equal(explicit(x, u, DT),
                       tint.step(tp, x, u, DT, substeps=2, normalize="expmap"))
    assert not calls
    # one state, no batch axis
    assert implicit(x[0], u[0], DT).shape == (13,)
    for kw in (dict(integration="rk2"), dict(normalize="exp")):
        with pytest.raises(ValueError):
            tint.make_step_fn(tp, **kw)
