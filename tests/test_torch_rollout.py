"""The port's rollouts against the TPU rollout kernels in Pallas interpret
mode: the rollout kernel's wrapper (its plain version on the CPU) and
``solvers/rollout.batch_rollout`` of the integrator's step, against
``make_fused_rollout`` (B=128, N=8, 2 substeps, as tests/test_kernels.py)
and ``make_fused_rollout_tiles`` (group=1: one 128-lane tile, N=4).

The plant is tests/test_kernels.py's ``make_params`` (the MLP from
``PRNGKey(0)`` with scalers set), carried into the port through numpy and
``mlp_from_numpy``.  Held at rtol = atol = 2e-4, as there.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax.numpy as jnp

from aircraft_tpu.config import glider_config as jax_glider_config
from aircraft_tpu.kernels import make_fused_rollout as jax_fused_rollout
from aircraft_tpu.kernels import make_fused_rollout_tiles as jax_fused_tiles

from aircraft_tpu_torch.dynamics.coefficients import DefaultCoeffParams
from aircraft_tpu_torch.kernels import rollout as krollout
from aircraft_tpu_torch.solvers import integrators
from aircraft_tpu_torch.solvers import rollout as trollout

from test_kernels import make_params
from torch_port_problem import port_params

TOL = dict(rtol=2e-4, atol=2e-4)
DT = 0.01


def inputs(B, N, seed):
    """tests/test_kernels.py's inputs: the configured initial state with
    perturbed velocity and attitude, uniform controls, thrust zero."""
    rng = np.random.default_rng(seed)
    x0 = np.tile(np.asarray(jax_glider_config().waypoints.initial_state,
                            np.float32)[None], (B, 1))
    x0[:, 3:6] += rng.normal(0, 1, (B, 3)).astype(np.float32)
    q = x0[:, 6:10] + 0.05 * rng.normal(0, 1, (B, 4)).astype(np.float32)
    x0[:, 6:10] = q / np.linalg.norm(q, axis=1, keepdims=True)
    us = rng.uniform(-1, 1, (B, N, 7)).astype(np.float32)
    us[:, :, 3:6] = 0.0
    return x0, us


@pytest.fixture(scope="module")
def params():
    jp = make_params()
    return jp, port_params(jp)


@pytest.mark.parametrize("layout", ["lanes", "tiles"])
def test_rollout_matches_pallas_kernel(params, layout):
    jp, tp = params
    N, ss = (8, 2) if layout == "lanes" else (4, 2)
    x0, us = inputs(128, N, seed=3 if layout == "lanes" else 5)
    if layout == "lanes":
        ref = jax_fused_rollout(jp, horizon=N, dt=DT, substeps=ss,
                                interpret=True)
        port = krollout.make_fused_rollout(tp, horizon=N, dt=DT, substeps=ss)
    else:
        ref = jax_fused_tiles(jp, horizon=N, dt=DT, substeps=ss, group=1,
                              interpret=True)
        port = krollout.make_fused_rollout_tiles(tp, horizon=N, dt=DT,
                                                 substeps=ss, group=1)
    xs_ref = np.asarray(ref(jnp.asarray(x0), jnp.asarray(us)))
    krollout.reset_launch_counts()
    xs = port(torch.as_tensor(x0), torch.as_tensor(us)).numpy()
    assert krollout.fused_rollout.launches == 0     # CPU: plain version
    step = integrators.make_step_fn(tp, substeps=ss, normalize="step")
    xs_b = trollout.batch_rollout(step, torch.as_tensor(x0),
                                  torch.as_tensor(us), DT).numpy()
    assert xs.shape == xs_b.shape == xs_ref.shape == (128, N + 1, 13)
    np.testing.assert_allclose(xs, xs_ref, **TOL)
    np.testing.assert_allclose(xs_b, xs_ref, **TOL)


def test_closed_loop_and_linearisation_agree_with_rollout(params):
    """Zero gains reduce the closed loop to the open loop; the Jacobians
    of linearize_along match finite differences of the step."""
    _, tp = params
    N, ss = 3, 2
    x0, us = (torch.as_tensor(t) for t in inputs(4, N, seed=7))
    step = integrators.make_step_fn(tp, substeps=ss, normalize="step")
    xs = trollout.rollout(step, x0, us, DT)
    xs_c, us_c = trollout.closed_loop_rollout(
        step, x0, us, xs, (torch.zeros(4, N, 7, 13), torch.ones(4, N, 7)), DT,
        alpha=0.0)
    np.testing.assert_array_equal(xs_c.numpy(), xs.numpy())
    np.testing.assert_array_equal(us_c.numpy(), us.numpy())
    A, Bm = trollout.linearize_along(step, xs, us, DT)
    assert A.shape == (4, N, 13, 13) and Bm.shape == (4, N, 13, 7)
    h = 1e-3
    e = torch.zeros(13)
    e[4] = h
    fd = (step(xs[:, 1] + e, us[:, 1], DT) - step(xs[:, 1] - e, us[:, 1], DT)) / (2 * h)
    np.testing.assert_allclose(A[:, 1, :, 4].numpy(), fd.numpy(), rtol=1e-2,
                               atol=1e-2)


def test_rollout_kernel_takes_the_mlp_model_only(params):
    _, tp = params
    import dataclasses

    with pytest.raises(NotImplementedError):
        krollout.make_fused_rollout(
            dataclasses.replace(tp, coeff=DefaultCoeffParams()), horizon=2,
            dt=DT)


def test_wrapper_checks_shapes(params):
    _, tp = params
    roll = krollout.make_fused_rollout(tp, horizon=3, dt=DT)
    with pytest.raises(ValueError):
        roll(torch.zeros(2, 13), torch.zeros(2, 4, 7))
