"""The port's six aerodynamic coefficient models against the JAX package's:

* each model through ``apply_coefficients`` and ``state_derivative``, on
  flight states with reversed flow, negative angles and surfaces and one
  state whose flow and surfaces are all exactly zero; and the state
  derivative's Jacobian by ``batched_jacfwd``;
* the polynomial's monomials are products of gathered factors, so their
  forward-mode derivative is finite at zero inputs.  The reference's
  ``x ** e`` takes 0 · 0⁻¹ = NaN there (pow's JVP at a zero input with a
  zero exponent), which makes every Jacobian of its polynomial plant NaN:
  the wing-asymmetry rows always carry zero inputs.  The port's
  polynomial Jacobian is held against the reference's at negative inputs,
  at zero inputs against the reference's at the nearest nonzero input
  (1e-30; a polynomial's Jacobian is continuous), and the plant's
  Jacobian against central differences of the reference's plant in
  float64;
* every loader on the repo's artifacts (bit-equal arrays), the reference
  ``.pth`` checkpoint layout on a file the test writes, the Taylor
  expansion (value and Jacobian), ``raw_forward`` refusing the
  polynomial, ``AircraftParams.from_numpy`` carrying each model, and the
  window kernels' coefficient guard: any model but the MLP and the
  default takes ``ilqr.solve_batch`` in ``MHTT``.

Tolerance: rtol = atol = 2e-4, as tests/test_torch_dynamics.py.
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
from aircraft_tpu.dynamics import aircraft as jac
from aircraft_tpu.dynamics import coefficients as jc

from aircraft_tpu_torch.config import glider_config
from aircraft_tpu_torch.dynamics import aircraft as tac
from aircraft_tpu_torch.dynamics import coefficients as tc
from aircraft_tpu_torch.ops.autodiff import batched_jacfwd

from test_torch_dynamics import _states
from torch_port_problem import PARAM_KEYS

TOL = dict(rtol=2e-4, atol=2e-4)
ANCHOR = [1200.0, 0.05, -0.02, 0.5, -1.0]
MODELS = ("default", "linear", "poly", "nn", "nn_mini", "nn_taylor")


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def _mlp_arrays(cp):
    return {k: np.asarray(getattr(cp, k)) for k in tc.MLP_KEYS}


def _port_coeff(kind, jcp):
    """The port's copy of the reference's coefficient params."""
    if kind == "default":
        return tc.DefaultCoeffParams()
    if kind == "linear":
        return tc.linear_from_numpy({"matrix": np.asarray(jcp.matrix),
                                     "Cn_rudder": jcp.Cn_rudder}, "cpu")
    if kind == "poly":
        return tc.poly_from_numpy({
            "weights": np.asarray(jcp.weights),
            "intercept": np.asarray(jcp.intercept),
            "input_scale": np.asarray(jcp.input_scale),
            "span_over_4": jcp.span_over_4, "Cn_rudder": jcp.Cn_rudder}, "cpu")
    if kind == "nn":
        return tc.mlp_from_numpy({**_mlp_arrays(jcp),
                                  "Cn_rudder": float(jcp.Cn_rudder)}, "cpu")
    if kind == "nn_mini":
        return tc.mini_mlp_from_numpy(_mlp_arrays(jcp), "cpu")
    return tc.taylor_from_numpy({k: np.asarray(getattr(jcp, k))
                                 for k in ("anchor", "value", "jac")}, "cpu")


@pytest.fixture(scope="module")
def models():
    """{kind: (reference params, port params)} built from the reference's
    artifacts and draws."""
    jmodels = {
        "default": jc.DefaultCoeffParams(),
        "linear": jc.default_artifact_coeff("linear"),
        "poly": jc.default_artifact_coeff("poly"),
        "nn": jc.default_nn_coeff(),
        "nn_mini": jc.MiniMLPCoeffParams.init(jax.random.PRNGKey(3)),
    }
    jmodels["nn_taylor"] = jc.TaylorCoeffParams.from_model(
        jmodels["nn"], jnp.asarray(ANCHOR))
    return {k: (v, _port_coeff(k, v)) for k, v in jmodels.items()}


def _plants(jcp, tcp):
    jp = jac.AircraftParams.from_config(jax_glider_config().aircraft,
                                        coeff=jcp)
    arrays = {k: np.asarray(getattr(jp, k)) for k in PARAM_KEYS}
    arrays["epsilon"] = float(jp.epsilon)
    return jp, tac.AircraftParams.from_numpy(arrays, coeff=tcp, device="cpu")


def _inputs():
    """Flight states with negative angles, surfaces and reversed flow; the
    first state has zero velocity, rates and surfaces."""
    x, u = _states(6)
    u[:, :3] = np.where(np.arange(len(u))[:, None] % 2 == 0, -1.0, 1.0) \
        * np.abs(u[:, :3])
    x[0, 3:6] = 0.0
    x[0, 10:13] = 0.0
    u[0] = 0.0
    return x, u


@pytest.mark.parametrize("kind", MODELS)
def test_model_and_plant(models, kind):
    jcp, tcp = models[kind]
    x, u = _inputs()
    jp, tp = _plants(jcp, tcp)
    ja = jac.aero_state(jp, jnp.asarray(x), jnp.asarray(u))
    ta = tac.aero_state(tp, torch.as_tensor(x), torch.as_tensor(u))
    _close(tc.apply_coefficients(tcp, ta, *torch.as_tensor(u[:, :3]).T),
           jc.apply_coefficients(jcp, ja, *jnp.asarray(u[:, :3]).T))
    _close(tac.state_derivative(tp, torch.as_tensor(x), torch.as_tensor(u)),
           jax.vmap(lambda a, b: jac.state_derivative(jp, a, b))(x, u))
    J = batched_jacfwd(lambda a, b: tac.state_derivative(tp, a, b),
                       torch.as_tensor(x), torch.as_tensor(u))
    assert J.dtype == torch.float32 and bool(torch.isfinite(J).all())
    jx, ju = jax.jit(jax.vmap(jax.jacfwd(
        lambda a, b: jac.state_derivative(jp, a, b), argnums=(0, 1))))(x, u)
    ref = np.concatenate([np.asarray(jx), np.asarray(ju)], -1)
    if kind != "poly":
        _close(J, ref)
        return
    # the reference's polynomial plant has a NaN Jacobian at every state
    assert not np.isfinite(ref).reshape(len(x), -1).all(axis=1).any()
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64)
            if isinstance(a, (jax.Array, np.ndarray))
            and jnp.issubdtype(a.dtype, jnp.floating) else a, jp)
        f = jax.jit(jax.vmap(lambda a, b: jac.state_derivative(p64, a, b)))
        z = np.concatenate([x, u], axis=1).astype(np.float64)
        h = 1e-4 * np.maximum(1.0, np.abs(z))
        cols = []
        for i in range(z.shape[1]):
            e = np.zeros_like(z)
            e[:, i] = h[:, i]
            hi, lo = z + e, z - e
            cols.append((np.asarray(f(hi[:, :13], hi[:, 13:]))
                         - np.asarray(f(lo[:, :13], lo[:, 13:])))
                        / (2 * h[:, i:i + 1]))
    fd = np.stack(cols, axis=-1)
    np.testing.assert_allclose(J.numpy(), fd, rtol=2e-4,
                               atol=2e-4 * (1.0 + np.abs(fd).max()))


def test_poly_jacobian_at_negative_and_zero_inputs(models):
    jcp, tcp = models["poly"]
    rows = np.array([[1000.0, -0.1, -0.05, -3.0, 2.0],
                     [800.0, -0.2, 0.1, 4.0, -5.0],
                     [0.0, 0.0, 0.0, 0.0, 0.0],
                     [1000.0, 0.0, -0.05, 0.0, 2.0],
                     [0.0, -0.1, 0.0, -3.0, 0.0]], np.float32)
    J = batched_jacfwd(lambda v: tc._poly_eval(tcp, v), torch.as_tensor(rows))
    assert bool(torch.isfinite(J).all())
    jfn = jax.jit(jax.vmap(jax.jacfwd(lambda v: jc._poly_eval(jcp, v))))
    ref = np.asarray(jfn(rows))
    neg = ~(rows == 0.0).any(axis=1)
    _close(J[neg], ref[neg])
    assert not np.isfinite(ref[~neg]).all()      # the reference's 0 · 0⁻¹
    nudged = np.where(rows == 0.0, np.float32(1e-30), rows)
    _close(J[~neg], np.asarray(jfn(nudged))[~neg])
    _close(tc._poly_eval(tcp, torch.as_tensor(rows)),
           jc._poly_eval(jcp, jnp.asarray(rows)))


def test_loaders_read_the_artifacts_bit_for_bit(models):
    for kind, keys in (("linear", ("matrix",)),
                       ("poly", ("weights", "intercept", "input_scale")),
                       ("nn", tc.MLP_KEYS)):
        jcp = jc.default_artifact_coeff(kind)
        for tcp in (tc.default_artifact_coeff(kind, device="cpu"),
                    tc.load_coefficient_model(
                        kind, tc.NETWORKPATH / {
                            "linear": "linearised.csv", "poly": "poly.npz",
                            "nn": "mlp.npz"}[kind], device="cpu")):
            assert type(tcp).__name__ == type(jcp).__name__
            for k in keys:
                assert np.array_equal(getattr(tcp, k).numpy(),
                                      np.asarray(getattr(jcp, k))), (kind, k)
            assert float(tcp.Cn_rudder) == pytest.approx(float(jcp.Cn_rudder))
    assert tc.default_artifact_coeff("poly", "cpu").span_over_4 == \
        jc.default_artifact_coeff("poly").span_over_4
    assert tc.load_coefficient_model("default") == tc.DefaultCoeffParams()
    assert tc.default_artifact_coeff("default") == tc.DefaultCoeffParams()
    with pytest.raises(ValueError):
        tc.load_coefficient_model("cfd", device="cpu")
    assert set(tc.COEFF_MODEL_REGISTRY) == set(jc.COEFF_MODEL_REGISTRY)
    assert np.array_equal(tc.polynomial_exponents(5, 3),
                          jc.polynomial_exponents(5, 3))


def test_random_fallback_of_the_nn_model(tmp_path):
    """Without ``mlp.npz`` the 'nn' model is a random MLP with the
    reference's scalers (drawn from a torch.Generator, so only the shapes
    and scalers match the reference's jax.random draw)."""
    tcp = tc.default_nn_coeff(tmp_path / "absent.npz", device="cpu")
    jcp = jc.default_nn_coeff(tmp_path / "absent.npz")
    for k in tc.MLP_KEYS:
        assert tuple(getattr(tcp, k).shape) == np.shape(getattr(jcp, k))
    for k in ("input_mean", "input_std", "output_mean", "output_std"):
        assert np.array_equal(getattr(tcp, k).numpy(),
                              np.asarray(getattr(jcp, k), np.float32))
    again = tc.default_nn_coeff(tmp_path / "absent.npz", device="cpu")
    assert torch.equal(tcp.w1, again.w1)              # seeded
    mini = tc.MiniMLPCoeffParams.init(torch.Generator().manual_seed(1),
                                      device="cpu")
    bound = 0.5 / np.sqrt(16)
    assert float(mini.w1.abs().max()) <= bound and mini.w2.shape == (32, 6)


def test_torch_checkpoint_layout(tmp_path):
    rng = np.random.default_rng(7)
    t = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(np.float32))
    ckpt = {"model_state_dict": {
        "core_layers.0.weight": t(16, 5), "core_layers.0.bias": t(16),
        "core_layers.1.weight": t(32, 16), "core_layers.1.bias": t(32),
        "core_layers.3.weight": t(6, 32), "core_layers.3.bias": t(6)},
        "input_mean": t(5), "input_std": t(5).abs() + 0.5,
        "output_mean": t(6), "output_std": t(6).abs() + 0.5}
    path = tmp_path / "model-dynamics.pth"
    torch.save(ckpt, path)
    jcp = jc.load_coefficient_model("nn", str(path))
    tcp = tc.load_coefficient_model("nn", path, device="cpu")
    assert isinstance(tcp, tc.MLPCoeffParams)
    for k in tc.MLP_KEYS:
        assert np.array_equal(getattr(tcp, k).numpy(),
                              np.asarray(getattr(jcp, k))), k


def test_taylor_expansion_and_raw_forward(models):
    x = np.array([[1100.0, 0.1, 0.01, -1.0, 2.0],
                  [1300.0, -0.05, -0.03, 1.0, -2.0]], np.float32)
    for kind in ("nn", "nn_mini", "linear"):
        jcp, tcp = models[kind]
        jt = jc.TaylorCoeffParams.from_model(jcp, jnp.asarray(ANCHOR))
        tt = tc.TaylorCoeffParams.from_model(tcp, ANCHOR)
        _close(tt.value, jt.value)
        _close(tt.jac, jt.jac)
        assert tt.Cn_rudder == pytest.approx(float(jt.Cn_rudder))
        _close(tc.raw_forward(tcp, torch.as_tensor(x)),
               jc.raw_forward(jcp, jnp.asarray(x)))
        _close(tc._taylor_eval(tt, torch.as_tensor(x)),
               jc._taylor_eval(jt, jnp.asarray(x)))
    for mod, cp in ((jc, models["poly"][0]), (tc, models["poly"][1])):
        with pytest.raises(TypeError):
            mod.raw_forward(cp, x)
    with pytest.raises(TypeError):
        tc.apply_coefficients(object(), None, None, None, None)


@pytest.mark.parametrize("kind", MODELS)
def test_aircraft_params_carry_each_model(models, kind):
    _, tcp = models[kind]
    _, tp = _plants(models[kind][0], tcp)
    assert type(tp.coeff) is type(tcp)
    moved = tp.to("meta")
    tensors = [f for f in vars(tcp) if isinstance(getattr(tcp, f),
                                                  torch.Tensor)]
    assert all(getattr(moved.coeff, f).device.type == "meta"
               for f in tensors)
    assert type(moved.coeff) is type(tcp)


def test_kernels_take_the_mlp_and_default_only(models, monkeypatch):
    from aircraft_tpu_torch.control.initialisation import DubinsInitialiser
    from aircraft_tpu_torch.control.mhtt import MHTT
    from aircraft_tpu_torch.config import SolverConfig
    from aircraft_tpu_torch.kernels.window import kernel_coeff_supported
    from aircraft_tpu_torch.solvers import ilqr

    for kind in MODELS:
        _, tp = _plants(*models[kind])
        assert kernel_coeff_supported(tp) == (kind in ("nn", "default"))
    _, tp = _plants(*models["poly"])
    cfg = glider_config()
    track = DubinsInitialiser(cfg)
    budget = SolverConfig(max_al_iters=1, max_inner_iters=1,
                          hessian="gauss_newton", line_search_steps=3)
    with pytest.raises(NotImplementedError):
        MHTT(tp, cfg, track, num_nodes=4, overlap=2, solver_config=budget,
             fused=True, device="cpu")
    m = MHTT(tp, cfg, track, num_nodes=4, overlap=2, solver_config=budget,
             device="cpu")
    assert not m.fused
    calls = []
    real = ilqr.solve_batch
    monkeypatch.setattr(ilqr, "solve_batch",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x0 = np.asarray(cfg.waypoints.initial_state, np.float32)
    z0 = torch.as_tensor(np.concatenate([x0, [0.0]]).astype(np.float32))
    z, _, _, _ = m._serve_step(z0, torch.zeros(4, 7), m._al0)
    assert calls == [1] and bool(torch.isfinite(z).all())
