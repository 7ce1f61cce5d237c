"""The port's surrogate fitting, training, preprocessing and checkpoint IO
against the JAX package's, on inputs made by numpy from a seed.

Tolerances: the closed-form fits and the preprocessing are the same
float64 numpy arithmetic (exact, or 1e-6 through each package's
evaluation in float32); the weighted losses 1e-6 relative; one
``train_mlp`` step from the same (JAX-drawn) initial weights and batch at
1e-5 relative, three epochs (15 Adam steps) at 1e-3 (losses relative,
params 1e-3 (1e-3 + |ref|)): torch's Adam and optax's compute the same
update, eps 1e-8 outside the square root, in another order of
operations.  The MLP's hidden tanh past the reference's float32
saturation (|x| >= 7.9989): forward and input Jacobian at 2e-4 (1 + |ref|).
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from aircraft_tpu.dynamics import coefficients as jc
from aircraft_tpu.surrogates import models as jm
from aircraft_tpu.surrogates import preprocess as jpp

from aircraft_tpu_torch.config import NETWORKPATH
from aircraft_tpu_torch.dynamics import coefficients as tc
from aircraft_tpu_torch.surrogates import models as tm
from aircraft_tpu_torch.surrogates import preprocess as tpp

MLP_KEYS = tc.MLP_KEYS


def _inputs(n, seed=5):
    rng = np.random.default_rng(seed)
    x = np.zeros((n, 5), dtype=np.float32)
    x[:, 0] = rng.uniform(200, 4000, n)      # qbar
    x[:, 1] = rng.uniform(-0.3, 0.3, n)      # alpha
    x[:, 2] = rng.uniform(-0.3, 0.3, n)      # beta
    x[:, 3] = rng.uniform(-5, 5, n)          # aileron
    x[:, 4] = rng.uniform(-5, 5, n)          # elevator
    return x


def _targets(x):
    return np.stack([-0.02 - 0.3 * x[:, 1] ** 2, -0.98 * x[:, 2],
                     -5.0 * x[:, 1], 0.005 * x[:, 3],
                     -0.1 * x[:, 4] + 0.2 * np.tanh(x[:, 1]),
                     0.02 * x[:, 2]], axis=1).astype(np.float32)


def _np(p, keys=MLP_KEYS):
    return {k: np.asarray(getattr(p, k) if not isinstance(getattr(p, k),
                                                          torch.Tensor)
                          else getattr(p, k).detach().numpy()) for k in keys}


def _jax_init(seed=0):
    return jc.MLPCoeffParams.init(jax.random.PRNGKey(seed))


def _port_init(jp):
    return tc.mlp_from_numpy({k: np.asarray(getattr(jp, k))
                              for k in MLP_KEYS}, device="cpu")


# ---------------------------------------------------------------------------
# fits and losses
# ---------------------------------------------------------------------------


def test_fit_linear_matches():
    x = _inputs(2000)
    y = _targets(x)
    port = tm.fit_linear(x, y, device="cpu")
    ref = jm.fit_linear(x, y)
    np.testing.assert_array_equal(port.matrix.numpy(), np.asarray(ref.matrix))


def test_fit_polynomial_matches():
    x = _inputs(4000)
    y = _targets(x)
    port = tm.fit_polynomial(x, y, degree=3, device="cpu")
    ref = jm.fit_polynomial(x, y, degree=3)
    for name in ("weights", "intercept", "input_scale"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    assert port.span_over_4 == ref.span_over_4
    got = tc._poly_eval(port, torch.as_tensor(x[:256])).numpy()
    want = np.asarray(jc._poly_eval(ref, jnp.asarray(x[:256])))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_weighted_losses_match():
    rng = np.random.default_rng(2)
    pred, target = (rng.normal(0, 1, (64, 6)).astype(np.float32)
                    for _ in range(2))
    w = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    zero = rng.normal(0, 0.1, 6).astype(np.float32)
    t = [torch.as_tensor(a) for a in (pred, target, w, zero)]
    j = [jnp.asarray(a) for a in (pred, target, w, zero)]
    np.testing.assert_allclose(float(tm.weighted_mse(*t[:3])),
                               float(jm.weighted_mse(*j[:3])), rtol=1e-6)
    np.testing.assert_allclose(
        float(tm.weighted_mse_constraint(*t, 2.0)),
        float(jm.weighted_mse_constraint(*j, 2.0)), rtol=1e-6)


# ---------------------------------------------------------------------------
# preprocessing
# ---------------------------------------------------------------------------


def _raw(n=64, seed=0):
    rng = np.random.default_rng(seed)
    raw = {k: rng.normal(1.0, 0.2, n) for k in tpp.RAW_COLS}
    raw["vel"] = np.abs(raw["vel"]) * 20.0 + 10.0
    raw["alpha"] = rng.uniform(-12, 12, n)
    raw["beta"] = rng.uniform(-12, 12, n)
    raw["ctrl1"] = rng.uniform(0, 10, n)
    raw["ctrl2"] = rng.uniform(0, 10, n)
    return raw


WT = {"reference_area": 0.238, "span": 2.0, "chord": 0.1246}
FS = {"reference_area": 0.225454, "span": 1.6, "chord": 0.11}


@pytest.mark.parametrize("body,axes", [(True, "WT_AXES"), (False, "FS_AXES")])
def test_process_pipeline_matches_and_round_trips(body, axes):
    raw = _raw()
    kw = dict(body=body, axes=getattr(tpp, axes))
    for augment in (False, True):
        got = tpp.process_sim_dataset(raw, WT, FS, augment=augment, **kw)
        want = jpp.process_sim_dataset(raw, WT, FS, augment=augment, **kw)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    fin = tpp.finalise_body_frame(tpp.process_sim_dataset(
        raw, WT, FS, augment=False, **kw))
    fin_ref = jpp.finalise_body_frame(jpp.process_sim_dataset(
        raw, WT, FS, augment=False, **kw))
    for k in fin_ref:
        np.testing.assert_array_equal(fin[k], fin_ref[k], err_msg=k)
    # the round trip: finalise, invert both stages, recover the raw arrays
    back = tpp.invert_process(tpp.invert_finalise(fin), WT, FS, **kw)
    for k in tpp.RAW_COLS:
        np.testing.assert_allclose(back[k], raw[k], rtol=1e-12, atol=1e-10,
                                   err_msg=k)


def test_elementwise_preprocess_matches():
    rng = np.random.default_rng(4)
    CD, CY, CL = (rng.normal(0, 0.5, 32) for _ in range(3))
    a, b = rng.uniform(-0.5, 0.5, 32), rng.uniform(-0.5, 0.5, 32)
    for g, w in zip(tpp.wind_to_body(CD, CY, CL, a, b),
                    jpp.wind_to_body(CD, CY, CL, a, b)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tpp.wind_to_body_matrix(a, b),
                                  jpp.wind_to_body_matrix(a, b))
    x = _inputs(40)
    y = _targets(x)
    x[3, 1] = 0.9          # out of the alpha envelope
    y[5, 2] = 20.0         # a spike
    x[7, 0] = np.nan
    for g, w in zip(tpp.clean(x, y), jpp.clean(x, y)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(tpp.symmetry_augment(x, y), jpp.symmetry_augment(x, y)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tpp.reynolds_rescale(x[:, 0], 20.0, 30.0),
                                  jpp.reynolds_rescale(x[:, 0], 20.0, 30.0))


def _table(n=48):
    x = _inputs(n, seed=8)
    y = _targets(x)
    cols = dict(zip(tpp.INPUT_COLS + tpp.OUTPUT_COLS, np.concatenate(
        [x, y], axis=1).T))
    cols["windtunnel"] = np.arange(n) % 2 == 0
    return cols


def test_preprocess_dataframe_reads_by_column_name():
    cols = _table()
    df = pd.DataFrame(cols)
    want = jpp.preprocess_dataframe(df)
    for table in (cols, df):           # a dict of arrays, or a DataFrame
        for g, w in zip(tpp.preprocess_dataframe(table), want):
            np.testing.assert_array_equal(g, w)


def test_load_aero_csv_matches_the_pandas_read(tmp_path):
    """Columns out of order, an extra boolean column, a NaN and an empty
    field: the port reads by header name with the csv module, the
    reference with pandas."""
    cols = _table(64)
    names = ["windtunnel", "CY", "q", "alpha", "Cn", "beta", "CX", "aileron",
             "CZ", "elevator", "Cl", "Cm"]
    path = tmp_path / "aero.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(names)
        for i in range(64):
            row = [repr(bool(cols[c][i])) if c == "windtunnel"
                   else repr(float(cols[c][i])) for c in names]
            if i == 5:
                row[names.index("Cm")] = "nan"
            if i == 9:
                row[names.index("beta")] = ""
            w.writerow(row)
    got = tm.load_aero_csv(path)
    want = jm.load_aero_csv(path)
    assert got[0].shape == (62, 5) and got[1].shape == (62, 6)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# MLP training
# ---------------------------------------------------------------------------


def test_one_train_mlp_step_matches():
    """569 samples: 56 for validation, 513 to train, one batch of 512:
    one Adam step from the same initial weights on the same batch."""
    x = _inputs(569, seed=6)
    y = _targets(x)
    jp = _jax_init(3)
    ref = jm.train_mlp(x, y, key=jax.random.PRNGKey(3), epochs=1, seed=1)
    port = tm.train_mlp(x, y, init=_port_init(jp), epochs=1, seed=1,
                        device="cpu")
    assert port.epochs_run == ref.epochs_run == 1
    np.testing.assert_allclose(port.train_loss, ref.train_loss, rtol=1e-5)
    np.testing.assert_allclose(port.val_loss, ref.val_loss, rtol=1e-5)
    got, want = _np(port.params), _np(ref.params)
    init = _np(jp)
    for k in MLP_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    # the step moved every trained weight matrix, and no scaler trained
    for k in ("w0", "w1", "w2"):
        assert np.abs(got[k] - init[k]).max() > 1e-4
    np.testing.assert_array_equal(got["input_mean"], x[
        np.random.default_rng(1).permutation(569)[56:]].mean(axis=0))


def test_three_epochs_match():
    x = _inputs(3000, seed=7)
    y = _targets(x)
    jp = _jax_init(4)
    kw = dict(epochs=3, patience=10, learning_rate=3e-3, seed=2)
    ref = jm.train_mlp(x, y, key=jax.random.PRNGKey(4), **kw)
    port = tm.train_mlp(x, y, init=_port_init(jp), device="cpu", **kw)
    assert port.epochs_run == ref.epochs_run == 3
    assert len(port.val_history) == 3
    assert port.val_history[-1] < port.val_history[0]
    np.testing.assert_allclose(port.train_loss, ref.train_loss, rtol=1e-3)
    np.testing.assert_allclose(port.val_loss, ref.val_loss, rtol=1e-3)
    got, want = _np(port.params), _np(ref.params)
    for k in MLP_KEYS:
        assert np.all(np.abs(got[k] - want[k])
                      <= 1e-3 * (1e-3 + np.abs(want[k]))), k


def test_train_mlp_draws_its_own_init_from_its_seed():
    x = _inputs(600, seed=9)
    y = _targets(x)
    a, b, c = (tm.train_mlp(x, y, epochs=1, seed=s, device="cpu")
               for s in (3, 3, 4))
    for k in MLP_KEYS:
        torch.testing.assert_close(getattr(a.params, k), getattr(b.params, k),
                                   rtol=0, atol=0)
    assert not torch.equal(a.params.w0, c.params.w0)


# ---------------------------------------------------------------------------
# checkpoint IO
# ---------------------------------------------------------------------------


def test_save_load_round_trip_on_the_shipped_mlp(tmp_path):
    shipped = NETWORKPATH / "mlp.npz"
    port = tm.load_mlp(shipped, device="cpu")
    out = tmp_path / "mlp.npz"
    tm.save_mlp(out, port)
    with np.load(shipped) as a, np.load(out) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ref = jm.load_mlp(out)
    x = _inputs(16)
    again = tm.load_mlp(out, device="cpu")
    np.testing.assert_allclose(
        tc.mlp_forward(again, torch.as_tensor(x)).numpy(),
        np.asarray(jc.mlp_forward(ref, jnp.asarray(x))), rtol=1e-5, atol=1e-6)
    assert again.Cn_rudder == port.Cn_rudder


# ---------------------------------------------------------------------------
# the MLP's hidden tanh where the reference's float32 tanh saturates
# ---------------------------------------------------------------------------


def test_mlp_forward_and_jacobian_past_the_tanh_saturation():
    """The reference's float32 tanh is exactly +-1 with zero slope from
    |x| = 7.9989, torch's keeps a slope of ~1e-7 there (only the control
    squash saturates as the reference's, ops/elementwise.saturating_tanh).
    At the shipped MLP's inputs driven far from its training spread, a
    fifth of the hidden pre-activations pass that point; the forward
    values and the input Jacobian stay within 2e-4 (1 + |ref|) of the
    reference's (measured: 1.7e-7 and 7.9e-7), so the hidden tanh needs
    no saturating form."""
    shipped = NETWORKPATH / "mlp.npz"
    port = tm.load_mlp(shipped, device="cpu")
    ref = jm.load_mlp(shipped)
    p = _np(port)
    rng = np.random.default_rng(0)
    z = rng.standard_normal((256, 5)) * rng.uniform(1, 12, (256, 1))
    x = (p["input_mean"] + p["input_std"] * z).astype(np.float32)
    pre = (((x - p["input_mean"]) / p["input_std"]) @ p["w0"] + p["b0"]
           ) @ p["w1"] + p["b1"]
    assert np.mean(np.abs(pre) >= 7.9989) > 0.1
    want = np.asarray(jc.mlp_forward(ref, jnp.asarray(x)))
    got = tc.mlp_forward(port, torch.as_tensor(x)).numpy()
    assert np.all(np.abs(got - want) <= 2e-4 * (1 + np.abs(want)))
    j_want = np.asarray(jax.vmap(jax.jacfwd(
        lambda v: jc.mlp_forward(ref, v)))(jnp.asarray(x)))
    j_got = tc.batched_jacfwd(lambda v: tc.mlp_forward(port, v),
                              torch.as_tensor(x)).numpy()
    assert np.all(np.abs(j_got - j_want) <= 2e-4 * (1 + np.abs(j_want)))
