"""The port's batch-norm MLP and exact GP surrogate against the JAX
package's, from the same (JAX-drawn) initial weights and numpy-made data.

Tolerances: forward passes and the GP's negative log marginal 1e-5
relative (float32 both), its gradient 1e-4 relative; a few Adam steps of
the batch-norm net 1e-4 (1e-3 + |ref|), but for the biases a batch norm
removes (see the test); a short GP fit's hyperparameters and predictions
1e-4 (1 + |ref|).  The reference's GP asks for float64 but runs with
JAX's x64 off, so it computes in float32, and the port does too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aircraft_tpu.surrogates import extras as je

from aircraft_tpu_torch.surrogates import extras as te

SIZES = (3, 32, 16, 2)


def _data(n=512, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, 3)).astype(np.float32)
    A = np.array([[1.0, -2.0], [0.5, 0.0], [0.0, 1.0]], np.float32)
    return x, (x @ A + 0.3 * np.tanh(x[:, :2])).astype(np.float32)


def _jax_net(seed=0, sizes=SIZES):
    return je.BatchNormMLP.init(jax.random.PRNGKey(seed), sizes)


def _port_net(jnet):
    return te.batchnorm_mlp_from_numpy(
        jax.tree_util.tree_map(np.asarray, jnet)._asdict(), device="cpu")


def _leaves(p):
    return [np.asarray(t) if not isinstance(t, torch.Tensor) else t.numpy()
            for f in p for t in f]


def test_converter_copies_every_leaf():
    jnet = _jax_net()
    pnet = _port_net(jnet)
    for g, w in zip(_leaves(pnet), _leaves(jnet)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_forward_matches(train):
    x, _ = _data(64)
    jnet = _jax_net(1)
    # moments away from (0, 1) so inference mode reads them
    jnet = jnet._replace(
        bn_mean=tuple(m + 0.1 for m in jnet.bn_mean),
        bn_var=tuple(v * 1.5 for v in jnet.bn_var))
    pnet = _port_net(jnet)
    want = je.batchnorm_mlp_apply(jnet, jnp.asarray(x), train=train)
    got = te.batchnorm_mlp_apply(pnet, torch.as_tensor(x), train=train)
    if train:
        (want, jnew), (got, pnew) = want, got
        for f in ("bn_mean", "bn_var"):
            for g, w in zip(getattr(pnew, f), getattr(jnew, f)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_batchnorm_train_steps_match():
    """Two epochs of four batches: eight Adam steps, the running moments
    carried from each step's forward pass.  A hidden layer's bias feeds a
    batch norm, whose batch mean removes it: its gradient is zero in exact
    arithmetic and float32 rounding noise in both packages, which Adam
    scales to steps of up to the learning rate either way.  So those
    biases, and the running means that carry them, are held to within two
    learning rates per step of the reference's; every other leaf, and the
    trained nets' train-mode outputs, at 1e-4."""
    x, y = _data(512)
    lr, steps = 3e-3, 8
    kw = dict(hidden=SIZES[1:-1], epochs=2, batch_size=128,
              learning_rate=lr, seed=0)
    ref, ref_loss = je.train_batchnorm_mlp(x, y, **kw)
    port, loss = te.train_batchnorm_mlp(
        x, y, init=_port_net(_jax_net(0)), device="cpu", **kw)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-4)
    n_hidden = len(SIZES) - 2
    for f in te.BatchNormMLP._fields:
        for i, (g, w) in enumerate(zip(getattr(port, f), getattr(ref, f))):
            g, w = g.numpy(), np.asarray(w)
            if (f == "biases" and i < n_hidden) or f == "bn_mean":
                assert np.abs(g - w).max() <= 2 * lr * steps, (f, i)
            else:
                assert np.all(np.abs(g - w) <= 1e-4 * (1e-3 + np.abs(w))), (
                    f, i)
    xb = x[:128]
    got, _ = te.batchnorm_mlp_apply(port, torch.as_tensor(xb), train=True)
    want, _ = je.batchnorm_mlp_apply(ref, jnp.asarray(xb), train=True)
    want = np.asarray(want)
    assert np.all(np.abs(got.numpy() - want) <= 1e-4 * (1 + np.abs(want)))


def test_batchnorm_running_means_carry_across_steps():
    """The same eight steps on inputs centred at 3, so the first layer's
    pre-activations, and its running mean, sit near 3 where the data
    above keeps them near 0.  A running mean that lost its carry across
    steps would hold 0.1 of the last batch mean, not the 1 - 0.9**8 = 0.57
    the carry builds up, and miss by about 1.  The running means are
    held to two learning rates per step, as above, and the trained nets'
    inference-mode outputs, which read them, to the same times
    (1 + |ref|): a hidden bias and the running mean that carries it both
    drift by up to that much."""
    x, y = _data(512)
    x = x + 3.0
    lr, steps = 3e-3, 8
    kw = dict(hidden=SIZES[1:-1], epochs=2, batch_size=128,
              learning_rate=lr, seed=0)
    ref, _ = je.train_batchnorm_mlp(x, y, **kw)
    port, _ = te.train_batchnorm_mlp(
        x, y, init=_port_net(_jax_net(0)), device="cpu", **kw)
    assert np.abs(np.asarray(ref.bn_mean[0])).max() > 1.0
    for g, w in zip(port.bn_mean, ref.bn_mean):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 2 * lr * steps
    xb = x[:128]
    got = te.batchnorm_mlp_apply(port, torch.as_tensor(xb), train=False)
    want = np.asarray(je.batchnorm_mlp_apply(ref, jnp.asarray(xb),
                                             train=False))
    assert np.all(np.abs(got.numpy() - want)
                  <= 2 * lr * steps * (1 + np.abs(want)))


def test_batchnorm_init_from_a_generator():
    net = te.BatchNormMLP.init(torch.Generator().manual_seed(0), SIZES,
                               device="cpu")
    assert [tuple(w.shape) for w in net.weights] == [(3, 32), (32, 16),
                                                     (16, 2)]
    assert len(net.bn_scale) == len(net.bn_mean) == 2
    again = te.BatchNormMLP.init(torch.Generator().manual_seed(0), SIZES,
                                 device="cpu")
    for g, w in zip(_leaves(net), _leaves(again)):
        np.testing.assert_array_equal(g, w)


def _gp_data(n=40, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    return x, np.sin(2 * x[:, 0]) * np.cos(x[:, 1]).astype(np.float32)


def test_gp_negative_log_marginal_and_gradient_match():
    x, y = _gp_data()
    vals = dict(log_lengthscale=np.array([0.2, -0.3], np.float32),
                log_outputscale=np.float32(0.1), log_noise=np.float32(-3.0))
    jp = je.GPParams(**{k: jnp.asarray(v) for k, v in vals.items()})
    jv, jg = jax.value_and_grad(je.gp_neg_log_marginal)(
        jp, jnp.asarray(x), jnp.asarray(y))
    tp = te.gp_params_from_numpy(vals, device="cpu")
    for t in tp:
        t.requires_grad_()
    tv = te.gp_neg_log_marginal(tp, torch.as_tensor(x), torch.as_tensor(y))
    tv.backward()
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    for t, g in zip(tp, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-5)


def test_gp_fit_and_predict_match():
    x, y = _gp_data()
    ref = je.GPSurrogate.fit(x, y, iters=30)
    port = te.GPSurrogate.fit(x, y, iters=30, device="cpu")
    assert port.x_train.dtype == torch.float32
    for t, r in zip(port.params, ref.params):
        np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4)
    xq = np.array([[0.5, 0.1], [-1.0, 1.5], [5.0, 0.0]], np.float32)
    (mean, std), (rmean, rstd) = port.predict(xq), ref.predict(xq)
    for g, w in ((mean, rmean), (std, rstd)):
        assert np.all(np.abs(g.numpy() - np.asarray(w))
                      <= 1e-4 * (1 + np.abs(np.asarray(w))))
    assert float(std[2]) > float(std[0])     # far from the data
