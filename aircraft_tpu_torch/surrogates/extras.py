"""Auxiliary surrogate families: batch-norm regression nets and a GP.

  * ``BatchNormMLP``: a small Linear→BN→ReLU regressor (the 2D aero fits
    and control maps), one generic layout for both shapes.  Its batch
    norm is this module's own formula, not ``nn.BatchNorm1d``'s: the
    biased batch variance, 1e-5 added to it before it enters the running
    moment (and added again at inference), running moments
    ``momentum·old + (1 − momentum)·new``.
  * ``GPSurrogate``: an exact GP with an RBF kernel, hyperparameters
    fitted by Adam on the negative log marginal likelihood, predictive
    mean and std in closed form.

Both are host-side training utilities; their fitted parameters are plain
tensors on ``device``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from aircraft_tpu_torch.device import resolve_device


# ---------------------------------------------------------------------------
# batch-norm MLP
# ---------------------------------------------------------------------------


class BatchNormMLP(NamedTuple):
    """Linear→BN→ReLU stack.  ``bn_mean`` / ``bn_var`` hold the running
    moments of each hidden layer for inference mode."""

    weights: tuple
    biases: tuple
    bn_scale: tuple
    bn_shift: tuple
    bn_mean: tuple
    bn_var: tuple

    @staticmethod
    def init(generator: torch.Generator, sizes: Sequence[int],
             device="cuda") -> "BatchNormMLP":
        """N(0, 1/fan_in) weights drawn from ``generator``, zero biases,
        unit scales, zero shifts, running moments (0, 1)."""
        dev = resolve_device(device)
        ws = [torch.randn((sizes[i], sizes[i + 1]), generator=generator)
              / np.sqrt(sizes[i]) for i in range(len(sizes) - 1)]
        hidden = sizes[1:-1]     # no BN on the output layer
        return BatchNormMLP(
            weights=tuple(w.to(dev) for w in ws),
            biases=tuple(torch.zeros(s, device=dev) for s in sizes[1:]),
            bn_scale=tuple(torch.ones(s, device=dev) for s in hidden),
            bn_shift=tuple(torch.zeros(s, device=dev) for s in hidden),
            bn_mean=tuple(torch.zeros(s, device=dev) for s in hidden),
            bn_var=tuple(torch.ones(s, device=dev) for s in hidden))


def batchnorm_mlp_from_numpy(arrays, device="cuda") -> BatchNormMLP:
    """A ``BatchNormMLP`` from a mapping of its field names to sequences of
    numpy arrays, one per layer."""
    dev = resolve_device(device)
    return BatchNormMLP(**{
        f: tuple(torch.tensor(np.asarray(a, np.float32), device=dev)
                 for a in arrays[f]) for f in BatchNormMLP._fields})


def batchnorm_mlp_apply(p: BatchNormMLP, x: torch.Tensor, *,
                        train: bool = False, momentum: float = 0.9):
    """Forward pass.  ``train=True`` normalises by batch statistics and
    returns (y, updated_params) with refreshed running moments (no
    gradient flows into them); inference uses the stored moments and
    returns y only."""
    h = x
    new_mu, new_var = [], []
    n_hidden = len(p.bn_scale)
    for i, (W, b) in enumerate(zip(p.weights, p.biases)):
        h = h @ W + b
        if i < n_hidden:
            if train:
                m = torch.mean(h, dim=0)
                v = torch.var(h, dim=0, unbiased=False) + 1e-5
                new_mu.append(momentum * p.bn_mean[i]
                              + (1 - momentum) * m.detach())
                new_var.append(momentum * p.bn_var[i]
                               + (1 - momentum) * v.detach())
            else:
                m, v = p.bn_mean[i], p.bn_var[i] + 1e-5
            h = (h - m) / torch.sqrt(v) * p.bn_scale[i] + p.bn_shift[i]
            h = torch.relu(h)
    if train:
        return h, p._replace(bn_mean=tuple(new_mu), bn_var=tuple(new_var))
    return h


def train_batchnorm_mlp(
    x: np.ndarray,
    y: np.ndarray,
    *,
    hidden: Sequence[int] = (64, 64),
    epochs: int = 100,
    batch_size: int = 256,
    learning_rate: float = 1e-3,
    seed: int = 0,
    init: Optional[BatchNormMLP] = None,
    device="cuda",
) -> tuple[BatchNormMLP, float]:
    """Adam regression fit of weights, biases, scales and shifts; returns
    (params, the last step's train-mode mse).  The net starts from
    ``init`` when given, else ``BatchNormMLP.init`` with a generator
    seeded with ``seed``; ``numpy.random.default_rng(seed)`` shuffles."""
    dev = resolve_device(device)
    if init is None:
        init = BatchNormMLP.init(torch.Generator().manual_seed(seed), [x.shape[1], *hidden, y.shape[1]],
                                 device=dev)
    params = BatchNormMLP(*(tuple(t.detach().to(dev, copy=True) for t in f)
                            for f in init))
    trained = [t.requires_grad_() for f in ("weights", "biases", "bn_scale",
                                            "bn_shift")
               for t in getattr(params, f)]
    opt = torch.optim.Adam(trained, lr=learning_rate, eps=1e-8)
    rng = np.random.default_rng(seed)
    x_d = torch.as_tensor(x, device=dev)
    y_d = torch.as_tensor(y, device=dev)

    n = x.shape[0]
    steps = max(1, n // batch_size)
    loss = None
    for _ in range(epochs):
        order = torch.as_tensor(rng.permutation(n), device=dev)
        for i in range(steps):
            idx = order[i * batch_size: (i + 1) * batch_size]
            opt.zero_grad(set_to_none=True)
            pred, p_new = batchnorm_mlp_apply(params, x_d[idx], train=True)
            loss = torch.mean((pred - y_d[idx]) ** 2)
            loss.backward()
            opt.step()
            # keep the non-trainable running moments from the forward pass
            params = params._replace(bn_mean=p_new.bn_mean,
                                     bn_var=p_new.bn_var)
    out = BatchNormMLP(*(tuple(t.detach() for t in f) for f in params))
    return out, (float(loss.detach()) if loss is not None else float("inf"))


# ---------------------------------------------------------------------------
# exact GP surrogate
# ---------------------------------------------------------------------------


class GPParams(NamedTuple):
    log_lengthscale: torch.Tensor   # (d,)
    log_outputscale: torch.Tensor   # ()
    log_noise: torch.Tensor         # ()


def gp_params_from_numpy(arrays, device="cuda") -> GPParams:
    """``GPParams`` (float32) from a mapping of its field names to numpy
    values."""
    dev = resolve_device(device)
    return GPParams(**{f: torch.tensor(np.asarray(arrays[f], np.float32),
                                       device=dev)
                       for f in GPParams._fields})


def _rbf(xa: torch.Tensor, xb: torch.Tensor, p: GPParams) -> torch.Tensor:
    ls = torch.exp(p.log_lengthscale)
    d = (xa[:, None, :] - xb[None, :, :]) / ls
    return torch.exp(p.log_outputscale) * torch.exp(
        -0.5 * torch.sum(d * d, dim=-1))


def _gram(x: torch.Tensor, p: GPParams) -> torch.Tensor:
    n = x.shape[0]
    return _rbf(x, x, p) + torch.exp(p.log_noise) * torch.eye(
        n, dtype=x.dtype, device=x.device)


def gp_neg_log_marginal(p: GPParams, x: torch.Tensor,
                        y: torch.Tensor) -> torch.Tensor:
    """Negative log marginal likelihood of y (n,) at x (n, d)."""
    n = x.shape[0]
    L = torch.linalg.cholesky(_gram(x, p))
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    return (0.5 * y @ alpha + torch.sum(torch.log(torch.diagonal(L)))
            + 0.5 * n * math.log(2.0 * math.pi))


class GPSurrogate(NamedTuple):
    """Fitted exact GP for one scalar output."""

    params: GPParams
    x_train: torch.Tensor
    chol: torch.Tensor
    alpha: torch.Tensor

    @staticmethod
    def fit(x: np.ndarray, y: np.ndarray, *, iters: int = 200,
            learning_rate: float = 5e-2, device="cuda") -> "GPSurrogate":
        """Adam on the hyperparameters from lengthscales 1, outputscale
        1, noise e^-4.  In float32 throughout: the float64 the fit names
        is what the package's x64-off setting computes as float32, so the
        surrogate computes what it always has."""
        dev = resolve_device(device)
        x_t = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        y_t = torch.as_tensor(np.asarray(y, np.float32), device=dev)
        p = GPParams(log_lengthscale=torch.zeros(x.shape[1], device=dev),
                     log_outputscale=torch.zeros((), device=dev),
                     log_noise=torch.full((), -4.0, device=dev))
        for t in p:
            t.requires_grad_()
        opt = torch.optim.Adam(list(p), lr=learning_rate, eps=1e-8)
        for _ in range(iters):
            opt.zero_grad(set_to_none=True)
            gp_neg_log_marginal(p, x_t, y_t).backward()
            opt.step()
        p = GPParams(*(t.detach() for t in p))
        L = torch.linalg.cholesky(_gram(x_t, p))
        alpha = torch.cholesky_solve(y_t[:, None], L)[:, 0]
        return GPSurrogate(params=p, x_train=x_t, chol=L, alpha=alpha)

    def predict(self, x_new: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean, std) at query points."""
        xq = torch.as_tensor(np.asarray(x_new), dtype=self.x_train.dtype,
                             device=self.x_train.device)
        Ks = _rbf(xq, self.x_train, self.params)
        mean = Ks @ self.alpha
        v = torch.linalg.solve_triangular(self.chol, Ks.T, upper=False)
        var = (torch.exp(self.params.log_outputscale)
               + torch.exp(self.params.log_noise) - torch.sum(v * v, dim=0))
        return mean, torch.sqrt(torch.clamp_min(var, 1e-12))
