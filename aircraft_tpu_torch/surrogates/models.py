"""Surrogate aero-coefficient model training and classical fits.

The affine and cubic fits are closed-form least squares on the host; the
MLP surrogate trains with ``torch.optim.Adam`` on ``device``.  The
trained artifacts are the coefficient-model parameters the dynamics
consume directly (``dynamics/coefficients.py``).

Data layout of the aero CSVs (``data_sim.csv``): inputs [q, alpha, beta,
aileron, elevator] -> outputs [CX, CY, CZ, Cl, Cm, Cn].
"""

from __future__ import annotations

import csv
from dataclasses import replace
from typing import NamedTuple, Optional

import numpy as np
import torch

from aircraft_tpu_torch.device import resolve_device
from aircraft_tpu_torch.dynamics.coefficients import (
    MLP_KEYS,
    LinearCoeffParams,
    MLPCoeffParams,
    PolyCoeffParams,
    linear_from_numpy,
    load_mlp,
    mlp_forward,
    polynomial_exponents,
)
from aircraft_tpu_torch.surrogates.preprocess import INPUT_COLS, OUTPUT_COLS

# the standardisation scalers are fitted from the data and never trained
SCALER_KEYS = ("input_mean", "input_std", "output_mean", "output_std")
TRAINED_KEYS = tuple(k for k in MLP_KEYS if k not in SCALER_KEYS)


def _number(field: str) -> float:
    """A CSV field as a float; an empty field is missing (NaN)."""
    return float(field) if field.strip() else float("nan")


def load_aero_csv(path) -> tuple[np.ndarray, np.ndarray]:
    """Read an aero CSV into (inputs (N,5), outputs (N,6)) float32, columns
    found by header name; rows with a missing or non-finite value
    dropped."""
    with open(path, newline="") as f:
        rows = csv.reader(f)
        header = [h.strip() for h in next(rows)]
        idx = [header.index(c) for c in INPUT_COLS + OUTPUT_COLS]
        data = np.array([[_number(r[i]) for i in idx] for r in rows if r],
                        dtype=np.float64).reshape(-1, len(idx))
    x = data[:, :len(INPUT_COLS)].astype(np.float32)
    y = data[:, len(INPUT_COLS):].astype(np.float32)
    mask = np.all(np.isfinite(x), axis=1) & np.all(np.isfinite(y), axis=1)
    return x[mask], y[mask]


# ---------------------------------------------------------------------------
# classical fits
# ---------------------------------------------------------------------------


def fit_linear(x: np.ndarray, y: np.ndarray,
               device="cuda") -> LinearCoeffParams:
    """Least-squares affine fit -> (6, 6) matrix over [inputs, 1]."""
    xh = np.concatenate([x, np.ones((x.shape[0], 1), dtype=x.dtype)], axis=1)
    coef, *_ = np.linalg.lstsq(xh, y, rcond=None)
    return linear_from_numpy({"matrix": coef.T.astype(np.float32)}, device)


def fit_polynomial(
    x: np.ndarray, y: np.ndarray, degree: int = 3, span: float = 2.0,
    ridge: float = 1e-8, device="cuda",
) -> PolyCoeffParams:
    """Degree-3 polynomial-features regression per output coefficient.
    Inputs are standardised by their max-abs to keep the cubic features
    conditioned."""
    # the cubic features need float64 conditioning
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    scale = 1.0 / np.maximum(np.abs(x).max(axis=0), 1e-9)
    exps = polynomial_exponents(5, degree)
    feats = np.prod((x * scale)[:, None, :] ** exps[None], axis=-1)  # (N, F)
    # centred least squares: regress centred targets on centred features,
    # recover the intercept exactly (centring also conditions the Gram)
    fm = feats.mean(axis=0)
    ym = y.mean(axis=0)
    fc = feats - fm
    A = fc.T @ fc + ridge * np.eye(feats.shape[1])
    W = np.linalg.solve(A, fc.T @ (y - ym))
    intercept = ym - fm @ W
    return PolyCoeffParams.make(
        weights=W.T.astype(np.float32),
        intercept=intercept.astype(np.float32),
        span=span,
        degree=degree,
        input_scale=scale.astype(np.float32),
        device=device,
    )


# ---------------------------------------------------------------------------
# neural surrogate training
# ---------------------------------------------------------------------------


class TrainResult(NamedTuple):
    params: MLPCoeffParams
    train_loss: float
    val_loss: float
    epochs_run: int
    val_history: tuple = ()   # each epoch's validation loss


def weighted_mse(pred: torch.Tensor, target: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
    """1/σ² weighted MSE."""
    return torch.mean(weights * (pred - target) ** 2)


def weighted_mse_constraint(
    pred: torch.Tensor,
    target: torch.Tensor,
    weights: torch.Tensor,
    zero_pred: torch.Tensor,
    zero_weight: float = 1.0,
) -> torch.Tensor:
    """Weighted MSE plus a penalty anchoring the model's response at the
    zero aero input to zero coefficients: pass ``zero_pred =
    model(zeros(5))`` so e.g. CY/Cl/Cn vanish in symmetric flow regardless
    of data coverage."""
    return weighted_mse(pred, target, weights) + zero_weight * torch.mean(
        zero_pred ** 2)


def _detached(p: MLPCoeffParams) -> MLPCoeffParams:
    return replace(p, **{k: getattr(p, k).detach().clone() for k in MLP_KEYS})


def train_mlp(
    x: np.ndarray,
    y: np.ndarray,
    *,
    init: Optional[MLPCoeffParams] = None,
    epochs: int = 200,
    batch_size: int = 512,
    learning_rate: float = 1e-3,
    val_fraction: float = 0.1,
    patience: int = 10,
    seed: int = 0,
    device="cuda",
) -> TrainResult:
    """Train the ScaledModel-architecture surrogate with its
    standardisation baked into the params, by Adam (eps 1e-8 outside the
    square root).  The weights start from ``init`` when given, else
    ``MLPCoeffParams.init`` with a generator seeded with ``seed``; the
    scalers are fitted from the training split and stay frozen.
    ``numpy.random.default_rng(seed)`` splits and shuffles; the best
    validation epoch's params are returned, training stops after
    ``patience`` epochs without a better one."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    n = x.shape[0]
    perm = rng.permutation(n)
    n_val = max(1, int(n * val_fraction))
    val_idx, train_idx = perm[:n_val], perm[n_val:]
    x_train, y_train = x[train_idx], y[train_idx]

    scalers = {"input_mean": x_train.mean(axis=0),
               "input_std": x_train.std(axis=0) + 1e-8,
               "output_mean": y_train.mean(axis=0),
               "output_std": y_train.std(axis=0) + 1e-8}
    weights = torch.as_tensor(1.0 / (y_train.std(axis=0) + 1e-8) ** 2,
                              device=dev)

    if init is None:
        init = MLPCoeffParams.init(torch.Generator().manual_seed(seed),
                                   device=dev)
    leaves = {k: getattr(init, k).detach().to(dev, copy=True)
              for k in TRAINED_KEYS}
    leaves.update({k: torch.as_tensor(v, device=dev)
                   for k, v in scalers.items()})
    params = replace(init, **leaves)
    trained = [leaves[k].requires_grad_() for k in TRAINED_KEYS]
    opt = torch.optim.Adam(trained, lr=learning_rate, eps=1e-8)

    x_train_d = torch.as_tensor(x_train, device=dev)
    y_train_d = torch.as_tensor(y_train, device=dev)
    x_val = torch.as_tensor(x[val_idx], device=dev)
    y_val = torch.as_tensor(y[val_idx], device=dev)

    best_val = np.inf
    best_params = _detached(params)
    bad_epochs = 0
    n_train = x_train.shape[0]
    steps = max(1, n_train // batch_size)
    last_train = np.inf
    history = []

    for epoch in range(epochs):
        order = torch.as_tensor(rng.permutation(n_train), device=dev)
        losses = []
        for i in range(steps):
            idx = order[i * batch_size: (i + 1) * batch_size]
            opt.zero_grad(set_to_none=True)
            loss = weighted_mse(mlp_forward(params, x_train_d[idx]),
                                y_train_d[idx], weights)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        last_train = float(torch.stack(losses).double().mean())
        with torch.no_grad():
            v = float(weighted_mse(mlp_forward(params, x_val), y_val,
                                   weights))
        history.append(v)
        if v < best_val - 1e-7:
            best_val, best_params, bad_epochs = v, _detached(params), 0
        else:
            bad_epochs += 1
            if bad_epochs >= patience:
                break

    return TrainResult(params=best_params, train_loss=last_train,
                       val_loss=best_val, epochs_run=epoch + 1,
                       val_history=tuple(history))


# ---------------------------------------------------------------------------
# checkpoint IO: the keys of data/networks/mlp.npz
# ---------------------------------------------------------------------------


def save_mlp(path, params: MLPCoeffParams) -> None:
    """Write ``params`` as an npz keyed like ``data/networks/mlp.npz``
    (``MLP_KEYS`` and ``Cn_rudder``, float32)."""
    flat = {k: getattr(params, k).detach().cpu().numpy().astype(np.float32)
            for k in MLP_KEYS}
    flat["Cn_rudder"] = np.float32(params.Cn_rudder)
    np.savez(path, **flat)


__all__ = ["INPUT_COLS", "OUTPUT_COLS", "TrainResult", "fit_linear",
           "fit_polynomial", "load_aero_csv", "load_mlp", "save_mlp",
           "train_mlp", "weighted_mse", "weighted_mse_constraint"]
