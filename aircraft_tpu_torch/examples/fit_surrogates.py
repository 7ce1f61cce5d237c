"""Fit the aero-surrogate artifacts from an aero CSV.

From a CSV with the columns [q, alpha, beta, aileron, elevator, CX, CY,
CZ, Cl, Cm, Cn] (the layout of ``data_sim.csv``) it writes into ``--out``:

  linearised.csv   the affine model (header row, then the 6 x 6 matrix)
  poly.npz         the degree-3 polynomial model
  mlp.npz          the trained 5-16-32-6 MLP (the keys of
                   data/networks/mlp.npz)

    python -m aircraft_tpu_torch.examples.fit_surrogates --data PATH.csv
        [--out build/aircraft_tpu_torch/networks] [--epochs 150]
        [--device cuda]

``--out`` defaults to a directory under ``build/``, never to
``data/networks/``, whose shipped artifacts the plant loads.  Prints
each model's RMSE per coefficient and the MLP's losses, epochs, train
steps/s and wall, then one JSON record (``device`` holding the card's
name and power limit).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from aircraft_tpu_torch.device import resolve_device
from aircraft_tpu_torch.dynamics.coefficients import _poly_eval
from aircraft_tpu_torch.surrogates import (fit_linear, fit_polynomial,
                                           load_aero_csv, save_mlp, train_mlp)

DEFAULT_OUT = (Path(__file__).resolve().parents[2] / "build"
               / "aircraft_tpu_torch" / "networks")
MLP_PATIENCE = 12
MLP_BATCH = 512


def _rmse(pred: np.ndarray, y: np.ndarray) -> list:
    return np.sqrt(((pred - y) ** 2).mean(0)).tolist()


def run(data, out=DEFAULT_OUT, *, epochs=150, device="cuda",
        log=print) -> dict:
    """Fit the three models on the CSV ``data`` and write them to ``out``;
    returns the record."""
    from aircraft_tpu_torch.bench import _card

    dev = resolve_device(device)
    x, y = load_aero_csv(data)
    log(f"loaded {x.shape[0]} samples from {data}")
    os.makedirs(out, exist_ok=True)

    lin = fit_linear(x, y, device=dev)
    M = lin.matrix.cpu().numpy()
    np.savetxt(os.path.join(out, "linearised.csv"), M, delimiter=",",
               header="q,alpha,beta,aileron,elevator,intercept", comments="")
    pred = np.concatenate([x, np.ones((x.shape[0], 1), np.float32)], 1) @ M.T
    lin_rmse = _rmse(pred, y)
    log(f"linear:  rmse per coeff {np.round(lin_rmse, 4)}")

    poly = fit_polynomial(x, y, degree=3, span=2.0, device=dev)
    with torch.no_grad():
        pred = _poly_eval(poly, torch.as_tensor(x, device=dev)).cpu().numpy()
    poly_rmse = _rmse(pred, y)
    log(f"poly:    rmse per coeff {np.round(poly_rmse, 4)}")
    np.savez(os.path.join(out, "poly.npz"),
             weights=poly.weights.cpu().numpy(),
             intercept=poly.intercept.cpu().numpy(),
             input_scale=poly.input_scale.cpu().numpy(),
             span_over_4=poly.span_over_4)

    n_train = x.shape[0] - max(1, int(x.shape[0] * 0.1))
    t0 = time.perf_counter()
    result = train_mlp(x, y, epochs=epochs, batch_size=MLP_BATCH,
                       patience=MLP_PATIENCE, device=dev)
    wall = time.perf_counter() - t0
    steps = result.epochs_run * max(1, n_train // MLP_BATCH)
    log(f"mlp:     train {result.train_loss:.4f} val {result.val_loss:.4f} "
        f"({result.epochs_run} epochs, {steps} steps, "
        f"{steps / wall:.1f} steps/s, {wall:.2f} s)")
    save_mlp(os.path.join(out, "mlp.npz"), result.params)
    log(f"artifacts written to {out}/")
    return {"experiment": "fit_surrogates", "device": _card(dev),
            "samples": int(x.shape[0]), "linear_rmse": lin_rmse,
            "poly_rmse": poly_rmse, "mlp_train_loss": result.train_loss,
            "mlp_val_loss": result.val_loss,
            "mlp_val_history": list(result.val_history),
            "mlp_epochs": result.epochs_run, "mlp_steps": steps,
            "mlp_steps_per_s": steps / wall, "mlp_wall_s": wall,
            "out": str(out)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", required=True,
                    help="aero CSV with the data_sim.csv columns")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rec = run(args.data, args.out, epochs=args.epochs, device=args.device,
              log=lambda line: print(line, flush=True))
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
