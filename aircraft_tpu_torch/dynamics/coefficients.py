"""Aerodynamic coefficient models: the hard-coded default linear aero and
the trained 5-16-32-6 MLP surrogate.

Each model maps flow conditions to the six body-frame coefficients
``[CX, CY, CZ, Cl, Cm, Cn]`` and broadcasts over leading batch axes.  The
linear, polynomial and Taylor models of the reference are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import NamedTuple

import numpy as np
import torch

from aircraft_tpu_torch.config import NETWORKPATH
from aircraft_tpu_torch.device import resolve_device

DEG2RAD = np.pi / 180.0

MLP_KEYS = ("w0", "b0", "w1", "b1", "w2", "b2",
            "input_mean", "input_std", "output_mean", "output_std")


class AeroState(NamedTuple):
    """Flow conditions feeding the coefficient models (per-surface
    rate-shifted quantities included)."""

    qbar: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor
    omega: torch.Tensor
    elevator_alpha: torch.Tensor
    left_wing_alpha: torch.Tensor
    right_wing_alpha: torch.Tensor
    left_wing_qbar: torch.Tensor
    right_wing_qbar: torch.Tensor
    rudder_beta: torch.Tensor


def model_inputs(aero: AeroState, aileron, elevator) -> torch.Tensor:
    """[qbar, alpha, beta, aileron, elevator] — the shared model input."""
    return torch.stack([aero.qbar, aero.alpha, aero.beta, aileron, elevator],
                       dim=-1)


@dataclass(frozen=True)
class DefaultCoeffParams:
    """Hard-coded linear aero + rate damping."""

    CD0: float = 0.02
    CD_alpha: float = 0.3
    CL0: float = 0.0
    CL_alpha: float = 5.0
    CY_beta: float = -0.98
    Cl_aileron: float = 0.08
    Cl_p: float = -0.05
    Cm_elevator: float = -1.2
    Cm_q: float = -0.5
    Cn_rudder: float = -0.1
    Cn_r: float = -0.05

    def to(self, device) -> "DefaultCoeffParams":
        return self


def _apply_default(cp: DefaultCoeffParams, aero: AeroState, aileron,
                   elevator, rudder):
    p, q, r = aero.omega[..., 0], aero.omega[..., 1], aero.omega[..., 2]
    CD = cp.CD0 + cp.CD_alpha * aero.alpha ** 2
    CL = cp.CL0 + cp.CL_alpha * aero.alpha
    CY = cp.CY_beta * aero.beta
    Cl = cp.Cl_aileron * 4.0 * aileron * DEG2RAD + cp.Cl_p * p
    Cm = cp.Cm_elevator * 5.0 * elevator * DEG2RAD + cp.Cm_q * q
    Cn = cp.Cn_rudder * 6.0 * rudder * DEG2RAD + cp.Cn_r * r
    return torch.stack([-CD, CY, -CL, Cl, Cm, Cn], dim=-1)


@dataclass(frozen=True)
class MLPCoeffParams:
    """ScaledModel: standardise -> Linear(5,16) -> Linear(16,32) -> tanh ->
    Linear(32,6) -> de-standardise."""

    w0: torch.Tensor  # (5, 16)
    b0: torch.Tensor  # (16,)
    w1: torch.Tensor  # (16, 32)
    b1: torch.Tensor  # (32,)
    w2: torch.Tensor  # (32, 6)
    b2: torch.Tensor  # (6,)
    input_mean: torch.Tensor   # (5,)
    input_std: torch.Tensor    # (5,)
    output_mean: torch.Tensor  # (6,)
    output_std: torch.Tensor   # (6,)
    Cn_rudder: float = -0.1

    def to(self, device) -> "MLPCoeffParams":
        return replace(self, **{k: getattr(self, k).to(device)
                                for k in MLP_KEYS})


def mlp_from_numpy(arrays, device="cuda") -> MLPCoeffParams:
    """MLP parameters from a mapping of numpy arrays (the keys of
    ``data/networks/mlp.npz``: w0..b2, in/out mean/std, Cn_rudder)."""
    dev = resolve_device(device)
    kw = {k: torch.as_tensor(np.array(arrays[k], np.float32), device=dev)
          for k in MLP_KEYS}
    if "Cn_rudder" in arrays:
        kw["Cn_rudder"] = float(np.asarray(arrays["Cn_rudder"]))
    return MLPCoeffParams(**kw)


def load_mlp(path=None, device="cuda") -> MLPCoeffParams:
    """The trained surrogate, read straight from an ``mlp.npz``."""
    path = NETWORKPATH / "mlp.npz" if path is None else path
    with np.load(path) as d:
        return mlp_from_numpy({k: d[k] for k in d.files}, device)


def mlp_forward(cp: MLPCoeffParams, x: torch.Tensor) -> torch.Tensor:
    """Raw ScaledModel forward on (..., 5) inputs."""
    h = (x - cp.input_mean) / cp.input_std
    h = h @ cp.w0 + cp.b0
    h = h @ cp.w1 + cp.b1
    h = torch.tanh(h)
    h = h @ cp.w2 + cp.b2
    return h * cp.output_std + cp.output_mean


def _apply_mlp(cp: MLPCoeffParams, aero: AeroState, aileron, elevator,
               rudder):
    out = mlp_forward(cp, model_inputs(aero, aileron, elevator))
    cn = out[..., 5] + cp.Cn_rudder * 6.0 * rudder * DEG2RAD
    return torch.cat([out[..., :5], cn[..., None]], dim=-1)


def apply_coefficients(cp, aero: AeroState, aileron, elevator, rudder):
    if isinstance(cp, MLPCoeffParams):
        return _apply_mlp(cp, aero, aileron, elevator, rudder)
    if isinstance(cp, DefaultCoeffParams):
        return _apply_default(cp, aero, aileron, elevator, rudder)
    raise NotImplementedError(
        f"coefficient model {type(cp).__name__} is not ported")


def fold_mlp(cp: MLPCoeffParams) -> torch.Tensor:
    """The MLP with the input scaler folded into layer 0 and the output
    scaler into layer 2, flattened to 838 float32 values in the order
    [w0f (5x16), b0f (16), w1 (16x32), b1 (32), w2f (32x6), b2f (6)] —
    the weight block the window kernels read."""
    g = {k: getattr(cp, k).detach().cpu().numpy().astype(np.float32)
         for k in MLP_KEYS}
    w0f = (g["w0"] / g["input_std"][:, None]).astype(np.float32)
    b0f = (g["b0"] - g["input_mean"] @ w0f).astype(np.float32)
    w2f = (g["w2"] * g["output_std"][None, :]).astype(np.float32)
    b2f = (g["b2"] * g["output_std"] + g["output_mean"]).astype(np.float32)
    flat = np.concatenate([w0f.ravel(), b0f, g["w1"].ravel(), g["b1"],
                           w2f.ravel(), b2f]).astype(np.float32)
    assert flat.size == 838, flat.size
    return torch.as_tensor(flat, device=cp.w0.device)


def default_coeff_vector(cp: DefaultCoeffParams) -> list[float]:
    return [float(getattr(cp, f.name)) for f in fields(DefaultCoeffParams)]


__all__ = ["AeroState", "DefaultCoeffParams", "MLPCoeffParams",
           "apply_coefficients", "default_coeff_vector", "fold_mlp",
           "load_mlp", "mlp_forward", "mlp_from_numpy", "model_inputs"]
