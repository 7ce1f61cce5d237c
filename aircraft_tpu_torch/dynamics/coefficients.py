"""Aerodynamic coefficient models: each maps flow conditions to the six
body-frame coefficients ``[CX, CY, CZ, Cl, Cm, Cn]`` and broadcasts over
leading batch axes.

  default    hard-coded linear aero + rate damping
  linear     affine map fitted from data (``linearised.csv``)
  poly       degree-3 polynomial per output, with per-surface local-flow
             re-evaluation (wing asymmetry -> roll moment)
  nn         the trained 5-16-32(tanh)-6 MLP surrogate with its scalers
  nn_mini    the ELU alternative of the MLP
  nn_taylor  a first-order expansion of another model about an anchor

Every params class has ``to(device)``; the loaders and constructors take
``device`` (default ``cuda``).  Random initialisations draw from a
``torch.Generator``.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, fields, replace
from functools import singledispatch
from itertools import combinations_with_replacement
from pathlib import Path
from typing import Any, NamedTuple

import numpy as np
import torch

from aircraft_tpu_torch.config import NETWORKPATH
from aircraft_tpu_torch.device import resolve_device
from aircraft_tpu_torch.ops.autodiff import batched_jacfwd

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


def _with_cn(out: torch.Tensor, cn_rudder, rudder) -> torch.Tensor:
    """``out`` with the rudder's yawing moment added to its Cn column."""
    cn = out[..., 5] + cn_rudder * 6.0 * rudder * DEG2RAD
    return torch.cat([out[..., :5], cn[..., None]], dim=-1)


def _tensors(arrays, keys, device) -> dict:
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(arrays[k], np.float32), device=dev)
            for k in keys}


def _moved(cp, keys, device):
    """``cp`` with its tensors ``keys`` passed through ``Tensor.to(device)``;
    a dtype casts the floating ones only (the polynomial's factor indices
    stay integers)."""
    def move(t):
        if isinstance(device, torch.dtype) and not t.is_floating_point():
            return t
        return t.to(device)

    return replace(cp, **{k: move(getattr(cp, k)) for k in keys})


# ---------------------------------------------------------------------------
# default — hard-coded linear aero
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# linear — affine map from the fitted CSV
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LinearCoeffParams:
    """(6, 6): rows [CX, CY, CZ, Cl, Cm, Cn], columns [qbar, alpha, beta,
    aileron, elevator, 1]."""

    matrix: torch.Tensor
    Cn_rudder: float = -0.1

    @classmethod
    def from_csv(cls, path, device="cuda") -> "LinearCoeffParams":
        """The CSV's header row, then six rows of six numbers."""
        m = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
        return linear_from_numpy({"matrix": m}, device)

    def to(self, device) -> "LinearCoeffParams":
        return _moved(self, ("matrix",), device)


def linear_from_numpy(arrays, device="cuda") -> LinearCoeffParams:
    kw = _tensors(arrays, ("matrix",), device)
    if "Cn_rudder" in arrays:
        kw["Cn_rudder"] = float(np.asarray(arrays["Cn_rudder"]))
    return LinearCoeffParams(**kw)


def _linear_forward(cp: LinearCoeffParams, x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1) @ cp.matrix.T


def _apply_linear(cp: LinearCoeffParams, aero: AeroState, aileron, elevator,
                  rudder):
    out = _linear_forward(cp, model_inputs(aero, aileron, elevator))
    return _with_cn(out, cp.Cn_rudder, rudder)


# ---------------------------------------------------------------------------
# poly — polynomial features + per-surface re-evaluation
# ---------------------------------------------------------------------------


def polynomial_exponents(num_inputs: int = 5, degree: int = 3) -> np.ndarray:
    """Exponent matrix of all monomials with 1 <= total degree <= degree,
    ordered like sklearn's PolynomialFeatures(include_bias=False)."""
    rows = []
    for d in range(1, degree + 1):
        for combo in combinations_with_replacement(range(num_inputs), d):
            e = np.zeros(num_inputs, dtype=np.int32)
            for idx in combo:
                e[idx] += 1
            rows.append(e)
    return np.stack(rows)


def _factor_index(exps: np.ndarray) -> np.ndarray:
    """(F, degree) input indices whose product is each monomial of the
    exponent matrix exps (F, n), padded with the index n of an appended
    column of ones."""
    n, degree = exps.shape[1], int(exps.sum(axis=1).max())
    rows = [sum(([i] * int(c) for i, c in enumerate(e)), []) for e in exps]
    return np.array([r + [n] * (degree - len(r)) for r in rows], np.int64)


@dataclass(frozen=True)
class PolyCoeffParams:
    """Monomial weights (6, F) and intercept (6,) over scaled inputs, the
    monomials in ``polynomial_exponents`` order; ``factor_index`` (F,
    degree) lists each monomial's factors."""

    weights: torch.Tensor       # (6, F)
    intercept: torch.Tensor     # (6,)
    input_scale: torch.Tensor   # (5,)
    factor_index: torch.Tensor  # (F, degree) int64
    span_over_4: float = 0.5    # b/4 lever arm of the wing-asymmetry roll
    Cn_rudder: float = 0.01

    @classmethod
    def make(cls, weights, intercept, span: float = 2.0, degree: int = 3,
             input_scale=None, device="cuda") -> "PolyCoeffParams":
        exps = polynomial_exponents(5, degree)
        weights = np.asarray(weights, np.float32)
        if weights.shape != (6, len(exps)):
            raise ValueError(f"poly weights {weights.shape}, expected "
                             f"{(6, len(exps))}")
        scale = (np.ones(5, np.float32) if input_scale is None
                 else input_scale)
        dev = resolve_device(device)
        kw = _tensors({"weights": weights, "intercept": intercept,
                       "input_scale": scale},
                      ("weights", "intercept", "input_scale"), dev)
        return cls(factor_index=torch.as_tensor(_factor_index(exps),
                                                device=dev),
                   span_over_4=span / 4.0, **kw)

    def to(self, device) -> "PolyCoeffParams":
        return _moved(self, ("weights", "intercept", "input_scale",
                             "factor_index"), device)


def poly_from_numpy(arrays, device="cuda") -> PolyCoeffParams:
    """Keys of ``poly.npz`` (weights, intercept, input_scale,
    span_over_4), Cn_rudder optional."""
    cp = PolyCoeffParams.make(
        weights=arrays["weights"], intercept=arrays["intercept"],
        span=float(np.asarray(arrays["span_over_4"])) * 4.0,
        input_scale=arrays["input_scale"], device=device)
    if "Cn_rudder" in arrays:
        cp = replace(cp, Cn_rudder=float(np.asarray(arrays["Cn_rudder"])))
    return cp


def poly_from_npz(path, device="cuda") -> PolyCoeffParams:
    """The polynomial model saved by the reference's fit script."""
    with np.load(path) as d:
        return poly_from_numpy({k: d[k] for k in d.files}, device)


def _poly_features(x: torch.Tensor, factor_index: torch.Tensor):
    """Every monomial of x (..., 5) -> (..., F), each as a product of
    gathered factors.  A power with a float exponent would bring log(x)
    into its forward-mode derivative, NaN at the negative inputs (alpha,
    beta, the surfaces) this model sees."""
    xo = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
    feats = xo[..., factor_index[:, 0]]
    for j in range(1, factor_index.shape[1]):
        feats = feats * xo[..., factor_index[:, j]]
    return feats


def _poly_eval(cp: PolyCoeffParams, x: torch.Tensor) -> torch.Tensor:
    feats = _poly_features(x * cp.input_scale, cp.factor_index)
    return feats @ cp.weights.T + cp.intercept


def _apply_poly(cp: PolyCoeffParams, aero: AeroState, aileron, elevator,
                rudder):
    cols = list(_poly_eval(cp, model_inputs(aero, aileron, elevator))
                .unbind(-1))
    # wing-asymmetry roll moment from each wing's local flow
    zeros = torch.zeros_like(aero.alpha)
    lw = torch.stack([aero.left_wing_qbar, aero.left_wing_alpha, zeros,
                      zeros, zeros], dim=-1)
    rw = torch.stack([aero.right_wing_qbar, aero.right_wing_alpha, zeros,
                      zeros, zeros], dim=-1)
    lw_cz = _poly_eval(cp, lw)[..., 2]
    rw_cz = _poly_eval(cp, rw)[..., 2]
    cols[3] = cols[3] + cp.span_over_4 * (rw_cz / 2.0 - lw_cz / 2.0)
    # elevator pitching moment at the pitch-rate-corrected alpha
    el = torch.stack([aero.qbar, aero.elevator_alpha, aero.beta, aileron,
                      elevator], dim=-1)
    cols[4] = _poly_eval(cp, el)[..., 4]
    # rudder yawing moment at the yaw-rate-corrected beta
    rud = torch.stack([aero.qbar, aero.alpha, aero.rudder_beta, aileron,
                       elevator], dim=-1)
    cols[5] = (_poly_eval(cp, rud)[..., 5]
               + cp.Cn_rudder * 6.0 * rudder * DEG2RAD)
    return torch.stack(cols, dim=-1)


# ---------------------------------------------------------------------------
# nn and nn_mini — the MLP surrogates
# ---------------------------------------------------------------------------


def _uniform(generator, fan_in, fan_out, scale):
    bound = scale / np.sqrt(fan_in)
    return (2.0 * torch.rand((fan_in, fan_out), generator=generator)
            - 1.0) * bound


class _MLPParams:
    """Shared constructors of the two MLP layouts (fields ``MLP_KEYS``)."""

    @classmethod
    def init(cls, generator: torch.Generator, scale: float = 0.5,
             device="cuda"):
        """Uniform(±scale/√fan_in) weights drawn from ``generator``, zero
        biases, identity scalers."""
        dev = resolve_device(device)
        w = [_uniform(generator, a, b, scale)
             for a, b in ((5, 16), (16, 32), (32, 6))]
        return cls(w0=w[0], b0=torch.zeros(16), w1=w[1], b1=torch.zeros(32),
                   w2=w[2], b2=torch.zeros(6), input_mean=torch.zeros(5),
                   input_std=torch.ones(5), output_mean=torch.zeros(6),
                   output_std=torch.ones(6)).to(dev)

    @classmethod
    def from_numpy(cls, arrays, device="cuda"):
        """From a mapping of numpy arrays keyed ``MLP_KEYS`` (+ Cn_rudder)."""
        kw = _tensors(arrays, MLP_KEYS, device)
        if "Cn_rudder" in arrays:
            kw["Cn_rudder"] = float(np.asarray(arrays["Cn_rudder"]))
        return cls(**kw)

    def to(self, device):
        return _moved(self, MLP_KEYS, device)


@dataclass(frozen=True)
class MLPCoeffParams(_MLPParams):
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

    @classmethod
    def from_torch_checkpoint(cls, path, device="cuda") -> "MLPCoeffParams":
        """The reference's ``.pth`` layout: ``model_state_dict`` with
        ``core_layers.{0,1,3}`` and the four scaler tensors."""
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        sd = ckpt["model_state_dict"]
        return cls.from_numpy({
            "w0": sd["core_layers.0.weight"].T, "b0": sd["core_layers.0.bias"],
            "w1": sd["core_layers.1.weight"].T, "b1": sd["core_layers.1.bias"],
            "w2": sd["core_layers.3.weight"].T, "b2": sd["core_layers.3.bias"],
            **{k: ckpt[k] for k in ("input_mean", "input_std",
                                    "output_mean", "output_std")}}, device)


@dataclass(frozen=True)
class MiniMLPCoeffParams(_MLPParams):
    """MiniModel: standardise -> Linear(5,16) -> ELU -> Linear(16,32) ->
    ELU -> Linear(32,6) -> de-standardise."""

    w0: torch.Tensor
    b0: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    input_mean: torch.Tensor
    input_std: torch.Tensor
    output_mean: torch.Tensor
    output_std: torch.Tensor
    Cn_rudder: float = -0.1


def mlp_from_numpy(arrays, device="cuda") -> MLPCoeffParams:
    """MLP parameters from a mapping of numpy arrays (the keys of
    ``data/networks/mlp.npz``: w0..b2, in/out mean/std, Cn_rudder)."""
    return MLPCoeffParams.from_numpy(arrays, device)


def mini_mlp_from_numpy(arrays, device="cuda") -> MiniMLPCoeffParams:
    return MiniMLPCoeffParams.from_numpy(arrays, device)


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


def mini_mlp_forward(cp: MiniMLPCoeffParams, x: torch.Tensor) -> torch.Tensor:
    h = (x - cp.input_mean) / cp.input_std
    h = torch.nn.functional.elu(h @ cp.w0 + cp.b0)
    h = torch.nn.functional.elu(h @ cp.w1 + cp.b1)
    h = h @ cp.w2 + cp.b2
    return h * cp.output_std + cp.output_mean


def _apply_mlp(cp: MLPCoeffParams, aero: AeroState, aileron, elevator,
               rudder):
    out = mlp_forward(cp, model_inputs(aero, aileron, elevator))
    return _with_cn(out, cp.Cn_rudder, rudder)


def _apply_mini_mlp(cp: MiniMLPCoeffParams, aero: AeroState, aileron,
                    elevator, rudder):
    out = mini_mlp_forward(cp, model_inputs(aero, aileron, elevator))
    return _with_cn(out, cp.Cn_rudder, rudder)


# ---------------------------------------------------------------------------
# nn_taylor — first-order expansion of another model about an anchor
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TaylorCoeffParams:
    """C(x) ≈ value + J (x − anchor), the affine expansion of a model whose
    raw forward ``raw_forward`` knows, about an anchor input."""

    anchor: torch.Tensor   # (5,) [qbar, alpha, beta, da, de]
    value: torch.Tensor    # (6,) the model's output at the anchor
    jac: torch.Tensor      # (6, 5) its Jacobian there
    Cn_rudder: float = -0.1

    @classmethod
    def from_model(cls, cp, anchor) -> "TaylorCoeffParams":
        """Anchor ``cp`` (any params ``raw_forward`` is registered for)
        about ``anchor`` (5,), placed on ``cp``'s device."""
        dev = _device_of(cp)
        anchor = torch.as_tensor(anchor, dtype=torch.float32, device=dev)
        f = lambda x: raw_forward(cp, x)
        return cls(anchor=anchor, value=f(anchor),
                   jac=batched_jacfwd(f, anchor[None])[0],
                   Cn_rudder=getattr(cp, "Cn_rudder", -0.1))

    def to(self, device) -> "TaylorCoeffParams":
        return _moved(self, ("anchor", "value", "jac"), device)


def taylor_from_numpy(arrays, device="cuda") -> TaylorCoeffParams:
    kw = _tensors(arrays, ("anchor", "value", "jac"), device)
    if "Cn_rudder" in arrays:
        kw["Cn_rudder"] = float(np.asarray(arrays["Cn_rudder"]))
    return TaylorCoeffParams(**kw)


def _device_of(cp) -> torch.device:
    for f in fields(cp):
        v = getattr(cp, f.name)
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def _taylor_eval(cp: TaylorCoeffParams, x: torch.Tensor) -> torch.Tensor:
    return cp.value + (x - cp.anchor) @ cp.jac.T


def _apply_taylor(cp: TaylorCoeffParams, aero: AeroState, aileron,
                  elevator, rudder):
    out = _taylor_eval(cp, model_inputs(aero, aileron, elevator))
    return _with_cn(out, cp.Cn_rudder, rudder)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


@singledispatch
def raw_forward(cp: Any, x: torch.Tensor) -> torch.Tensor:
    """Raw (..., 5) -> (..., 6) forward of a model on explicit inputs,
    without the per-surface corrections: what the Taylor mode expands."""
    raise TypeError(f"No raw forward registered for: {type(cp)}")


raw_forward.register(MLPCoeffParams, mlp_forward)
raw_forward.register(MiniMLPCoeffParams, mini_mlp_forward)
raw_forward.register(LinearCoeffParams, _linear_forward)
# PolyCoeffParams is deliberately not registered: _apply_poly adds the
# per-surface re-evaluations to _poly_eval, so an expansion of the raw
# forward would drop that rate-damping physics.


@singledispatch
def apply_coefficients(cp: Any, aero: AeroState, aileron, elevator,
                       rudder) -> torch.Tensor:
    raise TypeError(f"Unknown coefficient params type: {type(cp)}")


apply_coefficients.register(DefaultCoeffParams, _apply_default)
apply_coefficients.register(LinearCoeffParams, _apply_linear)
apply_coefficients.register(PolyCoeffParams, _apply_poly)
apply_coefficients.register(MLPCoeffParams, _apply_mlp)
apply_coefficients.register(MiniMLPCoeffParams, _apply_mini_mlp)
apply_coefficients.register(TaylorCoeffParams, _apply_taylor)


COEFF_MODEL_REGISTRY = {
    "default": DefaultCoeffParams,
    "linear": LinearCoeffParams,
    "poly": PolyCoeffParams,
    "nn": MLPCoeffParams,
    "nn_mini": MiniMLPCoeffParams,
    "nn_taylor": TaylorCoeffParams,
}


def load_coefficient_model(kind: str, path=None, device="cuda"):
    """A model by name and artifact: 'default' needs none, 'linear' reads
    a CSV, 'poly' an npz, 'nn' an npz or the reference's ``.pth``."""
    if kind == "default":
        return DefaultCoeffParams()
    if kind == "linear":
        return LinearCoeffParams.from_csv(path, device)
    if kind == "poly":
        return poly_from_npz(path, device)
    if kind == "nn":
        if str(path).endswith(".pth"):
            return MLPCoeffParams.from_torch_checkpoint(path, device)
        return load_mlp(path, device)
    raise ValueError(f"unknown coefficient model kind: {kind}")


def default_artifact_coeff(kind: str, device="cuda"):
    """The model of ``kind`` from the repo's fitted artifacts
    (``data/networks/{linearised.csv, poly.npz, mlp.npz}``).  'nn' is
    ``default_nn_coeff``; a missing linear or poly artifact falls back to
    'default' with a warning (a random affine map is no aero model)."""
    if kind == "default":
        return DefaultCoeffParams()
    if kind == "nn":
        return default_nn_coeff(device=device)
    path = {"linear": NETWORKPATH / "linearised.csv",
            "poly": NETWORKPATH / "poly.npz"}[kind]
    if not path.exists():
        warnings.warn(f"{kind} artifact missing at {path}; using 'default'")
        return DefaultCoeffParams()
    return load_coefficient_model(kind, path, device)


def default_nn_coeff(path=None, device="cuda") -> MLPCoeffParams:
    """The trained surrogate at ``data/networks/mlp.npz`` when present,
    else a random MLP (``torch.Generator`` seed 0) with plausible input
    and output scalers: an unscaled random MLP has no trim."""
    path = NETWORKPATH / "mlp.npz" if path is None else Path(path)
    if path.exists():
        return load_mlp(path, device)
    cp = MLPCoeffParams.init(torch.Generator().manual_seed(0), device=device)
    scalers = _tensors({
        "input_mean": [1500.0, 0.0, 0.0, 0.0, 0.0],
        "input_std": [1000.0, 0.15, 0.15, 3.0, 3.0],
        "output_mean": [-0.05, 0.0, -0.4, 0.0, 0.0, 0.0],
        "output_std": [0.05, 0.05, 0.3, 0.03, 0.1, 0.01]},
        ("input_mean", "input_std", "output_mean", "output_std"), device)
    return replace(cp, **scalers)


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


__all__ = ["AeroState", "COEFF_MODEL_REGISTRY", "DefaultCoeffParams",
           "LinearCoeffParams", "MLPCoeffParams", "MiniMLPCoeffParams",
           "PolyCoeffParams", "TaylorCoeffParams", "apply_coefficients",
           "default_artifact_coeff", "default_coeff_vector",
           "default_nn_coeff", "fold_mlp", "linear_from_numpy",
           "load_coefficient_model", "load_mlp", "mini_mlp_forward",
           "mini_mlp_from_numpy", "mlp_forward", "mlp_from_numpy",
           "model_inputs", "poly_from_npz", "poly_from_numpy",
           "polynomial_exponents", "raw_forward", "taylor_from_numpy"]
