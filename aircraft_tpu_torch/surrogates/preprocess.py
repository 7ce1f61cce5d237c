"""Wind-tunnel / CFD aero-data preprocessing, host-side numpy.

Brings raw coefficient tables into the body-frame sign conventions the
dynamics expect, augments by lateral symmetry, and optionally rescales
dynamic pressure between Reynolds conditions.

Conventions produced (matching dynamics/aircraft.py):
  inputs  [qbar, alpha, beta, aileron, elevator]
  outputs [CX, CY, CZ, Cl, Cm, Cn]  — FRD body frame, CX forward-positive
          (drag shows as negative CX), CZ down-positive (lift negative).

A table is any mapping from column name to a 1-D array (a dict of numpy
arrays, or a pandas DataFrame by duck typing); nothing here needs pandas.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

INPUT_COLS = ["q", "alpha", "beta", "aileron", "elevator"]
OUTPUT_COLS = ["CX", "CY", "CZ", "Cl", "Cm", "Cn"]


def wind_to_body(
    CD: np.ndarray, CY_w: np.ndarray, CL: np.ndarray,
    alpha: np.ndarray, beta: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Wind-frame (drag, side, lift) -> body-frame (CX, CY, CZ).

    Standard stability-axes rotation: the reference documents the resulting
    sign conventions in preprocess.py's header block.
    """
    ca, sa = np.cos(alpha), np.sin(alpha)
    cb, sb = np.cos(beta), np.sin(beta)
    CX = -cb * ca * CD - sb * ca * CY_w + sa * CL
    CY = -sb * CD + cb * CY_w
    CZ = -cb * sa * CD - sb * sa * CY_w - ca * CL
    return CX, CY, CZ


def symmetry_augment(x: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Lateral mirror augmentation: a symmetric airframe's response at
    (β, δa) mirrors at (−β, −δa) with (CY, Cl, Cn) negated
    (reference preprocess.py symmetry block)."""
    x2 = x.copy()
    x2[:, 2] *= -1.0  # beta
    x2[:, 3] *= -1.0  # aileron
    y2 = y.copy()
    y2[:, 1] *= -1.0  # CY
    y2[:, 3] *= -1.0  # Cl
    y2[:, 5] *= -1.0  # Cn
    return np.concatenate([x, x2], axis=0), np.concatenate([y, y2], axis=0)


def reynolds_rescale(qbar: np.ndarray, from_speed: float, to_speed: float) -> np.ndarray:
    """Rescale dynamic pressure between reference airspeeds (coefficients
    are ~Re-invariant over the glider's envelope; qbar carries the speed)."""
    return qbar * (to_speed / from_speed) ** 2


def clean(x: np.ndarray, y: np.ndarray,
          alpha_range=(-0.6, 0.6), beta_range=(-0.6, 0.6),
          coeff_limit: float = 10.0) -> tuple[np.ndarray, np.ndarray]:
    """Drop non-finite rows, out-of-envelope angles, and absurd coefficient
    magnitudes (sensor/CFD spikes)."""
    m = np.all(np.isfinite(x), axis=1) & np.all(np.isfinite(y), axis=1)
    m &= (x[:, 1] >= alpha_range[0]) & (x[:, 1] <= alpha_range[1])
    m &= (x[:, 2] >= beta_range[0]) & (x[:, 2] <= beta_range[1])
    m &= np.all(np.abs(y) < coeff_limit, axis=1)
    return x[m], y[m]


def columns(table, names) -> np.ndarray:
    """(n, len(names)) float32 array of the named columns of ``table``,
    any mapping from column name to a 1-D array."""
    return np.stack([np.asarray(table[c], dtype=np.float32) for c in names],
                    axis=1)


def preprocess_dataframe(df, *, augment: bool = True):
    """Full pipeline on a reference-format table (column name -> array,
    a DataFrame included) -> (x, y)."""
    x = columns(df, INPUT_COLS)
    y = columns(df, OUTPUT_COLS)
    x, y = clean(x, y)
    if augment:
        x, y = symmetry_augment(x, y)
    return x, y


# ---------------------------------------------------------------------------
# Full-fidelity reference pipeline (reference main/surrogates/preprocess.py)
#
# The reference's raw CFD/wind-tunnel npz archives are not shipped (only the
# processed data/processed/data_sim.csv), so the conventions below are
# validated by ROUND TRIP: invert the pipeline on data_sim.csv rows to
# recover synthetic raw samples, run the forward pipeline, and require exact
# reproduction (tests/test_torch_surrogates.py holds the round trip).  Any
# wrong sign flip, rotation, centering, or scale breaks the round trip.
# ---------------------------------------------------------------------------

RHO = 1.225  # air density used throughout the reference pipeline

RAW_COLS = ("vel", "alpha", "beta", "ctrl1", "ctrl2",
            "fx", "fy", "fz", "mx", "my", "mz")

# axes flips the reference applies per source (preprocess.py main():462-466)
WT_AXES = np.array([-1.0, -1.0, 1.0, 1.0, 1.0, 1.0])
FS_AXES = np.array([-1.0, 1.0, 1.0, -1.0, 1.0, -1.0])


def wind_to_body_matrix(alpha: np.ndarray, beta: np.ndarray) -> np.ndarray:
    """Per-sample wind→body rotation, shape (n, 3, 3) — the reference's
    `R(alpha, beta)` including its final transpose (preprocess.py:99-123)."""
    ca, sa = np.cos(alpha), np.sin(alpha)
    cb, sb = np.cos(beta), np.sin(beta)
    z = np.zeros_like(ca)
    M = np.stack([
        np.stack([ca * cb, sb, cb * sa], axis=-1),
        np.stack([-sb * ca, cb, -sb * sa], axis=-1),
        np.stack([-sa, z, ca], axis=-1),
    ], axis=-2)
    return M


def process_sim_dataset(
    raw: dict,
    params: dict,
    goal_params: dict,
    *,
    degrees: bool = True,
    body: bool = False,
    augment: bool = True,
    axes: Optional[np.ndarray] = None,
) -> dict:
    """The reference's `process_sim_dataset` (preprocess.py:125-247) as a
    pure-numpy function over a dict of raw arrays (the npz archive's keys):
    per-axis sign repair, wind→body rotation at (−α, −β) unless already in
    the body frame, force/moment normalisation to coefficients with the
    CZ/Cl/Cn sign flips, control centering −(ctrl−5), α/β negation, dynamic-
    pressure rescale by the span ratio squared, and the xz-plane mirror
    augmentation.  Returns a dict of columns named like data_sim.csv."""
    if axes is None:
        axes = np.ones(6)
    axes = np.asarray(axes, dtype=float).reshape(6)
    S, b, c = params["reference_area"], params["span"], params["chord"]
    scale = b / goal_params["span"]

    q = 0.5 * RHO * np.asarray(raw["vel"], dtype=float) ** 2
    alpha = np.asarray(raw["alpha"], dtype=float)
    beta = np.asarray(raw["beta"], dtype=float)
    if degrees:
        alpha, beta = np.deg2rad(alpha), np.deg2rad(beta)

    M = (wind_to_body_matrix(np.zeros_like(alpha), np.zeros_like(beta))
         if body else wind_to_body_matrix(-alpha, -beta))
    F = np.stack([raw["fx"], raw["fy"], raw["fz"]], axis=-1).astype(float)
    Mo = np.stack([raw["mx"], raw["my"], raw["mz"]], axis=-1).astype(float)
    F = np.einsum("nij,nj->ni", M, F * axes[:3])
    Mo = np.einsum("nij,nj->ni", M, Mo * axes[3:])

    out = {
        "q": q * scale**2,
        "alpha": -alpha,
        "beta": -beta,
        "aileron": -(np.asarray(raw["ctrl1"], dtype=float) - 5.0),
        "elevator": -(np.asarray(raw["ctrl2"], dtype=float) - 5.0),
        "windtunnel": np.full(alpha.shape, not body),
        "CX": F[:, 0] / (q * S),
        "CY": F[:, 1] / (q * S),
        "CZ": -F[:, 2] / (q * S),
        "Cl": -Mo[:, 0] / (q * S * b),
        "Cm": Mo[:, 1] / (q * S * c),
        "Cn": -Mo[:, 2] / (q * S * b),
    }
    if augment:
        mirr = {k: v.copy() for k, v in out.items()}
        for k in ("beta", "CY", "Cl", "Cn", "aileron"):
            mirr[k] = -mirr[k]
        out = {k: np.concatenate([out[k], mirr[k]]) for k in out}
    return out


def finalise_body_frame(cols: dict) -> dict:
    """The reference main()'s final frame switch (preprocess.py:495-508):
    rotate the intermediate-frame coefficient triples by R(−α, −β), negate α
    back to the standard sign, and negate Cl/Cn.  Produces the exact column
    conventions of data/processed/data_sim.csv."""
    a, b = np.asarray(cols["alpha"]), np.asarray(cols["beta"])
    M = wind_to_body_matrix(-a, -b)
    F = np.einsum("nij,nj->ni",
                  M, np.stack([cols["CX"], cols["CY"], cols["CZ"]], axis=-1))
    Mo = np.einsum("nij,nj->ni",
                   M, np.stack([cols["Cl"], cols["Cm"], cols["Cn"]], axis=-1))
    out = dict(cols)
    out["alpha"] = -a
    out["CX"], out["CY"], out["CZ"] = F[:, 0], F[:, 1], F[:, 2]
    out["Cl"], out["Cm"], out["Cn"] = -Mo[:, 0], Mo[:, 1], -Mo[:, 2]
    return out


def invert_finalise(cols: dict) -> dict:
    """Exact inverse of `finalise_body_frame` (rotations are orthonormal)."""
    out = dict(cols)
    a = -np.asarray(cols["alpha"])  # pre-finalise alpha
    b = np.asarray(cols["beta"])
    Minv = np.transpose(wind_to_body_matrix(-a, -b), (0, 2, 1))
    Fm = np.stack([cols["CX"], cols["CY"], cols["CZ"]], axis=-1)
    Mm = np.stack([-np.asarray(cols["Cl"]), np.asarray(cols["Cm"]),
                   -np.asarray(cols["Cn"])], axis=-1)
    F = np.einsum("nij,nj->ni", Minv, Fm)
    Mo = np.einsum("nij,nj->ni", Minv, Mm)
    out["alpha"] = a
    out["CX"], out["CY"], out["CZ"] = F[:, 0], F[:, 1], F[:, 2]
    out["Cl"], out["Cm"], out["Cn"] = Mo[:, 0], Mo[:, 1], Mo[:, 2]
    return out


def invert_process(
    cols: dict,
    params: dict,
    goal_params: dict,
    *,
    body: bool = False,
    axes: Optional[np.ndarray] = None,
) -> dict:
    """Exact inverse of `process_sim_dataset` (augment=False): recovers the
    raw npz-convention arrays (wind-frame forces/moments, raw α/β in
    degrees, uncentered controls, unscaled velocity) from processed rows."""
    if axes is None:
        axes = np.ones(6)
    axes = np.asarray(axes, dtype=float).reshape(6)
    S, b, c = params["reference_area"], params["span"], params["chord"]
    scale = b / goal_params["span"]

    q = np.asarray(cols["q"], dtype=float) / scale**2
    alpha = -np.asarray(cols["alpha"], dtype=float)
    beta = -np.asarray(cols["beta"], dtype=float)

    F = np.stack([
        np.asarray(cols["CX"]) * (q * S),
        np.asarray(cols["CY"]) * (q * S),
        -np.asarray(cols["CZ"]) * (q * S),
    ], axis=-1)
    Mo = np.stack([
        -np.asarray(cols["Cl"]) * (q * S * b),
        np.asarray(cols["Cm"]) * (q * S * c),
        -np.asarray(cols["Cn"]) * (q * S * b),
    ], axis=-1)
    M = (wind_to_body_matrix(np.zeros_like(alpha), np.zeros_like(beta))
         if body else wind_to_body_matrix(-alpha, -beta))
    Minv = np.transpose(M, (0, 2, 1))
    F = np.einsum("nij,nj->ni", Minv, F) * axes[:3]
    Mo = np.einsum("nij,nj->ni", Minv, Mo) * axes[3:]
    return {
        "vel": np.sqrt(2.0 * q / RHO),
        "alpha": np.rad2deg(alpha),
        "beta": np.rad2deg(beta),
        "ctrl1": 5.0 - np.asarray(cols["aileron"], dtype=float),
        "ctrl2": 5.0 - np.asarray(cols["elevator"], dtype=float),
        "fx": F[:, 0], "fy": F[:, 1], "fz": F[:, 2],
        "mx": Mo[:, 0], "my": Mo[:, 1], "mz": Mo[:, 2],
    }
