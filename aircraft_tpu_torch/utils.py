"""Trajectory snapshots: ``TrajectoryData``, what a flight log loads into
(``native/telemetry.flight_log_to_trajectory``) and what the ablation
saves per case, with its npz round trip, and ``perturb_quaternion``.  The
reference module's state/control containers, aero conversions and HDF5
checkpoints are not ported yet (the HDF5 pair needs ``h5py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class TrajectoryData:
    """A solved or flown trajectory snapshot."""

    state: np.ndarray                      # (T+1, 13)
    control: Optional[np.ndarray] = None   # (T, m)
    time: Optional[np.ndarray] = None      # (T,) or scalar horizon time
    lam: Optional[np.ndarray] = None       # track progress, if any

    def save_npz(self, path) -> None:
        data = {"state": self.state}
        for k in ("control", "time", "lam"):
            v = getattr(self, k)
            if v is not None:
                data[k] = np.asarray(v)
        np.savez_compressed(path, **data)

    @classmethod
    def load_npz(cls, path) -> "TrajectoryData":
        with np.load(path) as d:
            return cls(**{k: d[k] for k in ("state", "control", "time", "lam")
                          if k in d.files})


def perturb_quaternion(q, delta_theta: float = 0.01, rng=None) -> np.ndarray:
    """A unit quaternion (xyzw) turned by a small random rotation of angle
    ``delta_theta`` about an axis drawn from ``rng``."""
    from scipy.spatial.transform import Rotation as R

    rng = rng if rng is not None else np.random.default_rng()
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    dq = R.from_rotvec(delta_theta * axis)
    return (R.from_quat(np.asarray(q)) * dq).as_quat(canonical=True)
