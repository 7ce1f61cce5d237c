"""Containers, conversions and trajectory snapshots, host-side numpy.

The aero-condition to velocity conversions (``state_from_aero``), the
``State`` / ``Control`` containers, ``TrajectoryData`` (what a flight log
loads into, ``native/telemetry.flight_log_to_trajectory``, and what the
ablation and the examples save) with its npz and HDF5 round trips, and
``perturb_quaternion``.  The HDF5 layout is the reference's gzip'd
``iteration_<k>/{state,control,time}``, so either package reads the
other's file; ``h5py`` is imported only when a file is written or read.
"""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from aircraft_tpu_torch.config import RHO


def u_from_aero(qbar, alpha, beta):
    u_sq = ((1 - np.sin(beta) ** 2) * 2 * qbar) / ((1 + np.tan(alpha) ** 2) * RHO)
    return np.sqrt(u_sq)


def v_from_aero(qbar, alpha, beta):
    return np.sin(beta) * np.sqrt(qbar * 2 / RHO)


def w_from_aero(qbar, alpha, beta):
    return u_from_aero(qbar, alpha, beta) * np.tan(alpha)


def state_from_aero(qbar, alpha, beta) -> np.ndarray:
    """The 13-state [p, v, q, ω] at identity attitude whose velocity
    realises the flow condition (dynamic pressure, α, β in radians)."""
    x = np.zeros(13, dtype=np.float32)
    x[3] = u_from_aero(qbar, alpha, beta)
    x[4] = v_from_aero(qbar, alpha, beta)
    x[5] = w_from_aero(qbar, alpha, beta)
    x[9] = 1.0
    return x


@dataclass
class State:
    position: np.ndarray = field(default_factory=lambda: np.zeros(3))
    velocity: np.ndarray = field(default_factory=lambda: np.array([50.0, 0, 0]))
    orientation: np.ndarray = field(default_factory=lambda: np.array([0.0, 0, 0, 1]))
    angular_velocity: np.ndarray = field(default_factory=lambda: np.zeros(3))

    def as_vector(self) -> np.ndarray:
        return np.concatenate(
            [self.position, self.velocity, self.orientation,
             self.angular_velocity]).astype(np.float32)

    @classmethod
    def from_vector(cls, x) -> "State":
        x = np.asarray(x)
        return cls(position=x[0:3], velocity=x[3:6], orientation=x[6:10],
                   angular_velocity=x[10:13])


@dataclass
class Control:
    aileron: float = 0.0
    elevator: float = 0.0
    rudder: float = 0.0
    throttle: np.ndarray = field(default_factory=lambda: np.zeros(3))
    flaps: float = 0.0
    centre_of_mass: Optional[np.ndarray] = None

    def as_vector(self) -> np.ndarray:
        """[da, de, dr, thrust(3), flaps] (+ CoM(3) when set)."""
        v = np.concatenate([[self.aileron, self.elevator, self.rudder],
                            self.throttle, [self.flaps]])
        if self.centre_of_mass is not None:
            v = np.concatenate([v, self.centre_of_mass])
        return v.astype(np.float32)


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

    def save_h5(self, path, iteration: int = 0) -> None:
        """Append (or replace) ``iteration_<iteration>/{state,control,time}``
        in an HDF5 file, arrays of more than one element gzip'd."""
        import h5py

        with h5py.File(path, "a") as f:
            grp = f.require_group(f"iteration_{iteration}")
            for name in ("state", "control", "time"):
                data = getattr(self, name)
                if data is None:
                    continue
                if name in grp:
                    del grp[name]
                arr = np.asarray(data)
                if arr.size > 1:
                    grp.create_dataset(name, data=arr, compression="gzip")
                else:
                    grp.create_dataset(name, data=arr)

    @classmethod
    def load_h5(cls, path, iteration: Optional[int] = None) -> "TrajectoryData":
        """One iteration of an HDF5 file (the last one by default)."""
        import h5py

        with h5py.File(path, "r") as f:
            keys = sorted((k for k in f.keys() if k.startswith("iteration_")),
                          key=lambda k: int(k.split("_")[1]))
            grp = f[keys[-1] if iteration is None else f"iteration_{iteration}"]
            return cls(**{k: np.asarray(grp[k])
                          for k in ("state", "control", "time") if k in grp})


def missing_packages(*names: str) -> list:
    """Those of the host packages ``names`` (``h5py``, ``matplotlib``)
    this interpreter cannot import, found without importing any."""
    return [n for n in names if importlib.util.find_spec(n) is None]


def perturb_quaternion(q, delta_theta: float = 0.01, rng=None) -> np.ndarray:
    """A unit quaternion (xyzw) turned by a small random rotation of angle
    ``delta_theta`` about an axis drawn from ``rng``."""
    from scipy.spatial.transform import Rotation as R

    rng = rng if rng is not None else np.random.default_rng()
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    dq = R.from_rotvec(delta_theta * axis)
    return (R.from_quat(np.asarray(q)) * dq).as_quat(canonical=True)
