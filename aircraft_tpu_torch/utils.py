"""Trajectory snapshots: ``TrajectoryData``, what a flight log loads into
(``native/telemetry.flight_log_to_trajectory``).  The reference module's
state/control containers, aero conversions and checkpoint IO are not
ported yet."""

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
