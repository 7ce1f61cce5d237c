"""The course-recipe reference track and the MHTT knobs of the course
recipe, shared with the serving bench so its fleet flies the geometry and
formulation the full course flies."""

from __future__ import annotations

from typing import Optional

import numpy as np

from aircraft_tpu_torch.config import TrajectoryConfig
from aircraft_tpu_torch.control.initialisation import DubinsInitialiser


def course_track(config: TrajectoryConfig, *, v_ref: float,
                 v0_init: Optional[float] = None, glide_ld: float = 13.0,
                 r_min: Optional[float] = None, r_min_per_segment=None,
                 track_extend: float = 150.0,
                 n_track_points: int = 512) -> DubinsInitialiser:
    """Reference track of the course recipe: a flyable glide z-profile for
    2D objectives, turn radii sized for the flight speed with a wide first
    turnaround, and a straight run-out past the final waypoint."""
    two_d = len([i for i in config.waypoints.waypoint_indices if i < 3]) < 3
    x0_np = np.asarray(config.waypoints.initial_state, dtype=np.float32)
    if v0_init is None:
        v0_init = float(np.linalg.norm(x0_np[3:6]))
    if r_min is None:
        r_min = (v_ref + 4.0) ** 2 / 9.81
    if (r_min_per_segment is None and two_d
            and len(config.waypoints.waypoints) > 1):
        r_fast = (0.8 * max(v0_init, v_ref)) ** 2 / 9.81
        r_slow = max((v_ref + 6.0) ** 2 / 9.81, 80.0)
        pts = config.waypoints.all_points()
        diffs = np.diff(pts[:, :2], axis=0)
        seg_psi = np.arctan2(diffs[:, 1], diffs[:, 0])
        psi_prev = (float(np.arctan2(x0_np[4], x0_np[3]))
                    if np.hypot(x0_np[3], x0_np[4]) > 1e-6 else seg_psi[0])
        r_min_per_segment = []
        first_rev_seen = False
        for i in range(len(seg_psi)):
            turn = np.arctan2(np.sin(seg_psi[i] - psi_prev),
                              np.cos(seg_psi[i] - psi_prev))
            if abs(turn) > np.pi / 2 and not first_rev_seen:
                r_min_per_segment.append(r_fast)
                first_rev_seen = True
            else:
                r_min_per_segment.append(r_slow)
            psi_prev = seg_psi[i]

    return DubinsInitialiser(
        config, r_min=r_min, n_track_points=n_track_points,
        z_mode="glide" if two_d else "waypoints", glide_ld=glide_ld,
        r_min_per_segment=r_min_per_segment, extend=track_extend)


# MHTT/OCP knobs of the course recipe
COURSE_OCP_KNOBS = dict(
    w_speed=0.2, w_rate=0.2, alpha_guard_deg=10.0, beta_guard_deg=9.0,
    progress_correction=0.10, stall_guard=(0.0, 20.0),
    envelope_overrides={
        "speed_bounds": (20.0, 100.0),
        "alpha_limit_deg": 20.0,
        "beta_limit_deg": 10.0,
    },
)
