"""Dubins-based reference tracks and warm starts.

Host-side numpy builds the geometric path through the waypoints (3D Dubins
per segment, straight-line fallback), arc-length resampled to a uniform
point table.  The solver reads the track as a uniform Catmull-Rom spline
(``catmull_rom_eval`` / ``catmull_rom_tangent``) over that table.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from aircraft_tpu_torch.config import TrajectoryConfig
from aircraft_tpu_torch.dubins.dubins3d import maneuver3d, straight_line_fallback
from aircraft_tpu_torch.ops import quaternion as quat
from aircraft_tpu_torch.ops.elementwise import clip


def _segment(points: torch.Tensor, s: torch.Tensor):
    """Control points p0..p3 (each (..., d)) and the local parameter t
    (..., 1) of the spline segment holding s.  The segment index carries
    no derivative; t carries all of it."""
    M = points.shape[0]
    u = clip(s, 0.0, 1.0) * (M - 1)
    i = torch.clamp(torch.floor(u).to(torch.int64), 0, M - 2)
    t = (u - i.to(u.dtype))[..., None]
    p0 = points[torch.clamp(i - 1, 0, M - 1)]
    p1 = points[i]
    p2 = points[torch.clamp(i + 1, 0, M - 1)]
    p3 = points[torch.clamp(i + 2, 0, M - 1)]
    return p0, p1, p2, p3, t


def catmull_rom_eval(points: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Uniform Catmull-Rom spline through ``points`` (M, d) at normalised
    parameter s in [0, 1]; broadcasts over the axes of s."""
    p0, p1, p2, p3, t = _segment(points, s)
    t2 = t * t
    t3 = t2 * t
    return 0.5 * ((2.0 * p1)
                  + (-p0 + p2) * t
                  + (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3) * t2
                  + (-p0 + 3.0 * p1 - 3.0 * p2 + p3) * t3)


def catmull_rom_tangent(points: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """d(eval)/ds, the analytic derivative of the spline basis."""
    M = points.shape[0]
    p0, p1, p2, p3, t = _segment(points, s)
    t2 = t * t
    dp_du = 0.5 * ((-p0 + p2)
                   + 2.0 * (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3) * t
                   + 3.0 * (-p0 + 3.0 * p1 - 3.0 * p2 + p3) * t2)
    return dp_du * (M - 1)


class DubinsInitialiser:
    """Geometric reference path through the problem's waypoints, its
    uniform point table ``track_points`` (M, 3) float32, and full-state
    warm starts along it.  ``z_mode='glide'`` lays z along the achievable
    glide slope 1/``glide_ld`` instead of the waypoint altitudes."""

    def __init__(self, config: TrajectoryConfig, *, n_track_points: int = 256,
                 pitch_limit_deg: float = 15.0, r_min: Optional[float] = None,
                 z_mode: str = "waypoints", glide_ld: float = 12.0,
                 r_min_per_segment: Optional[list] = None,
                 extend: float = 0.0):
        self.config = config
        wps = config.waypoints.all_points()
        if z_mode == "glide":
            wps = wps.copy()
            wps[:, 2] = wps[0, 2]
        speed = config.waypoints.default_velocity
        r_min = r_min if r_min is not None else max(
            config.aircraft.r_min,
            speed ** 2 / (9.81 * np.tan(np.deg2rad(45.0))))
        lim = np.deg2rad(pitch_limit_deg)

        diffs = np.diff(wps, axis=0)
        seg_psi = np.arctan2(diffs[:, 1], diffs[:, 0])
        seg_gamma = np.clip(
            np.arctan2(diffs[:, 2], np.hypot(diffs[:, 0], diffs[:, 1])),
            -lim, lim)
        psi = np.concatenate([seg_psi[:1], seg_psi])
        gamma = np.concatenate([seg_gamma[:1], seg_gamma])
        # interior waypoints: average in/out headings, but keep the
        # incoming heading at reversals (> 90 degree course change) so the
        # track flies through the waypoint and turns inside the next segment
        for i in range(1, len(wps) - 1):
            turn = np.arctan2(np.sin(seg_psi[i] - seg_psi[i - 1]),
                              np.cos(seg_psi[i] - seg_psi[i - 1]))
            if abs(turn) > np.pi / 2:
                psi[i] = seg_psi[i - 1]
            else:
                psi[i] = np.arctan2(np.sin(seg_psi[i - 1]) + np.sin(seg_psi[i]),
                                    np.cos(seg_psi[i - 1]) + np.cos(seg_psi[i]))
            gamma[i] = 0.5 * (seg_gamma[i - 1] + seg_gamma[i])

        v0 = np.array(config.waypoints.initial_state[3:6])
        if np.linalg.norm(v0[:2]) > 1e-6:
            psi[0] = np.arctan2(v0[1], v0[0])
            gamma[0] = np.clip(np.arctan2(v0[2], np.linalg.norm(v0[:2])),
                               -lim, lim)

        sample_blocks = []
        self.segment_lengths = []
        for i in range(len(wps) - 1):
            qi = np.array([*wps[i], psi[i], gamma[i]])
            qf = np.array([*wps[i + 1], psi[i + 1], gamma[i + 1]])
            r_i = (float(r_min_per_segment[min(i, len(r_min_per_segment) - 1)])
                   if r_min_per_segment else r_min)
            m = maneuver3d(qi, qf, r_i, pitch_limits=(-lim, lim))
            if m is not None:
                samples = m.sample_many(96)
                self.segment_lengths.append(m.length)
            else:
                samples = straight_line_fallback(qi, qf, 96)
                self.segment_lengths.append(
                    float(np.linalg.norm(wps[i + 1] - wps[i])))
            sample_blocks.append(samples if i == 0 else samples[1:])
        if extend > 0.0:
            # straight run-out past the final waypoint
            last = sample_blocks[-1][-1]
            n_ext = max(4, int(extend / 10.0))
            t_ext = np.linspace(0.0, extend, n_ext + 1)[1:]
            dxy = np.array([np.cos(last[3]), np.sin(last[3])])
            sample_blocks.append(np.stack(
                [last[0] + t_ext * dxy[0], last[1] + t_ext * dxy[1],
                 np.full_like(t_ext, last[2]), np.full_like(t_ext, last[3]),
                 np.zeros_like(t_ext)], axis=1))
            self.segment_lengths.append(float(extend))
        raw = np.concatenate(sample_blocks, axis=0)

        seg = np.linalg.norm(np.diff(raw[:, :3], axis=0), axis=1)
        s_raw = np.concatenate([[0.0], np.cumsum(seg)])
        self.total_length = float(s_raw[-1])
        s_uniform = np.linspace(0.0, self.total_length, n_track_points)
        resampled = np.stack(
            [np.interp(s_uniform, s_raw, raw[:, j]) for j in range(3)], axis=1)
        psi_u = np.interp(s_uniform, s_raw, np.unwrap(raw[:, 3]))
        gamma_u = np.interp(s_uniform, s_raw, raw[:, 4])
        if z_mode == "glide":
            resampled[:, 2] = wps[0, 2] + s_uniform / glide_ld
            gamma_u = np.full_like(gamma_u, np.arctan2(1.0, glide_ld))

        self.track_points = torch.as_tensor(resampled, dtype=torch.float32)
        self._psi = psi_u
        self._gamma = gamma_u
        self._s_uniform = s_uniform
        self.speed = float(speed)

    def length(self) -> float:
        return self.total_length

    def eval(self, s) -> torch.Tensor:
        return catmull_rom_eval(self.track_points, torch.as_tensor(s))

    def eval_tangent(self, s) -> torch.Tensor:
        return catmull_rom_tangent(self.track_points, torch.as_tensor(s))

    def state_guess(self, num_nodes: int) -> np.ndarray:
        """(num_nodes + 1, 13) full-state warm start along the track:
        coordinated-turn attitude and finite-difference body rates."""
        s = np.linspace(0.0, 1.0, num_nodes + 1)
        s32 = torch.as_tensor(s, dtype=torch.float32)
        pos = self.eval(s32).numpy()
        tan = self.eval_tangent(s32).numpy()
        tan_norm = tan / np.maximum(np.linalg.norm(tan, axis=-1, keepdims=True),
                                    1e-9)
        L = max(self.total_length, 1e-9)
        psi = np.interp(s, self._s_uniform / L, self._psi)
        gamma = np.interp(s, self._s_uniform / L, self._gamma)

        # coordinated-turn roll from lateral curvature: tan(phi) = v² κ / g
        ds = self.total_length / num_nodes
        kappa = np.gradient(np.unwrap(psi), s * L + 1e-12)
        phi = np.clip(np.arctan(self.speed ** 2 * kappa / 9.81),
                      -np.deg2rad(60), np.deg2rad(60))
        theta = -gamma
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
        q_t = quat.from_euler(f32(phi), f32(theta), f32(psi))
        q = q_t.numpy()

        vel = self.speed * tan_norm
        dt = ds / max(self.speed, 1e-9)
        omega = np.zeros((num_nodes + 1, 3))
        dq = quat.multiply(quat.conjugate(q_t[:-1]), q_t[1:]).numpy()
        omega[:-1] = 2.0 * dq[:, :3] / max(dt, 1e-9)
        omega[-1] = omega[-2]
        return np.concatenate([pos, vel, q, omega], axis=1).astype(np.float32)
