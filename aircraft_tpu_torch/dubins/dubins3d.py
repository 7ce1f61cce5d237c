"""3D Dubins maneuvers by lateral/vertical decoupling, host-side numpy.

Same decomposition as the reference (reference src/aircraft/dubins/
dubins3d.py): a horizontal Dubins path on (x, y, psi) plus a vertical
Dubins profile on (s, z, gamma) over the horizontal arc length, with the
curvature budget split between the two planes
(1/r_v² = 1/rho² − 1/r_h², reference dubins3d.py:133) and a local search
over the horizontal radius until the pitch profile fits the climb-angle
limits (reference dubins3d.py:86-100,141-149).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from aircraft_tpu_torch.dubins.dubins2d import DubinsPath, shortest_path
from aircraft_tpu_torch.dubins.vertical import vertical_profile


@dataclass
class DubinsManeuver3D:
    qi: np.ndarray                # (5,) = (x, y, z, psi, gamma)
    qf: np.ndarray                # (5,)
    rho: float                    # minimum 3D turn radius
    pitch_limits: tuple[float, float]
    lateral: DubinsPath           # on (x, y, psi)
    vertical: DubinsPath          # on (s, z, gamma)

    @property
    def length(self) -> float:
        """Path length measured along the vertical profile (its abscissa is
        the horizontal arc length, so its own length is the 3D length)."""
        return self.vertical.length

    def sample(self, s: float) -> np.ndarray:
        """(x, y, z, psi, gamma) at 3D arc length s."""
        v = self.vertical.sample(s)
        s_h, z, gamma = v
        lat = self.lateral.sample(s_h)
        return np.array([lat[0], lat[1], z, lat[2], gamma])

    def sample_many(self, n: int) -> np.ndarray:
        return np.stack([self.sample(s) for s in np.linspace(0.0, self.length, n)])


def _pitch_feasible(vertical: DubinsPath,
                    pitch_limits: tuple[float, float]) -> bool:
    """EXACT pitch-envelope check for a vertical-plane Dubins profile.

    The heading (= climb angle gamma) of a Dubins path is monotone within
    each segment (linear in arc length on arcs, constant on straights), so
    its extremes over the whole path occur at segment boundaries — checking
    the 4 boundary angles is exact, unlike the reference's construction-time
    handling (Vertical) or any finite sampling (which can certify a path
    whose pitch leaves the envelope between samples).  The UNWRAPPED
    cumulative heading is the physical pitch.  Feasibility also requires
    |gamma| <= pi/2 everywhere so the horizontal abscissa s is monotone
    (ds = cos(gamma) ds_path >= 0) and the lateral/vertical composition
    stays valid."""
    lo, hi = pitch_limits
    gamma = float(vertical.qi[2])
    gammas = [gamma]
    for seg_type, seg_len in zip(vertical.word, vertical.params):
        if seg_type == "L":
            gamma += float(seg_len)
        elif seg_type == "R":
            gamma -= float(seg_len)
        gammas.append(gamma)
    tol = 1e-9
    return all(
        (lo - tol <= g <= hi + tol) and (abs(g) <= np.pi / 2 + tol)
        for g in gammas
    )


def _try_maneuver(
    qi: np.ndarray,
    qf: np.ndarray,
    rho: float,
    r_h: float,
    pitch_limits: tuple[float, float],
) -> Optional[DubinsManeuver3D]:
    lateral = shortest_path(qi[[0, 1, 3]], qf[[0, 1, 3]], r_h)
    if lateral is None:
        return None

    # curvature split: what's left for the vertical plane
    if r_h <= rho:
        return None
    inv_rv_sq = 1.0 / rho**2 - 1.0 / r_h**2
    if inv_rv_sq <= 1e-12:
        return None
    r_v = 1.0 / np.sqrt(inv_rv_sq)

    vertical = shortest_path(
        np.array([0.0, qi[2], qi[4]]),
        np.array([lateral.length, qf[2], qf[4]]),
        r_v,
    )
    if vertical is None:
        return None

    # reject profiles whose climb angle leaves the envelope (exact
    # segment-boundary check; also guarantees the abscissa is monotone,
    # keeping the lateral composition valid)
    if not _pitch_feasible(vertical, pitch_limits):
        return None

    return DubinsManeuver3D(
        qi=qi, qf=qf, rho=rho, pitch_limits=pitch_limits,
        lateral=lateral, vertical=vertical,
    )


def maneuver3d(
    qi,
    qf,
    rho: float,
    pitch_limits: tuple[float, float] = (-np.deg2rad(15.0), np.deg2rad(15.0)),
    n_radius_search: int = 16,
) -> Optional[DubinsManeuver3D]:
    """Best-effort 3D maneuver: local search over the horizontal radius
    multiplier (the reference's optimisation loop, dubins3d.py:86-100),
    keeping the shortest feasible result."""
    qi = np.asarray(qi, dtype=float)
    qf = np.asarray(qf, dtype=float)

    best: Optional[DubinsManeuver3D] = None
    best_mult = None
    for mult in np.geomspace(1.01, 40.0, n_radius_search):
        m = _try_maneuver(qi, qf, rho, rho * mult, pitch_limits)
        if m is not None and (best is None or m.length < best.length):
            best, best_mult = m, mult
    if best is None:
        return None
    # local refinement around the coarse winner (the reference runs an
    # adaptive-step local optimisation over the radius multiplier,
    # reference dubins3d.py:86-100) — closes the ~1-3% length gap the
    # coarse geomspace leaves on the reference's own scenarios
    step = best_mult * 0.25
    while step > 1e-6 * best_mult:
        improved = False
        for cand in (best_mult - step, best_mult + step):
            if cand <= 1.0:
                continue
            m = _try_maneuver(qi, qf, rho, rho * cand, pitch_limits)
            if m is not None and m.length < best.length:
                best, best_mult, improved = m, cand, True
        if not improved:
            step *= 0.5
    return best


def straight_line_fallback(qi, qf, n: int = 64) -> np.ndarray:
    """(n, 5) straight-line samples — the reference's per-segment fallback
    when Dubins construction fails (reference control/initialisation.py:
    464-475)."""
    qi = np.asarray(qi, dtype=float)
    qf = np.asarray(qf, dtype=float)
    pts = np.linspace(qi[:3], qf[:3], n)
    d = qf[:3] - qi[:3]
    psi = np.arctan2(d[1], d[0])
    # slope angle in the (s, z) plane, z-down convention (matches the
    # vertical Dubins profile axes)
    gamma = np.arctan2(d[2], np.hypot(d[0], d[1]))
    cfg = np.zeros((n, 5))
    cfg[:, :3] = pts
    cfg[:, 3] = psi
    cfg[:, 4] = gamma
    return cfg


# ---------------------------------------------------------------------------
# length bounds (reference dubins3d.py:154-230: getLowerBound/getUpperBound)
# ---------------------------------------------------------------------------


def lower_bound(
    qi,
    qf,
    rho: float,
    pitch_limits: tuple[float, float] = (-np.pi / 4, np.pi / 2),
) -> float:
    """Lower bound on the 3D maneuver length: relax the lateral plane to the
    tighter spiral radius rho*cos(max pitch)^2 (a turn flown at full pitch
    projects onto a smaller horizontal circle) and fly the vertical plane at
    the full curvature budget rho — each plane individually optimistic, so
    the composition cannot exceed the true optimum
    (reference dubins3d.py:154-188).  When the exact vertical profile
    leaves the pitch envelope, falls back to the pitch-CLAMPED CSC
    construction (dubins/vertical.py — the reference's `Vertical` plays
    exactly this role in its getLowerBound): the clamped profile matches
    Δz at the envelope's steepest legal slope, so its length still
    under-estimates any feasible 3D maneuver.  Returns 0.0 only when even
    the clamped profile cannot be built."""
    qi = np.asarray(qi, dtype=float)
    qf = np.asarray(qf, dtype=float)
    spiral_radius = rho * np.cos(max(-pitch_limits[0], pitch_limits[1])) ** 2

    lateral = shortest_path(qi[[0, 1, 3]], qf[[0, 1, 3]], spiral_radius)
    if lateral is None:
        return 0.0
    vi = np.array([0.0, qi[2], qi[4]])
    vf = np.array([lateral.length, qf[2], qf[4]])
    vertical = shortest_path(vi, vf, rho)
    if vertical is not None and _pitch_feasible(vertical, pitch_limits):
        return float(vertical.length)
    clamped = vertical_profile(vi, vf, rho, pitch_limits)
    if clamped is None:
        return 0.0
    # both are relaxations (clamped drops the abscissa constraint, exact
    # drops the pitch constraint) — the tighter valid bound is their max
    return float(max(clamped.length,
                     vertical.length if vertical is not None else 0.0))


def upper_bound(
    qi,
    qf,
    rho: float,
    pitch_limits: tuple[float, float] = (-np.pi / 4, np.pi / 2),
) -> float:
    """Upper bound on the 3D maneuver length: fly BOTH planes at the
    conservative safe radius sqrt(2)*rho, which always leaves each plane
    enough curvature budget (1/(sqrt2 rho)^2 + 1/(sqrt2 rho)^2 = 1/rho^2) —
    any feasible decoupled construction at that radius is achievable, so its
    length bounds the optimum from above (reference dubins3d.py:190-230).
    Returns inf when endpoints are too close for the safe-radius
    construction or the vertical profile is infeasible."""
    qi = np.asarray(qi, dtype=float)
    qf = np.asarray(qf, dtype=float)
    safe_radius = np.sqrt(2.0) * rho

    if np.hypot(qf[0] - qi[0], qf[1] - qi[1]) < 4.0 * safe_radius:
        return float("inf")

    lateral = shortest_path(qi[[0, 1, 3]], qf[[0, 1, 3]], safe_radius)
    if lateral is None:
        return float("inf")
    vertical = shortest_path(
        np.array([0.0, qi[2], qi[4]]),
        np.array([lateral.length, qf[2], qf[4]]),
        safe_radius,
    )
    if vertical is None:
        return float("inf")
    # the bound is only valid if the certified path is actually flyable:
    # exact pitch check, no sampling gaps
    if not _pitch_feasible(vertical, pitch_limits):
        return float("inf")
    return float(vertical.length)
