"""Pitch-constrained vertical-plane CSC maneuvers, host-side numpy.

Plays the role of the reference's `Vertical` (reference
src/aircraft/dubins/vertical.py:9-113): a Dubins-style arc–straight–arc
profile in the (s, z) plane whose straight-segment slope is CLAMPED to the
pitch envelope, with the >π-turn special cases resolved instead of looping.

Design differs from the reference's word-by-word closed forms: because the
climb angle γ never leaves (−π/2, π/2) in the vertical plane, the heading
is a plain scalar (no 2π wrapping) and a CSC profile is fully determined by
the straight-segment slope θ — arc 1 sweeps γ_i→θ, arc 2 sweeps θ→γ_f,
each monotone with |sweep| < π by construction (this IS the reference's
"turns > π" handling: its special cases zero-out a turn precisely to avoid
vertical loops).  The construction below picks θ (the exact 2D Dubins
slope when it fits the envelope, the clamped boundary value otherwise) and
sizes the straight to match Δz EXACTLY; when θ had to be clamped the final
abscissa may miss s_f (the reference's clamped `_LSR`/`_RSL` branches have
the same property — they match z, not x), so the result is flagged
``exact=False`` and is used only where an optimistic estimate is wanted
(length lower bounds, reference dubins3d.py:154-188).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from aircraft_tpu_torch.dubins.dubins2d import shortest_path


@dataclass
class VerticalCSC:
    """Arc–straight–arc profile in the (s, z) plane.

    ``sweeps = (t, q)`` are SIGNED arc sweeps in radians (positive = pull
    up / 'L'); ``straight`` is the straight-segment length; ``theta`` the
    straight slope.  ``exact`` marks whether the final abscissa matches the
    requested endpoint (False for pitch-clamped repairs)."""

    qi: np.ndarray            # (3,) = (s, z, gamma)
    qf: np.ndarray            # (3,)
    r: float
    theta: float
    sweeps: tuple[float, float]
    straight: float
    exact: bool

    @property
    def length(self) -> float:
        return float(
            (abs(self.sweeps[0]) + abs(self.sweeps[1])) * self.r + self.straight
        )

    def _arc_end(self, s, z, g0, g1):
        """Advance (s, z) along an arc from climb angle g0 to g1."""
        # ds = r·cosγ dγ·sign, dz = r·sinγ dγ·sign with sign = sweep direction
        if g1 >= g0:  # 'L' pull-up: ds = r dγ
            return (s + self.r * (np.sin(g1) - np.sin(g0)),
                    z - self.r * (np.cos(g1) - np.cos(g0)))
        # 'R' push-over: ds = -r dγ
        return (s - self.r * (np.sin(g1) - np.sin(g0)),
                z + self.r * (np.cos(g1) - np.cos(g0)))

    def sample(self, arc: float) -> np.ndarray:
        """(s, z, gamma) at path length `arc` from the start."""
        s, z, g = float(self.qi[0]), float(self.qi[1]), float(self.qi[2])
        arc = float(np.clip(arc, 0.0, self.length))
        # arc 1
        L1 = abs(self.sweeps[0]) * self.r
        if arc <= L1 and L1 > 0:
            g1 = g + np.sign(self.sweeps[0]) * arc / self.r
            s, z = self._arc_end(s, z, g, g1)
            return np.array([s, z, g1])
        s, z = self._arc_end(s, z, g, self.theta)
        arc -= L1
        # straight
        if arc <= self.straight:
            return np.array([s + arc * np.cos(self.theta),
                             z + arc * np.sin(self.theta), self.theta])
        s += self.straight * np.cos(self.theta)
        z += self.straight * np.sin(self.theta)
        arc -= self.straight
        # arc 2
        g2 = self.theta + np.sign(self.sweeps[1]) * min(
            arc / self.r, abs(self.sweeps[1]))
        s, z = self._arc_end(s, z, self.theta, g2)
        return np.array([s, z, g2])

    def sample_many(self, n: int) -> np.ndarray:
        return np.stack(
            [self.sample(a) for a in np.linspace(0.0, self.length, n)]
        )

    def pitch_range(self) -> tuple[float, float]:
        """Exact (min, max) climb angle over the whole profile — γ is
        monotone within each segment, so the extremes are among the three
        segment-boundary angles."""
        gs = (float(self.qi[2]), self.theta, float(self.qf[2]))
        return (min(gs), max(gs))


def _csc_at_theta(qi: np.ndarray, qf: np.ndarray, r: float,
                  theta: float) -> Optional[VerticalCSC]:
    """The unique CSC profile with straight slope theta that matches Δz
    exactly; the abscissa endpoint falls where it falls."""
    g_i, g_f = float(qi[2]), float(qf[2])
    t, q = theta - g_i, g_f - theta            # signed sweeps
    if abs(t) >= np.pi or abs(q) >= np.pi:
        return None
    # z consumed by the two arcs
    dz1 = (-r * (np.cos(theta) - np.cos(g_i)) if t >= 0
           else r * (np.cos(theta) - np.cos(g_i)))
    dz2 = (-r * (np.cos(g_f) - np.cos(theta)) if q >= 0
           else r * (np.cos(g_f) - np.cos(theta)))
    dz_straight = (qf[1] - qi[1]) - dz1 - dz2
    if abs(np.sin(theta)) < 1e-9:
        if abs(dz_straight) > 1e-9:
            return None
        straight = max(qf[0] - qi[0], 0.0)      # level: span the abscissa
    else:
        straight = dz_straight / np.sin(theta)
        if straight < -1e-9:
            return None
        straight = max(straight, 0.0)
    m = VerticalCSC(qi=np.asarray(qi, float), qf=np.asarray(qf, float),
                    r=r, theta=float(theta), sweeps=(t, q),
                    straight=float(straight), exact=False)
    end = m.sample(m.length)
    m.exact = bool(abs(end[0] - qf[0]) < 1e-6 * max(abs(qf[0]), 1.0)
                   and abs(end[1] - qf[1]) < 1e-6)
    return m


def vertical_profile(
    qi,
    qf,
    r: float,
    pitch_limits: tuple[float, float],
) -> Optional[VerticalCSC]:
    """Best vertical CSC profile honouring the pitch envelope.

    Tries the EXACT 2D Dubins slope first (both endpoints matched); when
    the exact profile's slope leaves [pitch_min, pitch_max], falls back to
    the clamped construction at the violated boundary (z and γ endpoints
    still matched exactly, abscissa approximate — the reference Vertical's
    clamped `_LSR`/`_RSL` behaviour, reference vertical.py:169-215,
    flagged ``exact=False``).  Returns None when even the clamped profile
    cannot be built (endpoint climb angles outside the envelope, or the
    straight segment would need negative length)."""
    qi = np.asarray(qi, float)
    qf = np.asarray(qf, float)
    lo, hi = float(pitch_limits[0]), float(pitch_limits[1])
    if not (lo - 1e-9 <= qi[2] <= hi + 1e-9 and lo - 1e-9 <= qf[2] <= hi + 1e-9):
        return None

    # exact CSC via the planar Dubins solver on (s, z, γ)
    path = shortest_path(qi, qf, r)
    if path is not None and "S" in path.word and path.word[1] == "S":
        # slope of the straight = γ after the first arc (unwrapped)
        t = float(path.params[0])
        theta = qi[2] + (t if path.word[0] == "L" else -t)
        if lo <= theta <= hi and abs(theta) < np.pi / 2:
            m = _csc_at_theta(qi, qf, r, theta)
            if m is not None and m.exact:
                return m

    # clamped repair: slope pinned to the boundary toward the required climb
    dz_remaining = qf[1] - qi[1]
    theta_c = hi if dz_remaining >= 0 else lo
    # a level boundary cannot absorb Δz; try the other bound's sign range
    if abs(np.sin(theta_c)) < 1e-9:
        theta_c = lo if dz_remaining >= 0 else hi
    m = _csc_at_theta(qi, qf, r, float(np.clip(theta_c, lo, hi)))
    if m is None:
        return None
    g_min, g_max = m.pitch_range()
    if g_min < lo - 1e-9 or g_max > hi + 1e-9:
        return None
    return m
