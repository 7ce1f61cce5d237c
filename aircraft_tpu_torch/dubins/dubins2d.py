"""Classical 2D Dubins shortest paths (all six words), host-side numpy.

Plays the role of the reference's `DubinsManeuver2D` (reference
src/aircraft/dubins/dubins2d.py, itself a port of comrob/Dubins3D.jl) but is
implemented directly from the Shkel–Lumelsky closed forms.  This is
initialisation-time geometry: it runs on the host, producing warm starts and
reference tracks for the device-side solver — never on the solve hot path.

A configuration is (x, y, psi); turns have radius `rho`. Segment types are
'L' (left), 'R' (right), 'S' (straight). Lengths returned are real arc
lengths (radius-scaled).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

WORDS = ("LSL", "RSR", "LSR", "RSL", "RLR", "LRL")


def _mod2pi(theta: float) -> float:
    return theta % (2.0 * np.pi)


@dataclass
class DubinsPath:
    """Shortest (or length-constrained) planar Dubins maneuver."""

    qi: np.ndarray          # (3,) initial (x, y, psi)
    qf: np.ndarray          # (3,) final (x, y, psi)
    rho: float
    word: str               # one of WORDS
    params: np.ndarray      # (3,) segment lengths in *normalised* units (rho=1)

    @property
    def length(self) -> float:
        return float(np.sum(self.params) * self.rho)

    @property
    def segment_lengths(self) -> np.ndarray:
        return self.params * self.rho

    def sample(self, s: float) -> np.ndarray:
        """Configuration (x, y, psi) at arc length s from the start."""
        s = np.clip(s, 0.0, self.length) / self.rho
        q = np.array([0.0, 0.0, self.qi[2]])
        out = np.array(self.qi, dtype=float)
        for seg_type, seg_len in zip(self.word, self.params):
            ds = min(s, seg_len)
            out = _propagate(out, ds, seg_type, self.rho)
            s -= ds
            if s <= 1e-12:
                break
        return out

    def sample_many(self, n: int) -> np.ndarray:
        """(n, 3) configurations uniformly spaced in arc length."""
        return np.stack([self.sample(s)
                         for s in np.linspace(0.0, self.length, n)])


def _propagate(q: np.ndarray, t: float, seg_type: str, rho: float) -> np.ndarray:
    """Advance a configuration by normalised length t along one segment."""
    x, y, psi = q
    if seg_type == "S":
        return np.array([x + rho * t * np.cos(psi), y + rho * t * np.sin(psi), psi])
    sign = 1.0 if seg_type == "L" else -1.0
    psi_new = psi + sign * t
    x_new = x + rho * (np.sin(psi_new) - np.sin(psi)) * sign
    y_new = y - rho * (np.cos(psi_new) - np.cos(psi)) * sign
    return np.array([x_new, y_new, _mod2pi(psi_new)])


def _lsl(alpha, beta, d):
    ca, sa, cb, sb = np.cos(alpha), np.sin(alpha), np.cos(beta), np.sin(beta)
    p_sq = 2 + d * d - 2 * np.cos(alpha - beta) + 2 * d * (sa - sb)
    if p_sq < 0:
        return None
    tmp = np.arctan2(cb - ca, d + sa - sb)
    return (_mod2pi(-alpha + tmp), np.sqrt(p_sq), _mod2pi(beta - tmp))


def _rsr(alpha, beta, d):
    ca, sa, cb, sb = np.cos(alpha), np.sin(alpha), np.cos(beta), np.sin(beta)
    p_sq = 2 + d * d - 2 * np.cos(alpha - beta) + 2 * d * (sb - sa)
    if p_sq < 0:
        return None
    tmp = np.arctan2(ca - cb, d - sa + sb)
    return (_mod2pi(alpha - tmp), np.sqrt(p_sq), _mod2pi(-beta + tmp))


def _lsr(alpha, beta, d):
    ca, sa, cb, sb = np.cos(alpha), np.sin(alpha), np.cos(beta), np.sin(beta)
    p_sq = -2 + d * d + 2 * np.cos(alpha - beta) + 2 * d * (sa + sb)
    if p_sq < 0:
        return None
    p = np.sqrt(p_sq)
    tmp = np.arctan2(-ca - cb, d + sa + sb) - np.arctan2(-2.0, p)
    return (_mod2pi(-alpha + tmp), p, _mod2pi(-_mod2pi(beta) + tmp))


def _rsl(alpha, beta, d):
    ca, sa, cb, sb = np.cos(alpha), np.sin(alpha), np.cos(beta), np.sin(beta)
    p_sq = -2 + d * d + 2 * np.cos(alpha - beta) - 2 * d * (sa + sb)
    if p_sq < 0:
        return None
    p = np.sqrt(p_sq)
    tmp = np.arctan2(ca + cb, d - sa - sb) - np.arctan2(2.0, p)
    return (_mod2pi(alpha - tmp), p, _mod2pi(beta - tmp))


def _ccc(alpha, beta, d, first: str):
    """CCC words (LRL / RLR) by explicit tangent-circle geometry in the
    normalised frame (rho = 1, start (0,0,alpha), goal (d,0,beta)).

    Both side choices for the middle circle are evaluated; the shorter
    feasible one is returned.  Geometry beats the closed forms here: the
    published CCC formulas are notoriously sign-fragile for the d < 4
    regime where these words win.
    """
    sgn = 1.0 if first == "L" else -1.0  # left: centers 90° to the left
    p0 = np.array([0.0, 0.0])
    p1 = np.array([d, 0.0])
    c0 = p0 + sgn * np.array([-np.sin(alpha), np.cos(alpha)])
    c1 = p1 + sgn * np.array([-np.sin(beta), np.cos(beta)])
    D = np.linalg.norm(c1 - c0)
    if D > 4.0 or D < 1e-12:
        return None
    theta_d = np.arctan2(c1[1] - c0[1], c1[0] - c0[0])
    phi = np.arccos(np.clip(D / 4.0, -1.0, 1.0))

    def arcs(side):
        cm = c0 + 2.0 * np.array(
            [np.cos(theta_d + side * phi), np.sin(theta_d + side * phi)]
        )
        t1 = 0.5 * (c0 + cm)  # tangency first/middle circle
        t2 = 0.5 * (cm + c1)  # tangency middle/final circle
        a0 = np.arctan2(p0[1] - c0[1], p0[0] - c0[0])
        a1 = np.arctan2(t1[1] - c0[1], t1[0] - c0[0])
        b1 = np.arctan2(t1[1] - cm[1], t1[0] - cm[0])
        b2 = np.arctan2(t2[1] - cm[1], t2[0] - cm[0])
        g1 = np.arctan2(t2[1] - c1[1], t2[0] - c1[0])
        g2 = np.arctan2(p1[1] - c1[1], p1[0] - c1[0])
        if sgn > 0:  # L..R..L : ccw, cw, ccw
            return (_mod2pi(a1 - a0), _mod2pi(b1 - b2), _mod2pi(g2 - g1))
        return (_mod2pi(a0 - a1), _mod2pi(b2 - b1), _mod2pi(g1 - g2))

    best = None
    for side in (+1.0, -1.0):
        t, p, q = arcs(side)
        # middle arc of a true CCC exceeds pi
        if p <= np.pi - 1e-9:
            continue
        if best is None or (t + p + q) < sum(best):
            best = (t, p, q)
    return best


def _rlr(alpha, beta, d):
    return _ccc(alpha, beta, d, "R")


def _lrl(alpha, beta, d):
    return _ccc(alpha, beta, d, "L")


_PLANNERS = {
    "LSL": _lsl,
    "RSR": _rsr,
    "LSR": _lsr,
    "RSL": _rsl,
    "RLR": _rlr,
    "LRL": _lrl,
}


def shortest_path(
    qi, qf, rho: float, min_length: Optional[float] = None
) -> Optional[DubinsPath]:
    """Shortest Dubins path between configurations; if `min_length` is given,
    the shortest path whose length is at least `min_length` (the reference's
    `minLength` option used by the 3D decoupling, dubins2d.py:30-82)."""
    qi = np.asarray(qi, dtype=float)
    qf = np.asarray(qf, dtype=float)
    dx, dy = qf[0] - qi[0], qf[1] - qi[1]
    D = np.hypot(dx, dy)
    d = D / rho
    theta = np.arctan2(dy, dx) if D > 1e-12 else 0.0
    alpha = _mod2pi(qi[2] - theta)
    beta = _mod2pi(qf[2] - theta)

    best = None
    for word, planner in _PLANNERS.items():
        res = planner(alpha, beta, d)
        if res is None:
            continue
        params = np.array(res)
        length = float(np.sum(params) * rho)
        if min_length is not None and length < min_length - 1e-9:
            continue
        if best is None or length < best.length:
            best = DubinsPath(qi=qi, qf=qf, rho=rho, word=word, params=params)
    return best
