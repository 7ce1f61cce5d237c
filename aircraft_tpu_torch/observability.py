"""Post-mortem of solves, strictly off the solve's hot path: the summary
metrics of a solution (``solver_metrics``), the constraint-description
registry, ``diagnose`` and ``format_diagnosis`` (what
``MHTT.diagnose_window`` reports).  The reference module's timers,
logger and Jacobian checks are not ported yet."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from aircraft_tpu_torch.config import RHO


def solver_metrics(sol, wall_time: Optional[float] = None) -> dict:
    """Summary dict of an ``ILQRSolution``, single or batched (the
    reference's keys); each field is read to the host once."""
    host = lambda t: np.asarray(t.detach().cpu().numpy()
                                if isinstance(t, torch.Tensor) else t)
    cost, viol, conv, iters, gnorm = (host(t) for t in (
        sol.cost, sol.violation, sol.converged, sol.iterations,
        sol.grad_norm))
    finite = np.isfinite(cost)
    m = {
        "batched": bool(cost.ndim > 0 and cost.size > 1),
        "n_scenarios": int(cost.size),
        "success_rate": float(np.mean(conv)),
        "final_objective": (float(np.mean(cost[finite])) if finite.any()
                            else float("nan")),
        "primal_inf": float(np.max(viol)),
        "iterations": float(np.mean(iters)),
        "grad_norm": float(np.max(gnorm)),
    }
    if wall_time is not None:
        m["total_time"] = wall_time
        m["solves_per_s"] = (cost.size / wall_time if wall_time > 0
                             else float("inf"))
    return m


@dataclass
class ConstraintRegistry:
    """Named, fixed-size constraint blocks; ``describe(i)`` maps a
    violation row index back to its meaning."""

    blocks: list = field(default_factory=list)  # (name, size)

    def register(self, name: str, size: int) -> None:
        self.blocks.append((name, size))

    @property
    def total(self) -> int:
        return sum(s for _, s in self.blocks)

    def describe(self, index: int) -> str:
        i = index
        for name, size in self.blocks:
            if i < size:
                return f"{name}[{i}]" if size > 1 else name
            i -= size
        return f"<unknown row {index}>"

    def report_violations(self, g: np.ndarray, tol: float = 1e-6) -> list[str]:
        """Violated rows of a stage inequality evaluation g <= 0."""
        g = np.asarray(g)
        return [f"{self.describe(int(i))}: {g[i]:.3e}"
                for i in np.where(g > tol)[0]]


def _np(t):
    return t.detach().cpu().numpy()


def diagnose(sol, ocp, *, registry: Optional[ConstraintRegistry] = None,
             params=None, top_k: int = 8, active_tol: float = 1e-6) -> dict:
    """Host-side post-mortem of one finished window solve, ``sol`` an
    ``ILQRSolution`` of a batch of one.  Reports the active
    stage-inequality set with its AL duals (rows named through
    ``registry``), the worst violated rows over the horizon, the per-knot
    Quu condition numbers of a Gauss-Newton Riccati replay in float64, the
    worst dynamics defect ‖x_{k+1} − F(x_k, u_k)‖∞ (zero for a single
    shooting solution unless the arrays were edited), and, with
    ``params``, the airspeed / alpha / beta traces."""
    from aircraft_tpu_torch.solvers import ilqr

    xs_t, us_t = sol.xs, sol.us
    dev = xs_t.device
    N, m = us_t.shape[1], us_t.shape[2]
    ks = torch.arange(N, device=dev)
    with torch.no_grad():
        g = _np(ocp.ineq(xs_t[0, :-1], us_t[0], ks))        # (N, n_ineq)
        h = _np(ocp.eq(xs_t[0, :-1], us_t[0], ks))          # (N, n_eq)
        step_next = _np(ocp.step(xs_t[0, :-1], us_t[0], ks))
    xs, us = _np(xs_t[0]), _np(us_t[0])

    al = sol.al
    lam_ineq = _np(al.lam_ineq[0]) if al is not None else np.zeros_like(g)
    mu = float(al.mu[0]) if al is not None else float("nan")

    # active set: the rows the AL prices (g + λ/μ > 0, the solver's own
    # activity test) plus anything near the boundary
    act = g > -active_tol
    if al is not None and np.isfinite(mu) and mu > 0:
        act |= (g + lam_ineq / mu) > 0.0
    active_rows = []
    for j in np.unique(np.nonzero(act)[1]):
        knots = np.nonzero(act[:, j])[0]
        active_rows.append({
            "row": int(j),
            "name": registry.describe(int(j)) if registry else f"ineq[{j}]",
            "n_knots_active": int(knots.size),
            "first_knot": int(knots[0]),
            "worst_value": float(g[:, j].max()),
            "worst_knot": int(g[:, j].argmax()),
            "max_dual": float(lam_ineq[:, j].max()),
        })
    active_rows.sort(key=lambda r: -r["worst_value"])

    flat = g.ravel()
    worst = []
    for idx in np.argsort(flat)[::-1][:top_k]:
        if flat[idx] <= 0:
            break
        k_i, j_i = np.unravel_index(idx, g.shape)
        worst.append({
            "name": registry.describe(int(j_i)) if registry else f"ineq[{j_i}]",
            "knot": int(k_i),
            "value": float(flat[idx]),
            "dual": float(lam_ineq[k_i, j_i]),
        })

    defect = np.abs(xs[1:] - step_next).max(axis=-1)        # (N,)

    quu_cond = None
    if al is not None:
        try:
            A, B = ilqr.linearize(ocp, xs_t, us_t)
            _, _, lxx, luu, lux, _, vxx = ilqr.quadraticize_gn(ocp, al, xs_t,
                                                              us_t)
            f64 = lambda t: _np(t[0]).astype(np.float64)
            A, B, lxx, luu, lux, Vxx = (f64(t) for t in (A, B, lxx, luu, lux,
                                                         vxx))
            conds = np.zeros(N)
            for k in range(N - 1, -1, -1):
                Quu = luu[k] + B[k].T @ Vxx @ B[k]
                Qxx = lxx[k] + A[k].T @ Vxx @ A[k]
                Qux = lux[k] + B[k].T @ Vxx @ A[k]
                w = np.linalg.eigvalsh(0.5 * (Quu + Quu.T))
                conds[k] = float(w[-1] / max(w[0], 1e-30)) if w[0] > 0 else np.inf
                K = np.linalg.solve(Quu + 1e-9 * np.eye(m), Qux)
                Vxx = Qxx - Qux.T @ K
                Vxx = 0.5 * (Vxx + Vxx.T)
            quu_cond = {
                "max": float(np.nanmax(conds)),
                "worst_knot": int(np.nanargmax(conds)),
                "median": float(np.nanmedian(conds)),
                "n_indefinite": int(np.sum(~np.isfinite(conds))),
            }
        except Exception as e:  # a diagnosis never takes the caller down
            quu_cond = {"error": repr(e)}

    report = {
        "cost": float(sol.cost[0]),
        "violation": float(sol.violation[0]),
        "converged": bool(sol.converged[0]),
        "iterations": int(sol.iterations[0]),
        "mu": mu,
        "active_constraints": active_rows[:top_k],
        "worst_violations": worst,
        "eq_violation_max": float(np.abs(h).max()) if h.size else 0.0,
        "worst_defect": float(defect.max()),
        "worst_defect_knot": int(defect.argmax()),
        "quu_cond": quu_cond,
        "nonfinite_states": int((~np.isfinite(xs)).sum()),
    }
    if params is not None:
        from aircraft_tpu_torch.dynamics import aircraft as ac

        with torch.no_grad():
            aero = ac.aero_state(params, xs_t[0, :-1, :13], us_t[0, :, :7])
        speed = np.sqrt(_np(2.0 * aero.qbar / RHO))
        report["envelope_traces"] = {
            "airspeed_min": float(speed.min()),
            "airspeed_max": float(speed.max()),
            "alpha_deg_max": float(np.rad2deg(np.abs(_np(aero.alpha)).max())),
            "beta_deg_max": float(np.rad2deg(np.abs(_np(aero.beta)).max())),
        }
    return report


def format_diagnosis(report: dict) -> str:
    """Human-readable rendering of a ``diagnose`` report."""
    lines = [
        f"solve: cost={report['cost']:.3f} violation={report['violation']:.3e} "
        f"converged={report['converged']} iters={report['iterations']} "
        f"mu={report['mu']:.1e}",
        f"defect: max {report['worst_defect']:.2e} at knot "
        f"{report['worst_defect_knot']}; eq viol {report['eq_violation_max']:.2e}",
    ]
    if report.get("quu_cond") and "max" in report.get("quu_cond", {}):
        q = report["quu_cond"]
        lines.append(
            f"Quu cond: max {q['max']:.2e} (knot {q['worst_knot']}), "
            f"median {q['median']:.2e}, indefinite knots {q['n_indefinite']}")
    if report.get("envelope_traces"):
        t = report["envelope_traces"]
        lines.append(
            f"envelope: v in [{t['airspeed_min']:.1f}, {t['airspeed_max']:.1f}] m/s, "
            f"|alpha| <= {t['alpha_deg_max']:.1f} deg, |beta| <= {t['beta_deg_max']:.1f} deg")
    if report["active_constraints"]:
        lines.append("active constraints (worst first):")
        for r in report["active_constraints"]:
            lines.append(
                f"  {r['name']}: {r['n_knots_active']} knots from "
                f"{r['first_knot']}, worst {r['worst_value']:+.3e} at knot "
                f"{r['worst_knot']}, dual {r['max_dual']:.2e}")
    if report["worst_violations"]:
        lines.append("worst violations:")
        for r in report["worst_violations"]:
            lines.append(
                f"  {r['name']} at knot {r['knot']}: {r['value']:.3e} "
                f"(dual {r['dual']:.2e})")
    return "\n".join(lines)
