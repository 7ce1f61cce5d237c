"""Observability, strictly off the solve's hot path: the summary metrics
of a solution (``solver_metrics``), the constraint-description registry,
``diagnose`` and ``format_diagnosis`` (what ``MHTT.diagnose_window``
reports), a timestamped file logger, the first-call against warm-call
timer, a ``torch.profiler`` trace context, and the Jacobian checks: the
non-finite entries of a step's Jacobians and forward-mode AD
(``jacfwd``) against central differences."""

from __future__ import annotations

import json
import logging
import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from datetime import datetime
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from aircraft_tpu_torch.config import RHO
from aircraft_tpu_torch.device import resolve_device


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


def make_logger(name: str = "aircraft_tpu_torch",
                log_dir: Optional[str] = None) -> logging.Logger:
    """The logger ``name``, set up once: INFO to a timestamped file
    ``<log_dir>/<name>_<YYYYmmdd_HHMMSS>.log``, or to nowhere without
    ``log_dir``."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        ts = datetime.now().strftime("%Y%m%d_%H%M%S")
        fh = logging.FileHandler(Path(log_dir) / f"{name}_{ts}.log")
        fh.setFormatter(logging.Formatter(
            "%(asctime)s - %(levelname)s - %(message)s"))
        logger.addHandler(fh)
    else:
        logger.addHandler(logging.NullHandler())
    return logger


@dataclass
class TimedRun:
    compile_s: float
    execute_s: float
    result: object


def _cards_of(tree) -> set:
    """The CUDA devices of the tensors in a tree of tuples, lists, dicts
    and dataclasses."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.is_cuda else set()
    if isinstance(tree, (tuple, list)):
        return set().union(*map(_cards_of, tree)) if tree else set()
    if isinstance(tree, dict):
        return _cards_of(list(tree.values()))
    if hasattr(tree, "__dataclass_fields__"):
        return _cards_of([getattr(tree, f) for f in tree.__dataclass_fields__])
    return set()


def timed_jit_call(fn: Callable, *args, reps: int = 1) -> TimedRun:
    """The first call against the median of ``reps`` warm calls, each
    call ended by ``torch.cuda.synchronize`` of every card its result
    lives on.  ``compile_s`` is the first call's excess over the warm
    median: in the port there is no trace to compile, so it is what a
    first call does once, the kernels' first load (the libraries built by
    ``kernels/_build.py``), the CUDA context and caching allocator's first
    use, ``torch.func``'s set-up and a CUDA graph's first capture."""
    def call():
        t0 = time.perf_counter()
        out = fn(*args)
        for dev in _cards_of(out):
            torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    out, first = call()
    walls = []
    for _ in range(reps):
        out, wall = call()
        walls.append(wall)
    med = float(np.median(walls))
    return TimedRun(compile_s=first - med, execute_s=med, result=out)


class TraceFile:
    """What ``profile_trace`` yields: the live ``profiler`` and, once the
    region has ended, the ``path`` of its Chrome trace."""

    def __init__(self, profiler):
        self.profiler = profiler
        self.path: Optional[Path] = None

    def kernel_records(self) -> int:
        """The trace's device-kernel records (events of category
        ``kernel``)."""
        events = json.loads(Path(self.path).read_text())["traceEvents"]
        return sum(1 for e in events if e.get("cat") == "kernel")


@contextmanager
def profile_trace(log_dir):
    """A ``torch.profiler`` trace of the region (the CPU, and the cards
    when there are any), exported as a Chrome trace
    ``<log_dir>/trace_<pid>_<YYYYmmdd_HHMMSS_ffffff>.json`` when the region
    ends (view it in Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        out = TraceFile(prof)
        yield out
    ts = datetime.now().strftime("%Y%m%d_%H%M%S_%f")
    out.path = Path(log_dir) / f"trace_{os.getpid()}_{ts}.json"
    prof.export_chrome_trace(str(out.path))


def _at(x, device) -> torch.Tensor:
    """``x`` as a float32 tensor on its own device when it is a tensor,
    else on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32),
                           device=resolve_device(device))


def _host64(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def jacfwd(fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """Forward-mode Jacobian of an unbatched ``fn`` at ``x``, shape
    fn(x).shape + x.shape: one dual-number push
    (``torch.autograd.forward_ad``) per input direction.  ``torch.func``'s
    ``jacfwd`` and ``jvp`` promote the tangent of a 0-dim float32
    intermediate times a Python float to float64, which the plant's mixed
    products then refuse on an unbatched state."""
    import torch.autograd.forward_ad as fwad

    cols = []
    with fwad.dual_level():
        for e in torch.eye(x.numel(), dtype=x.dtype, device=x.device):
            out = fn(fwad.make_dual(x, e.reshape(x.shape)))
            cols.append(fwad.unpack_dual(out).tangent)
    return torch.stack(cols, dim=-1).reshape(cols[0].shape + x.shape)


def locate_nan_in_jacobian(step_fn: Callable, x, u, *,
                           device="cuda") -> dict:
    """The state and control rows and columns of the discrete step's
    Jacobians A = ∂step/∂x, B = ∂step/∂u (``torch.func.jacfwd``) that hold
    non-finite entries at (x, u), and the non-finite entries of x and u
    (forward mode, ``jacfwd``).
    ``x`` and ``u`` are tensors (their device is used) or arrays (put on
    ``device``)."""
    x, u = _at(x, device), _at(u, x.device if isinstance(x, torch.Tensor)
                               else device)
    A = _host64(jacfwd(lambda xx: step_fn(xx, u), x))
    B = _host64(jacfwd(lambda uu: step_fn(x, uu), u))
    bad_A = np.argwhere(~np.isfinite(A))
    bad_B = np.argwhere(~np.isfinite(B))
    return {
        "A_bad_entries": bad_A.tolist(),
        "B_bad_entries": bad_B.tolist(),
        "A_bad_rows": sorted(set(int(r) for r, _ in bad_A)),
        "B_bad_rows": sorted(set(int(r) for r, _ in bad_B)),
        "x_nonfinite": np.argwhere(~np.isfinite(_host64(x))).flatten().tolist(),
        "u_nonfinite": np.argwhere(~np.isfinite(_host64(u))).flatten().tolist(),
    }


def fd_jacobian(fn: Callable, x, eps: float = 1e-4, *,
                device="cuda") -> np.ndarray:
    """Central-difference Jacobian of ``fn`` at ``x``: the steps are taken
    in float64 on the host and ``fn`` is evaluated at their float32
    rounding, on the device of ``x`` (a tensor) or on ``device``."""
    dev = x.device if isinstance(x, torch.Tensor) else resolve_device(device)
    x = (_host64(x) if isinstance(x, torch.Tensor)
         else np.asarray(x, dtype=np.float64))
    at = lambda z: fn(torch.as_tensor(z.astype(np.float32), device=dev))
    f0 = _host64(at(x))
    J = np.zeros(f0.shape + x.shape, dtype=np.float64)
    for i in range(x.size):
        dx = np.zeros_like(x)
        dx.flat[i] = eps
        J[..., i] = (_host64(at(x + dx)) - _host64(at(x - dx))) / (2 * eps)
    return J


def check_jacobian(fn: Callable, x, eps: float = 1e-4, rtol: float = 5e-2,
                   atol: float = 1e-3, *, device="cuda") -> dict:
    """The forward-mode Jacobian (``jacfwd``) at ``x`` (float32) against the
    finite-difference oracle: the largest absolute and relative
    deviation, its entry, and whether every entry is within
    ``atol + rtol·max(|J_fd|, 1)``."""
    J_ad = _host64(jacfwd(fn, _at(x, device)))
    J_fd = fd_jacobian(fn, x, eps, device=device)
    abs_err = np.abs(J_ad - J_fd)
    denom = np.maximum(np.abs(J_fd), 1.0)
    return {
        "max_abs_err": float(abs_err.max()),
        "max_rel_err": float((abs_err / denom).max()),
        "ok": bool(np.all(abs_err <= atol + rtol * denom)),
        "worst_entry": [int(i) for i in
                        np.unravel_index(abs_err.argmax(), abs_err.shape)],
    }


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
