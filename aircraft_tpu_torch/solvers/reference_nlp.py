"""Host-side direct multiple-shooting NLP oracle (the IPOPT stand-in).

An independent NLP solver on the same transcription checks what the
AL-iLQR solves: scipy's SLSQP (a dense sequential-quadratic-programming
method) over

  * the decision vector z = [x_1 … x_N | u_0 … u_{N-1}] (x_0 pinned),
  * the dynamics defects x_{k+1} − F(x_k, u_k, k) = 0 as equalities,
  * the OCP's stage and terminal equalities and inequalities,
  * the objective Σ stage_cost + terminal_cost.

Derivatives come from ``torch.func`` (``grad_and_value`` of the
objective, ``jacrev`` of the constraint vectors) through the very
problem callables the solvers use; only the algorithm is independent.

The oracle evaluates fully in float64.  The problem's callables close
over float32 constants (plant parameters, targets, MLP weights), which
are left as they are: while the oracle evaluates them, every float32
tensor argument of every torch call is promoted to float64 first
(``_Float64``).  So a float32 weight ``@`` a float64 state, which torch
refuses, runs in float64, and so does arithmetic among the constants
alone, which the x64 JAX reference keeps in float32: the two oracles'
problems part by the float32 rounding of that arithmetic (~1e-8
relative on the glider's dynamics; none on the quadrotor's).  SLSQP
stalls on float32 gradients.  Host-side only: tests and parity
harnesses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_map

from aircraft_tpu_torch.device import resolve_device
from aircraft_tpu_torch.solvers import ocp as ocp_mod
from aircraft_tpu_torch.solvers.ocp import OCPFunctions


@dataclass
class NLPSolution:
    """Result of a host-side reference NLP solve."""

    xs: np.ndarray          # (N+1, n_x) including the pinned x0
    us: np.ndarray          # (N, n_u)
    cost: float             # true (un-augmented) objective
    violation: float        # max |eq| / positive ineq over the trajectory
    success: bool
    message: str
    nit: int


def _pack(xs_tail: np.ndarray, us: np.ndarray) -> np.ndarray:
    return np.concatenate([xs_tail.ravel(), us.ravel()]).astype(np.float64)


def _promote(t):
    if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
        return t.to(torch.float64)
    return t


class _Float64(TorchFunctionMode):
    """Every float32 tensor argument of every torch call promoted to
    float64."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        args, kwargs = tree_map(_promote, (args, kwargs or {}))
        return func(*args, **kwargs)


def _in_float64(fn):
    def wrapped(*args):
        with _Float64():
            return fn(*args)

    return wrapped


def solve_reference_nlp(
    ocp: OCPFunctions,
    x0,
    us_init,
    *,
    xs_init: Optional[np.ndarray] = None,
    method: str = "SLSQP",
    maxiter: int = 400,
    ftol: float = 1e-12,
    device="cuda",
) -> NLPSolution:
    """Solve the OCP's multiple-shooting NLP with scipy (host, dense).

    ``xs_init`` defaults to the forward rollout of ``us_init``.  Intended
    for small horizons (N ≲ 60): the constraint Jacobian is dense
    (N·n_x × N·(n_x+n_u)).  ``device`` is where the problem's callables
    run (their constants must live there); scipy works on the host.
    """
    from scipy.optimize import minimize

    dev = resolve_device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    x0 = torch.as_tensor(np.asarray(x0, np.float64), **f64)
    us_init = np.asarray(us_init, np.float64)
    N, n_u = us_init.shape
    n_x = x0.shape[0]
    ks = torch.arange(N, device=dev)

    if xs_init is None:
        step = _in_float64(ocp.step)
        xs_tail, x = [], x0
        for k in range(N):
            x = step(x, torch.as_tensor(us_init[k], **f64), k)
            xs_tail.append(x)
        xs_init = torch.stack(xs_tail).cpu().numpy()
    else:
        xs_init = np.asarray(xs_init, dtype=np.float64)
        if xs_init.shape[0] == N + 1:
            xs_init = xs_init[1:]

    def unpack(z):
        xs_tail = z[: N * n_x].reshape(N, n_x)
        us = z[N * n_x:].reshape(N, n_u)
        return torch.cat([x0[None], xs_tail], dim=0), us

    @_in_float64
    def objective(z):
        xs, us = unpack(z)
        return ocp_mod.true_cost(ocp, xs[None], us[None])[0]

    @_in_float64
    def eq_vec(z):
        xs, us = unpack(z)
        defects = xs[1:] - ocp.step(xs[:-1], us, ks)
        stage_eq = ocp.eq(xs[:-1], us, ks)
        return torch.cat([defects.reshape(-1), stage_eq.reshape(-1),
                          ocp.terminal_eq(xs[-1]).reshape(-1)])

    @_in_float64
    def ineq_vec(z):
        # scipy convention: feasible iff fun(z) >= 0, ours is g <= 0
        xs, us = unpack(z)
        stage = ocp.ineq(xs[:-1], us, ks)
        return -torch.cat([stage.reshape(-1),
                           ocp.terminal_ineq(xs[-1]).reshape(-1)])

    obj_gv = torch.func.grad_and_value(objective)
    eq_j = torch.func.jacrev(eq_vec)
    ineq_j = torch.func.jacrev(ineq_vec)

    def on_host(fn):
        def call(z):
            out = fn(torch.as_tensor(z, **f64))
            return out.detach().cpu().numpy().astype(np.float64)

        return call

    def np_obj(z):
        g, v = obj_gv(torch.as_tensor(z, **f64))
        return float(v), g.detach().cpu().numpy().astype(np.float64)

    constraints = [{"type": "eq", "fun": on_host(eq_vec),
                    "jac": on_host(eq_j)}]
    n_ineq = int(ineq_vec(torch.zeros(N * (n_x + n_u), **f64)).shape[0])
    if n_ineq:
        constraints.append({"type": "ineq", "fun": on_host(ineq_vec),
                            "jac": on_host(ineq_j)})

    z0 = _pack(xs_init, us_init)
    res = minimize(np_obj, z0, jac=True, method=method,
                   constraints=constraints,
                   options={"maxiter": maxiter, "ftol": ftol})

    z = torch.as_tensor(res.x, **f64)
    xs, us = unpack(z)
    with _Float64():
        viol = float(ocp_mod.max_violation(ocp, xs[None], us[None])[0])
        cost = float(ocp_mod.true_cost(ocp, xs[None], us[None])[0])
    # the defect violations are not in max_violation (the iLQR satisfies
    # them by construction): fold them in for the NLP iterate
    viol = max(viol, float(torch.max(torch.abs(eq_vec(z)))))
    return NLPSolution(
        xs=xs.cpu().numpy().astype(np.float64),
        us=us.cpu().numpy().astype(np.float64),
        cost=cost,
        violation=viol,
        success=bool(res.success),
        message=str(res.message),
        nit=int(getattr(res, "nit", -1)),
    )
