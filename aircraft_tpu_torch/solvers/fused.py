"""The batched AL-iLQR window solve around the two window kernels.

``make_fused_solver(ocp, spec, N, config)`` returns ``solve(z0s (B, 14),
us (B, N, 7), al_inits=None) -> ILQRSolution``.  Each inner iteration is
one launch of ``window_backward`` (linearise, Gauss-Newton quadraticise,
Riccati) and one of ``window_forward`` (all line-search rollouts, best-α
pick, store); everything around them runs once per iteration on the
batch: the terminal expansion by ``torch.func`` grad and hessian, the
accept / regularisation / convergence masks, and, once per AL round, the
multiplier update.  Any batch size works.

Two deltas from a textbook iLQR, as in the reference's fused path: the
curvature is always the residual Gauss-Newton form, and the incumbent's
cost is read off the α = 0 candidate.  Configurations the kernels do not
compute raise NotImplementedError instead of being dropped silently.
"""

from __future__ import annotations

from typing import Optional

import torch

from aircraft_tpu_torch.config import SolverConfig
from aircraft_tpu_torch.kernels.window import (
    line_search_alphas,
    make_window_operands,
    window_backward,
    window_forward,
)
from aircraft_tpu_torch.ops.autodiff import batched_grad_hessian
from aircraft_tpu_torch.solvers import ocp as ocp_mod
from aircraft_tpu_torch.solvers.ilqr import ILQRSolution, initial_rollout
from aircraft_tpu_torch.solvers.ocp import ALState, OCPFunctions


def check_fused_support(ocp: OCPFunctions, spec: dict,
                        config: SolverConfig) -> None:
    """Raise NotImplementedError for every solver or OCP setting the window
    kernels would ignore (``make_window_operands`` refuses what the spec
    holds that they do not compute)."""
    if config.hessian != "gauss_newton":
        raise NotImplementedError(
            f"fused solver: hessian={config.hessian!r} (the kernels build "
            "Gauss-Newton curvature)")
    if config.use_residual_gn is False:
        raise NotImplementedError(
            "fused solver: use_residual_gn=False (the kernels build the "
            "residual form)")
    if config.riccati != "sequential":
        raise NotImplementedError(f"fused solver: riccati={config.riccati!r}")
    if ocp.feedback_mask is not None:
        raise NotImplementedError("fused solver: ocp.feedback_mask")
    if ocp.stage_residuals is None:
        raise NotImplementedError(
            "fused solver: an OCP without its residual decomposition")
    dev = spec["params"].device
    probe = torch.zeros(1, 14, device=dev)
    if (ocp.terminal_ineq(probe).shape[-1] > 0
            or ocp.terminal_eq(probe).shape[-1] > 0):
        raise NotImplementedError("fused solver: terminal constraints")
    if ocp.eq(probe, torch.zeros(1, 7, device=dev),
              torch.zeros((), dtype=torch.int64, device=dev)).shape[-1] > 0:
        raise NotImplementedError("fused solver: stage equality constraints")


def _san(t, lim=1e8):
    return torch.clamp(torch.nan_to_num(t, nan=0.0, posinf=0.0, neginf=0.0),
                       -lim, lim)


def make_fused_solver(ocp: OCPFunctions, spec: dict, N: int,
                      config: SolverConfig):
    """Build the batched window solve on the device of ``spec['params']``."""
    check_fused_support(ocp, spec, config)
    alphas = line_search_alphas(config.line_search_steps)
    A = len(alphas)
    op = make_window_operands(spec, N, gain_clip=config.gain_clip,
                              alphas=alphas,
                              device=spec["params"].device)

    def terminal_expansion(al: ALState, xT):
        def cost(x):
            return ocp_mod.al_terminal_cost(ocp, al, x)

        vx, vxx = batched_grad_hessian(cost, xT)
        return _san(vx), _san(vxx)

    def solve(z0s: torch.Tensor, us_init: torch.Tensor,
              al_inits: Optional[ALState] = None) -> ILQRSolution:
        B = z0s.shape[0]
        dev = z0s.device
        al = (al_inits if al_inits is not None else ocp_mod.init_al_state(
            ocp, z0s, us_init[:, 0], N, mu0=config.penalty_init))
        xs = initial_rollout(ocp, z0s, us_init)[0].contiguous()
        ws = us_init.contiguous()
        n_iters = torch.zeros(B, dtype=torch.int32, device=dev)
        grad_norm = torch.full((B,), float("inf"), device=dev)
        for _ in range(config.max_al_iters):
            lam = al.lam_ineq.contiguous()
            mu = al.mu.contiguous()
            mu_row = al.mu_row.contiguous()
            reg = torch.full((B,), config.reg_init, device=dev)
            done = torch.zeros(B, dtype=torch.bool, device=dev)
            for _ in range(config.max_inner_iters):
                vx, vxx = terminal_expansion(al, xs[:, -1])
                K, kff, _, _, qu_max, fail = window_backward(
                    op, xs, ws, lam, mu, reg, mu_row, vx.contiguous(),
                    vxx.contiguous())
                xs_new, ws_new, misc = window_forward(
                    op, xs, ws, K, kff, lam, mu, mu_row)
                cost_prev = misc[:, A - 1]   # alpha = 0: the incumbent
                cost_new = misc[:, A]
                improved = (cost_new < cost_prev - 1e-12) & ~fail
                reg = torch.where(
                    fail | ~improved,
                    torch.clamp_max(reg * config.reg_escalate, config.reg_max),
                    torch.clamp_min(reg / config.reg_relax, config.reg_init))
                accept = improved & ~done
                xs = torch.where(accept[:, None, None], xs_new, xs)
                ws = torch.where(accept[:, None, None], ws_new, ws)
                converged_now = (qu_max < config.tol) | (
                    improved & (torch.abs(cost_prev - cost_new)
                                < config.tol * (1.0 + torch.abs(cost_prev))))
                done = done | (converged_now & ~fail)
                n_iters = n_iters + (~done).to(torch.int32)
                grad_norm = qu_max
            al = ocp_mod.update_multipliers(
                ocp, al, xs, ws, config.penalty_scale, config.penalty_max,
                row_adapt=config.penalty_per_row,
                row_scale=config.penalty_row_scale,
                row_max=config.penalty_row_max,
                row_target=config.penalty_row_target)
        cost = ocp_mod.true_cost(ocp, xs, ws)
        viol = ocp_mod.max_violation(ocp, xs, ws)
        converged = (viol < config.constraint_tol) & torch.isfinite(cost)
        return ILQRSolution(xs=xs, us=ws, cost=cost, violation=viol,
                            converged=converged, iterations=n_iters,
                            grad_norm=grad_norm, al=al)

    solve.operands = op
    return solve
