"""Batched augmented-Lagrangian iLQR, written batch-leading.

The port of ``aircraft_tpu/solvers/ilqr.py``: the reference writes one
scenario's solve and vmaps it; here every tensor carries the scenario
batch first and the iteration runs once for the whole batch.

* dynamics sensitivities A_k, B_k: forward mode over all B·N knots at once
  (``ops/autodiff.batched_jacfwd``), sanitised and clamped at 1e6;
* the exact AL Hessian (``quadraticize``, ``hessian='exact'``, the
  default): gradient and Hessian of the AL stage and terminal costs; or
  Gauss-Newton curvature (``quadraticize_gn``): the residual JᵀJ form, or
  the stage cost's exact Hessian, plus active-set PHR inequality and
  equality blocks and the terminal blocks; either sanitised at 1e8;
* the Riccati sweep (``solvers/riccati.py``), sequential or associative
  (``riccati='associative'``), its Quu solves on the reference route or,
  with ``cuda_chol``, on the batched-Cholesky kernel;
* a line search over every step size at once, the (B, A) candidates rolled
  out as one batch, a diverged knot frozen in place at a fixed penalty;
* a fixed trip count with per-scenario ``done`` masking and no early exit,
  so every scenario sees the same regularisation trail and ``grad_norm``
  as in the reference.

``solve_batch(batch_minor=True)`` is accepted and solves as
``batch_minor=False`` does: the reference's flag only places the batch on
the TPU's lanes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from aircraft_tpu_torch.config import SolverConfig
from aircraft_tpu_torch.ops.autodiff import batched_grad_hessian, batched_jacfwd
from aircraft_tpu_torch.solvers import ocp as ocp_mod
from aircraft_tpu_torch.solvers import riccati as riccati_mod
from aircraft_tpu_torch.solvers.ocp import ALState, OCPFunctions

# fixed cost penalty per frozen (diverged) rollout knot: keeps divergent
# candidates comparable instead of pricing them at +inf
FREEZE_PENALTY = 1e7


class ILQRSolution(NamedTuple):
    xs: torch.Tensor          # (B, N+1, n)
    us: torch.Tensor          # (B, N, m)
    cost: torch.Tensor        # true (un-augmented) cost, (B,)
    violation: torch.Tensor   # max constraint violation, (B,)
    converged: torch.Tensor   # (B,) bool
    iterations: torch.Tensor  # inner iterations used, (B,)
    grad_norm: torch.Tensor   # final max |Qu|, (B,)
    al: Optional[ALState] = None


def _san(t, lim):
    return torch.clamp(torch.nan_to_num(t, nan=0.0, posinf=0.0, neginf=0.0),
                       -lim, lim)


def _knots(t):
    """(B, N, d) -> (B·N, d)."""
    return t.reshape(-1, t.shape[-1])


def _knot_index(B, N, device):
    return torch.arange(N, device=device).repeat(B)


def linearize(ocp: OCPFunctions, xs, us):
    """A (B, N, n, n), B (B, N, n, m) of ocp.step along (xs, us), all knots
    in one forward-mode pass; non-finite entries zeroed, clamped at 1e6
    (frozen linearisation points outside the model's range)."""
    Bz, N, m = us.shape
    n = xs.shape[-1]
    ks = _knot_index(Bz, N, xs.device)
    J = batched_jacfwd(lambda x, u: ocp.step(x, u, ks), _knots(xs[:, :-1]),
                       _knots(us))
    J = _san(J, 1e6).reshape(Bz, N, n, n + m)
    return J[..., :n], J[..., n:]


def quadraticize(ocp: OCPFunctions, al: ALState, xs, us):
    """Exact expansion of the AL: the gradient and Hessian of
    ``ocp_mod.al_stage_cost`` over z = (x, u) at every knot, all B·N at
    once, sliced into lx (B,N,n), lu (B,N,m), lxx, luu and the cross
    block lux (B,N,m,n) = ∂²c/∂u∂x; and the gradient vx (B,n) and Hessian
    vxx of ``al_terminal_cost``.  Not yet sanitised.  Indefinite where
    the constraint terms' curvature is."""
    Bz, N, m = us.shape
    n = xs.shape[-1]
    ks = _knot_index(Bz, N, xs.device)
    lam_g, lam_h = al.lam_ineq.flatten(0, 1), al.lam_eq.flatten(0, 1)
    mu = al.mu.repeat_interleave(N)
    mu_row = al.mu_row.repeat_interleave(N, dim=0)

    def stage(z):
        return ocp_mod._stage_al(ocp, lam_g, lam_h, mu, mu_row, z[..., :n],
                                 z[..., n:], ks)

    g, H = batched_grad_hessian(
        stage, torch.cat([_knots(xs[:, :-1]), _knots(us)], dim=-1))
    vx, vxx = batched_grad_hessian(
        lambda x: ocp_mod.al_terminal_cost(ocp, al, x), xs[:, -1])
    shape = lambda t: t.reshape((Bz, N) + t.shape[1:])
    return (shape(g[..., :n]), shape(g[..., n:]), shape(H[..., :n, :n]),
            shape(H[..., n:, n:]), shape(H[..., n:, :n]), vx, vxx)


def quadraticize_gn(ocp: OCPFunctions, al: ALState, xs, us,
                    use_residuals: bool = True):
    """Gauss-Newton expansion of the AL: exact gradient, the cost terms'
    curvature (JᵀJ of the residuals, or the stage cost's Hessian), and
    μ JᵀJ over the active inequality rows and the equality rows.  Returns
    lx (B,N,n), lu (B,N,m), lxx, luu, lux (B,N,m,n), vx (B,n), vxx, not yet
    sanitised."""
    Bz, N, m = us.shape
    n = xs.shape[-1]
    X, U = _knots(xs[:, :-1]), _knots(us)
    ks = _knot_index(Bz, N, xs.device)
    residual = ocp.stage_residuals is not None and use_residuals
    ng = ocp.ineq(X[:1], U[:1], ks[:1]).shape[-1]
    nh = ocp.eq(X[:1], U[:1], ks[:1]).shape[-1]

    def rows(x, u):
        """[r | rest | g | h] of each knot; only what is used."""
        out = []
        if residual:
            out.append(ocp.stage_residuals(x, u, ks))
            if ocp.stage_rest is not None:
                out.append(ocp.stage_rest(x, u, ks)[..., None])
        out += [ocp.ineq(x, u, ks), ocp.eq(x, u, ks)]
        return torch.cat(out, dim=-1)

    def split_x_u(J):
        return J[..., :n], J[..., n:]

    vals = rows(X, U)
    J = batched_jacfwd(rows, X, U)           # (BN, rows, n + m)
    nr = vals.shape[-1] - ng - nh
    if residual:
        nres = nr - (1 if ocp.stage_rest is not None else 0)
        r, Jr = vals[:, :nres], J[:, :nres]
        Jrx, Jru = split_x_u(Jr)
        lx = (Jrx.transpose(-1, -2) @ r[..., None])[..., 0]
        lu = (Jru.transpose(-1, -2) @ r[..., None])[..., 0]
        lxx = Jrx.transpose(-1, -2) @ Jrx
        luu = Jru.transpose(-1, -2) @ Jru
        lux = Jru.transpose(-1, -2) @ Jrx
        if ocp.stage_rest is not None:
            # exact gradient of the non-least-squares terms, no curvature
            gx, gu = split_x_u(J[:, nres])
            lx, lu = lx + gx, lu + gu
    else:
        Z = torch.cat([X, U], dim=-1)
        g, H = batched_grad_hessian(
            lambda z: ocp.stage_cost(z[..., :n], z[..., n:], ks), Z)
        lx, lu = g[..., :n], g[..., n:]
        lxx, luu, lux = H[..., :n, :n], H[..., n:, n:], H[..., n:, :n]

    mu = al.mu.repeat_interleave(N)          # (BN,)
    if ng > 0:
        gval, Jgx, Jgu = (vals[:, nr:nr + ng],) + split_x_u(J[:, nr:nr + ng])
        lam = _knots(al.lam_ineq)
        mu_g = mu[:, None] * al.mu_row.repeat_interleave(N, dim=0)
        act = (gval + lam / mu_g) > 0.0
        y = torch.where(act, lam + mu_g * gval, torch.zeros_like(gval))
        w = torch.where(act, mu_g, torch.zeros_like(gval))
        JgxT, JguT = Jgx.transpose(-1, -2), Jgu.transpose(-1, -2)
        lx = lx + (JgxT @ y[..., None])[..., 0]
        lu = lu + (JguT @ y[..., None])[..., 0]
        lxx = lxx + JgxT @ (w[..., None] * Jgx)
        luu = luu + JguT @ (w[..., None] * Jgu)
        lux = lux + JguT @ (w[..., None] * Jgx)
    if nh > 0:
        h, Jhx, Jhu = (vals[:, nr + ng:],) + split_x_u(J[:, nr + ng:])
        yh = _knots(al.lam_eq) + mu[:, None] * h
        JhxT, JhuT = Jhx.transpose(-1, -2), Jhu.transpose(-1, -2)
        m3 = mu[:, None, None]
        lx = lx + (JhxT @ yh[..., None])[..., 0]
        lu = lu + (JhuT @ yh[..., None])[..., 0]
        lxx = lxx + m3 * (JhxT @ Jhx)
        luu = luu + m3 * (JhuT @ Jhu)
        lux = lux + m3 * (JhuT @ Jhx)

    xT = xs[:, -1]
    vx, vxx = batched_grad_hessian(ocp.terminal_cost, xT)
    muT = al.mu
    gT = ocp.terminal_ineq(xT)
    if gT.shape[-1] > 0:
        Jg = batched_jacfwd(ocp.terminal_ineq, xT)
        act = (gT + al.lam_t_ineq / muT[:, None]) > 0.0
        y = torch.where(act, al.lam_t_ineq + muT[:, None] * gT,
                        torch.zeros_like(gT))
        w = torch.where(act, muT[:, None].expand_as(gT), torch.zeros_like(gT))
        vx = vx + (Jg.transpose(-1, -2) @ y[..., None])[..., 0]
        vxx = vxx + Jg.transpose(-1, -2) @ (w[..., None] * Jg)
    hT = ocp.terminal_eq(xT)
    if hT.shape[-1] > 0:
        Jh = batched_jacfwd(ocp.terminal_eq, xT)
        yh = al.lam_t_eq + muT[:, None] * hT
        vx = vx + (Jh.transpose(-1, -2) @ yh[..., None])[..., 0]
        vxx = vxx + muT[:, None, None] * (Jh.transpose(-1, -2) @ Jh)

    shape = lambda t: t.reshape((Bz, N) + t.shape[1:])
    return (shape(lx), shape(lu), shape(lxx), shape(luu), shape(lux), vx,
            vxx)


def backward_pass(A, B, lx, lu, lxx, luu, lux, vx, vxx, reg,
                  mode: str = "sequential", *, cuda_chol: bool = False):
    """The Riccati sweep (``solvers/riccati.py``): the associative one for
    ``mode='associative'``, else the sequential one."""
    sweep = (riccati_mod.backward_associative if mode == "associative"
             else riccati_mod.backward_sequential)
    return sweep(A, B, lx, lu, lxx, luu, lux, vx, vxx, reg,
                 cuda_chol=cuda_chol)


def _repeat_al(al: ALState, A: int) -> ALState:
    """Each scenario's multipliers repeated for its A candidates."""
    return ALState(*(getattr(al, f).repeat_interleave(A, dim=0)
                     for f in ocp_mod._AL_FIELDS))


def forward_pass(ocp: OCPFunctions, al: ALState, xs_ref, us_ref, K, kff,
                 alphas):
    """Roll every step size out at once, (B, A) candidates as one batch,
    and return each scenario's best trajectory by AL cost: (xs (B, N+1, n),
    us (B, N, m), cost (B,), frozen knots (B,)).  A knot whose next state
    is non-finite or exceeds 1e6 keeps its state and costs FREEZE_PENALTY;
    the first minimum wins a tie."""
    Bz, N, m = us_ref.shape
    n = xs_ref.shape[-1]
    A = alphas.shape[0]
    if ocp.feedback_mask is not None:
        K = K * torch.as_tensor(ocp.feedback_mask, dtype=K.dtype,
                                device=K.device)[:, None]
    x = xs_ref[:, None, 0].expand(Bz, A, n)
    nfro = torch.zeros((Bz, A), dtype=torch.int64, device=xs_ref.device)
    ks = torch.arange(N, device=xs_ref.device)
    xs_c, us_c = [x], []
    for k in range(N):
        u = (us_ref[:, None, k] + alphas[None, :, None] * kff[:, None, k]
             + (K[:, None, k] @ (x - xs_ref[:, None, k])[..., None])[..., 0])
        x_next = ocp.step(x.reshape(-1, n), u.reshape(-1, m),
                          ks[k]).reshape(Bz, A, n)
        finite = (torch.isfinite(x_next).all(-1)
                  & (torch.amax(torch.abs(x_next), dim=-1) < 1e6))
        x = torch.where(finite[..., None], x_next, x)
        nfro = nfro + (~finite).to(torch.int64)
        xs_c.append(x)
        us_c.append(u)
    xs_c = torch.stack(xs_c, dim=2)          # (B, A, N+1, n)
    us_c = torch.stack(us_c, dim=2)          # (B, A, N, m)
    cost = ocp_mod.al_total_cost(ocp, _repeat_al(al, A),
                                 xs_c.reshape(Bz * A, N + 1, n),
                                 us_c.reshape(Bz * A, N, m)).reshape(Bz, A)
    cost = torch.nan_to_num(cost, nan=float("inf")) + FREEZE_PENALTY * nfro
    cost = torch.where(torch.isnan(cost), torch.full_like(cost, np.inf), cost)
    best = torch.argmin(cost, dim=1)
    rows = torch.arange(Bz, device=xs_ref.device)
    return xs_c[rows, best], us_c[rows, best], cost[rows, best], nfro[rows, best]


def line_search_alphas(steps: int) -> tuple:
    """1, 1/2, ..., 2^-(steps-2), then 0 (the incumbent)."""
    return tuple(float(a) for a in np.concatenate(
        [np.logspace(0.0, -(steps - 2), steps - 1, base=2.0), [0.0]]))


@functools.lru_cache(maxsize=None)
def _alpha_vector(steps: int, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """``line_search_alphas(steps)`` on the device, copied there once per
    process rather than once per solve (each copy waits for the
    stream)."""
    return torch.tensor(line_search_alphas(steps), dtype=dtype, device=device)


def initial_rollout(ocp: OCPFunctions, x0, us):
    """Freeze-guarded open-loop rollout of the warm start: (xs, frozen)."""
    N = us.shape[1]
    xs, x = [x0], x0
    nfro = torch.zeros(x0.shape[0], dtype=torch.int64, device=x0.device)
    ks = torch.arange(N, device=x0.device)
    for k in range(N):
        x_next = ocp.step(x, us[:, k], ks[k])
        ok = (torch.isfinite(x_next).all(-1)
              & (torch.amax(torch.abs(x_next), dim=-1) < 1e6))
        x = torch.where(ok[:, None], x_next, x)
        nfro = nfro + (~ok).to(torch.int64)
        xs.append(x)
    return torch.stack(xs, dim=1), nfro


def solve_impl(ocp: OCPFunctions, x0s: torch.Tensor, us_init: torch.Tensor,
               config: SolverConfig = SolverConfig(),
               al_init: Optional[ALState] = None,
               xs_init: Optional[torch.Tensor] = None, *,
               cuda_chol: bool = False) -> ILQRSolution:
    """Solve a batch of windows from x0s (B, n), us_init (B, N, m).

    ``al_init``: warm-start multipliers (batch-leading), e.g. the previous
    window's ``ILQRSolution.al`` through ``ocp.shift_al_state``.
    ``xs_init``: a trajectory warm start (B, N+1, n) used as the first
    linearisation point instead of rolling ``us_init`` out; its row 0 is
    pinned to x0s, and its incumbent cost reads N frozen knots so the
    first forward pass (a true rollout) is always taken.  ``cuda_chol``
    sends the sweep's Quu solves to the batched-Cholesky kernel; its
    numeric fallbacks are read into ``riccati.chol_fallbacks`` once, at
    the end of the solve."""
    Bz, N, _ = us_init.shape
    dev, dtype = x0s.device, x0s.dtype
    alphas = _alpha_vector(config.line_search_steps, dtype, dev)
    if xs_init is None:
        xs, nfro = initial_rollout(ocp, x0s, us_init)
    else:
        xs = torch.as_tensor(xs_init, dtype=dtype, device=dev).clone()
        xs[:, 0] = x0s
        nfro = torch.full((Bz,), N, dtype=torch.int64, device=dev)
    us = us_init
    al = (ocp_mod.init_al_state(ocp, x0s, us_init[:, 0], N,
                                mu0=config.penalty_init)
          if al_init is None else al_init)
    # None: the residual form, the reference's choice on every backend but
    # the TPU
    use_res = config.use_residual_gn is not False
    n_iters = torch.zeros(Bz, dtype=torch.int64, device=dev)
    grad_norm = torch.full((Bz,), np.inf, dtype=dtype, device=dev)
    for _ in range(config.max_al_iters):
        reg = torch.full((Bz,), config.reg_init, dtype=dtype, device=dev)
        done = torch.zeros(Bz, dtype=torch.bool, device=dev)
        for _ in range(config.max_inner_iters):
            cost_prev = (ocp_mod.al_total_cost(ocp, al, xs, us)
                         + FREEZE_PENALTY * nfro)
            A, Bm = linearize(ocp, xs, us)
            quad = (quadraticize_gn(ocp, al, xs, us, use_residuals=use_res)
                    if config.hessian == "gauss_newton"
                    else quadraticize(ocp, al, xs, us))
            lx, lu, lxx, luu, lux, vx, vxx = (_san(t, 1e8) for t in quad)
            K, kff, _, _, qu_max, fail = backward_pass(
                A, Bm, lx, lu, lxx, luu, lux, vx, vxx, reg, config.riccati,
                cuda_chol=cuda_chol)
            K = torch.clamp(K, -config.gain_clip, config.gain_clip)
            kff = torch.clamp(kff, -config.gain_clip, config.gain_clip)
            xs_new, us_new, cost_new, nfro_new = forward_pass(
                ocp, al, xs, us, K, kff, alphas)
            improved = (cost_new < cost_prev - 1e-12) & ~fail
            reg = torch.where(
                fail | ~improved,
                torch.clamp_max(reg * config.reg_escalate, config.reg_max),
                torch.clamp_min(reg / config.reg_relax, config.reg_init))
            accept = improved & ~done
            xs = torch.where(accept[:, None, None], xs_new, xs)
            us = torch.where(accept[:, None, None], us_new, us)
            nfro = torch.where(accept, nfro_new, nfro)
            converged_now = (qu_max < config.tol) | (
                improved & (torch.abs(cost_prev - cost_new)
                            < config.tol * (1.0 + torch.abs(cost_prev))))
            done = done | (converged_now & ~fail)
            n_iters = n_iters + (~done).to(torch.int64)
            grad_norm = qu_max
        al = ocp_mod.update_multipliers(
            ocp, al, xs, us, config.penalty_scale, config.penalty_max,
            row_adapt=config.penalty_per_row,
            row_scale=config.penalty_row_scale,
            row_max=config.penalty_row_max,
            row_target=config.penalty_row_target)
    if cuda_chol:
        riccati_mod.read_fallbacks()     # the solve's one host read
    cost = ocp_mod.true_cost(ocp, xs, us)
    viol = ocp_mod.max_violation(ocp, xs, us)
    converged = (viol < config.constraint_tol) & torch.isfinite(cost)
    return ILQRSolution(xs=xs, us=us, cost=cost, violation=viol,
                        converged=converged, iterations=n_iters,
                        grad_norm=grad_norm, al=al)


def solve(ocp: OCPFunctions, x0: torch.Tensor, us_init: torch.Tensor,
          config: SolverConfig = SolverConfig(),
          al_init: Optional[ALState] = None,
          xs_init: Optional[torch.Tensor] = None, *,
          cuda_chol: bool = False) -> ILQRSolution:
    """One problem: x0 (n,), us_init (N, m), optional unbatched
    multipliers ``al_init`` and trajectory seed ``xs_init`` (N+1, n).
    ``solve_impl`` on a batch of one; the solution comes back unbatched
    (xs (N+1, n), us (N, m), 0-dim cost, violation, ...)."""
    one = lambda t: None if t is None else t[None]
    al = (None if al_init is None else
          ALState(*(getattr(al_init, f)[None] for f in ocp_mod._AL_FIELDS)))
    sol = solve_impl(ocp, x0[None], us_init[None], config, al,
                     one(xs_init), cuda_chol=cuda_chol)
    return take(sol, 0)


def take(sol: ILQRSolution, i: int) -> ILQRSolution:
    """Scenario i of a batched solution, unbatched."""
    al = (None if sol.al is None else
          ALState(*(getattr(sol.al, f)[i] for f in ocp_mod._AL_FIELDS)))
    return ILQRSolution(*(t[i] for t in sol[:-1]), al=al)


def solve_batch(ocp: OCPFunctions, x0s: torch.Tensor, us_inits: torch.Tensor,
                config: SolverConfig = SolverConfig(),
                al_inits: Optional[ALState] = None,
                batch_minor: bool = False, *,
                cuda_chol: bool = False) -> ILQRSolution:
    """Thousands of simultaneous window solves: x0s (B, n), us_inits
    (B, N, m), optional per-scenario dual warm starts ``al_inits``; inputs
    and outputs batch-leading.  The batch is the leading axis of every
    tensor already, so this is ``solve_impl``.

    ``batch_minor`` is the reference's interface: there it maps the batch
    as the minor-most axis so the scenarios ride the TPU's 128 lanes
    instead of each 7- or 13-wide tensor padding its minor dimension.  A
    CUDA card has no lane tiling of that kind (the batched kernels pick
    their own thread layout), so the flag selects no other layout here
    and the solve is the same either way."""
    return solve_impl(ocp, x0s, us_inits, config, al_inits,
                      cuda_chol=cuda_chol)
