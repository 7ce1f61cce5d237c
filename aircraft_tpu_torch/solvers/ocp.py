"""Optimal-control-problem description and augmented-Lagrangian pieces.

A problem is a bundle of batched functions over (state, control,
knot index): ``step(x, u, k) -> x_next``, stage and terminal costs, and
constraint rows with ``eq = 0`` and ``ineq <= 0``.  Every function takes
leading batch axes; ``k`` is an integer tensor that broadcasts against
them.  AL state is batch-leading: ``lam_ineq`` (B, N, n_ineq), ``mu`` (B,),
``mu_row`` (B, n_ineq).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional

import torch

from aircraft_tpu_torch.device import resolve_device
from aircraft_tpu_torch.ops.elementwise import clip, saturating_tanh


def _zero_vec(x, u, k):
    return x.new_zeros(x.shape[:-1] + (0,))


def _zero_vec_term(x):
    return x.new_zeros(x.shape[:-1] + (0,))


@dataclass(frozen=True)
class OCPFunctions:
    """Problem callables.  ``stage_residuals`` / ``stage_rest`` optionally
    decompose the stage cost as 0.5·‖r‖² + rest; ``control_squash`` /
    ``control_unsquash`` are the tanh box maps when the controls are
    squashed."""

    step: Callable
    stage_cost: Callable
    terminal_cost: Callable
    ineq: Callable = _zero_vec
    eq: Callable = _zero_vec
    terminal_ineq: Callable = _zero_vec_term
    terminal_eq: Callable = _zero_vec_term
    feedback_mask: Optional[tuple] = None
    stage_residuals: Optional[Callable] = None
    stage_rest: Optional[Callable] = None
    control_squash: Optional[Callable] = None
    control_unsquash: Optional[Callable] = None


def make_squash_maps(lb, ub, *, margin: float = 0.999, device="cuda"):
    """(squash, unsquash) for a control box: u = mid + half·tanh(w), the
    tanh saturating as the reference's does (``saturating_tanh``)."""
    dev = resolve_device(device)
    lb = torch.as_tensor(lb, dtype=torch.float32, device=dev)
    ub = torch.as_tensor(ub, dtype=torch.float32, device=dev)
    mid = 0.5 * (lb + ub)
    half = 0.5 * (ub - lb)
    safe_half = torch.where(half > 0, half, torch.ones_like(half))
    live = (half > 0).to(torch.float32)

    def squash(w):
        return mid + half * saturating_tanh(w)

    def unsquash(u):
        return torch.atanh(clip((u - mid) / safe_half, -margin, margin)) * live

    return squash, unsquash


def squash_controls(ocp: OCPFunctions, lb, ub, *, margin: float = 0.999,
                    device="cuda"):
    """Reparameterise the controls through the tanh squash so the box
    holds exactly; returns (squashed_ocp, squash, unsquash)."""
    squash, unsquash = make_squash_maps(lb, ub, margin=margin, device=device)

    def wrap(f):
        if f is None:
            return None
        return lambda x, w, k: f(x, squash(w), k)

    squashed = replace(ocp, step=wrap(ocp.step),
                       stage_cost=wrap(ocp.stage_cost), ineq=wrap(ocp.ineq),
                       eq=wrap(ocp.eq),
                       stage_residuals=wrap(ocp.stage_residuals),
                       stage_rest=wrap(ocp.stage_rest),
                       control_squash=squash, control_unsquash=unsquash)
    return squashed, squash, unsquash


@dataclass
class ALState:
    """Augmented-Lagrangian multipliers and penalties, batch-leading."""

    lam_ineq: torch.Tensor    # (B, N, n_ineq)
    lam_eq: torch.Tensor      # (B, N, n_eq)
    lam_t_ineq: torch.Tensor  # (B, n_t_ineq)
    lam_t_eq: torch.Tensor    # (B, n_t_eq)
    mu: torch.Tensor          # (B,)
    mu_row: torch.Tensor      # (B, n_ineq)

    def where(self, mask: torch.Tensor, other: "ALState") -> "ALState":
        """Scenario by scenario: ``other`` where ``mask`` (B,) is set."""
        def pick(mine, theirs):
            return torch.where(mask.reshape((-1,) + (1,) * (mine.ndim - 1)),
                               theirs, mine)
        return ALState(*(pick(getattr(self, f), getattr(other, f))
                         for f in _AL_FIELDS))

    def index(self, idx: torch.Tensor) -> "ALState":
        """The scenarios ``idx`` (a (k,) integer tensor, on any device)."""
        return ALState(*(getattr(self, f).index_select(
            0, idx.to(self.mu.device)) for f in _AL_FIELDS))

    @staticmethod
    def cat(states) -> "ALState":
        """Batches of multipliers joined along the scenario axis."""
        return ALState(*(torch.cat([getattr(s, f) for s in states])
                         for f in _AL_FIELDS))


_AL_FIELDS = ("lam_ineq", "lam_eq", "lam_t_ineq", "lam_t_eq", "mu", "mu_row")


def knot_tensor(k, x):
    """The knot index k as an integer tensor on x's device (a Python int
    filled in there, not copied)."""
    if isinstance(k, torch.Tensor):
        return k.to(x.device)
    return torch.full((), k, dtype=torch.int64, device=x.device)


def init_al_state(ocp: OCPFunctions, x0: torch.Tensor, u0: torch.Tensor,
                  N: int, mu0: float = 10.0) -> ALState:
    """Zero multipliers, penalty ``mu0`` and unit row factors for a batch
    of initial states x0 (B, n) and controls u0 (B, m)."""
    k0 = knot_tensor(0, x0)
    n_ineq = ocp.ineq(x0, u0, k0).shape[-1]
    n_eq = ocp.eq(x0, u0, k0).shape[-1]
    n_ti = ocp.terminal_ineq(x0).shape[-1]
    n_te = ocp.terminal_eq(x0).shape[-1]
    B = x0.shape[0]
    z = lambda *s: x0.new_zeros(s)
    return ALState(lam_ineq=z(B, N, n_ineq), lam_eq=z(B, N, n_eq),
                   lam_t_ineq=z(B, n_ti), lam_t_eq=z(B, n_te),
                   mu=x0.new_full((B,), mu0),
                   mu_row=x0.new_ones((B, n_ineq)))


def shift_al_state(al: ALState, commit: int, mu0: float = 10.0,
                   lam_max: float = 1e3, decay=1.0) -> ALState:
    """Receding-horizon dual warm start: shift the stage multipliers by the
    committed prefix (hold the tail), cap them at ``lam_max``, scale them by
    ``decay`` (per scenario, (B,), or a scalar), keep the terminal
    multipliers and the row factors, and restart the penalty at ``mu0``."""
    decay = torch.as_tensor(decay, dtype=al.mu.dtype, device=al.mu.device)
    d3 = decay.reshape(decay.shape + (1, 1)) if decay.ndim else decay
    d2 = decay.reshape(decay.shape + (1,)) if decay.ndim else decay

    def _shift(lam):
        lam = torch.clamp(lam * d3, -lam_max, lam_max)
        return torch.cat([lam[:, commit:],
                          lam[:, -1:].expand(-1, commit, -1)], dim=1)

    return ALState(lam_ineq=_shift(al.lam_ineq), lam_eq=_shift(al.lam_eq),
                   lam_t_ineq=al.lam_t_ineq * d2, lam_t_eq=al.lam_t_eq * d2,
                   mu=torch.full_like(al.mu, mu0), mu_row=al.mu_row)


def gated_decay(violation: torch.Tensor, gate: float) -> torch.Tensor:
    """1.0 (carry the duals) where the window solved to within ``gate``,
    0.0 (hand cold duals forward) where it did not."""
    return (violation <= gate).to(torch.float32)


def _plus(t):
    """max(t, 0) whose derivative at 0 is ½, as ``jnp.maximum``'s is:
    the exact AL Hessian of a row sitting at g + λ/μ = 0 (zero multipliers
    on a row at its bound) weighs ¼ μ ∇g∇gᵀ there, as the reference's
    does; ``torch.clamp_min`` would give it all of μ ∇g∇gᵀ."""
    return torch.maximum(t, torch.zeros_like(t))


def _stage_al(ocp, lam_g, lam_h, mu, mu_row, x, u, k):
    """AL stage cost with multipliers already indexed to the knots of x;
    mu and mu_row broadcast against x's batch axes."""
    c = ocp.stage_cost(x, u, k)
    g = ocp.ineq(x, u, k)
    h = ocp.eq(x, u, k)
    mu_g = mu[..., None] * mu_row
    gplus = _plus(g + lam_g / mu_g)
    c = (c + 0.5 * torch.sum(mu_g * gplus * gplus, dim=-1)
         - 0.5 * torch.sum(lam_g * lam_g / mu_g, dim=-1))
    return (c + torch.sum(lam_h * h, dim=-1)
            + 0.5 * mu * torch.sum(h * h, dim=-1))


def al_stage_cost(ocp: OCPFunctions, al: ALState, x, u, k: int):
    """Stage cost + PHR penalty at knot ``k`` for x (B, n), u (B, m):
    active when g + λ/μᵢ > 0, with μᵢ = mu · mu_row[i]."""
    return _stage_al(ocp, al.lam_ineq[:, k], al.lam_eq[:, k], al.mu,
                     al.mu_row, x, u, knot_tensor(k, x))


def al_terminal_cost(ocp: OCPFunctions, al: ALState, x):
    """Terminal cost + PHR penalty for x (B, n)."""
    c = ocp.terminal_cost(x)
    g = ocp.terminal_ineq(x)
    h = ocp.terminal_eq(x)
    mu = al.mu
    gplus = _plus(g + al.lam_t_ineq / mu[:, None])
    c = (c + 0.5 * mu * torch.sum(gplus * gplus, dim=-1)
         - 0.5 * torch.sum(al.lam_t_ineq ** 2, dim=-1) / mu)
    return (c + torch.sum(al.lam_t_eq * h, dim=-1)
            + 0.5 * mu * torch.sum(h * h, dim=-1))


def al_total_cost(ocp: OCPFunctions, al: ALState, xs, us):
    """AL cost of whole trajectories xs (B, N+1, n), us (B, N, m), (B,)."""
    ks = torch.arange(us.shape[1], device=xs.device)
    stage = _stage_al(ocp, al.lam_ineq, al.lam_eq, al.mu[:, None],
                      al.mu_row[:, None], xs[:, :-1], us, ks)
    return torch.sum(stage, dim=1) + al_terminal_cost(ocp, al, xs[:, -1])


def true_cost(ocp: OCPFunctions, xs, us):
    """Un-augmented trajectory cost, (B,)."""
    ks = torch.arange(us.shape[1], device=xs.device)
    return (torch.sum(ocp.stage_cost(xs[:, :-1], us, ks), dim=1)
            + ocp.terminal_cost(xs[:, -1]))


def rollout_defect(ocp: OCPFunctions, xs, us):
    """Max dynamics defect ‖x_{k+1} − F(x_k, u_k)‖∞ of each trajectory
    xs (B, N+1, n), us (B, N, m), (B,): whether (xs, us) is a true
    rollout.  A solve seeded through ``xs_init`` that never accepted a
    rollout hands its seed back, so callers gate on this.  The knots go
    to ``ocp.step`` as B·N rows, scenario-major."""
    Bz, N, m = us.shape
    n = xs.shape[-1]
    ks = torch.arange(N, device=xs.device).repeat(Bz)
    nxt = ocp.step(xs[:, :-1].reshape(-1, n), us.reshape(-1, m), ks)
    return torch.amax(torch.abs(nxt.reshape(Bz, N, n) - xs[:, 1:]),
                      dim=(1, 2))


def _max0(t, dims):
    """max(t, 0) reduced over ``dims`` (0 for an empty reduction)."""
    if t.numel() == 0:
        return t.new_zeros(t.shape[:len(t.shape) - len(dims)])
    return torch.clamp_min(torch.amax(t, dim=dims), 0.0)


def max_violation(ocp: OCPFunctions, xs, us):
    """Worst constraint violation along each trajectory, (B,)."""
    ks = torch.arange(us.shape[1], device=xs.device)
    g = ocp.ineq(xs[:, :-1], us, ks)
    h = ocp.eq(xs[:, :-1], us, ks)
    v = torch.maximum(_max0(g, (1, 2)), _max0(torch.abs(h), (1, 2)))
    vt = torch.maximum(_max0(ocp.terminal_ineq(xs[:, -1]), (1,)),
                       _max0(torch.abs(ocp.terminal_eq(xs[:, -1])), (1,)))
    return torch.maximum(v, vt)


def update_multipliers(ocp: OCPFunctions, al: ALState, xs, us,
                       penalty_scale: float, penalty_max: float,
                       row_adapt: bool = False, row_scale: float = 10.0,
                       row_max: float = 1e3,
                       row_target: float = 1e-2) -> ALState:
    """First-order multiplier update and penalty increase.  ``row_adapt``
    escalates the factor of every stage-inequality row whose worst
    violation over the horizon still exceeds ``row_target``."""
    ks = torch.arange(us.shape[1], device=xs.device)
    mu = al.mu
    mu_g = mu[:, None, None] * al.mu_row[:, None]
    g = ocp.ineq(xs[:, :-1], us, ks)
    h = ocp.eq(xs[:, :-1], us, ks)
    lam_ineq = torch.clamp_min(al.lam_ineq + mu_g * g, 0.0)
    lam_eq = al.lam_eq + mu[:, None, None] * h
    lam_t_ineq = torch.clamp_min(
        al.lam_t_ineq + mu[:, None] * ocp.terminal_ineq(xs[:, -1]), 0.0)
    lam_t_eq = al.lam_t_eq + mu[:, None] * ocp.terminal_eq(xs[:, -1])
    mu_row = al.mu_row
    if row_adapt and g.shape[-1] > 0:
        v_row = torch.amax(torch.clamp_min(g, 0.0), dim=1)
        mu_row = torch.where(v_row > row_target,
                             torch.clamp_max(al.mu_row * row_scale, row_max),
                             al.mu_row)
    return ALState(lam_ineq=lam_ineq, lam_eq=lam_eq, lam_t_ineq=lam_t_ineq,
                   lam_t_eq=lam_t_eq,
                   mu=torch.clamp_max(mu * penalty_scale, penalty_max),
                   mu_row=mu_row)
