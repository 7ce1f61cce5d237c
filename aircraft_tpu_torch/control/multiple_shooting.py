"""Multiple shooting as an OCP transform for the AL-iLQR solver.

A multiple-shooting transcription makes every knot state a decision
variable with the dynamics as defect constraints, so the solve can start
from an infeasible state guess (the Dubins initialisation).  Single-
shooting iLQR cannot take a state guess: its iterate is a control
sequence.  This transform gives it one: the horizon splits into segments,
each segment's start state becomes an augmented control at its first
knot, the rollout restarts from it, and the defect x_k − s_k = 0 is an
equality row of the augmented Lagrangian.  Early iterates may jump at
segment starts; the AL schedule closes the defects.

    v_k = [u_k (m), s_k (n)]     s_k live only at segment starts
"""

from __future__ import annotations

import torch

from aircraft_tpu_torch.solvers.ocp import OCPFunctions, knot_tensor


def multiple_shooting_ocp(base: OCPFunctions, state_dim: int,
                          control_dim: int, segment_len: int, *,
                          defect_scale: float = 1.0) -> OCPFunctions:
    """Wrap ``base`` so segment-start states are decision variables."""
    n, m = state_dim, control_dim

    def seg_start(x, k):
        k = knot_tensor(k, x)
        return ((torch.remainder(k, segment_len) == 0) & (k > 0))[..., None]

    def x_eff(x, v, k):
        return torch.where(seg_start(x, k), v[..., m:m + n], x)

    def step(x, v, k):
        return base.step(x_eff(x, v, k), v[..., :m], k)

    def stage_cost(x, v, k):
        return base.stage_cost(x_eff(x, v, k), v[..., :m], k)

    def ineq(x, v, k):
        return base.ineq(x_eff(x, v, k), v[..., :m], k)

    def eq(x, v, k):
        defect = torch.where(seg_start(x, k),
                             (x - v[..., m:m + n]) * defect_scale,
                             torch.zeros_like(x))
        return torch.cat([base.eq(x_eff(x, v, k), v[..., :m], k), defect],
                         dim=-1)

    return OCPFunctions(step=step, stage_cost=stage_cost,
                        terminal_cost=base.terminal_cost, ineq=ineq, eq=eq,
                        terminal_ineq=base.terminal_ineq,
                        terminal_eq=base.terminal_eq)


def controls_with_state_guess(us: torch.Tensor, state_guess: torch.Tensor,
                              segment_len: int) -> torch.Tensor:
    """The augmented control warm start: controls with the per-knot state
    guess in the s channels (only segment starts are read; filling every
    knot keeps the shape uniform).  us (..., N, m), state_guess
    (..., N+1, n) -> (..., N, m+n)."""
    us = torch.as_tensor(us)
    sg = torch.as_tensor(state_guess, dtype=us.dtype, device=us.device)
    return torch.cat([us, sg[..., :us.shape[-2], :]], dim=-1)
