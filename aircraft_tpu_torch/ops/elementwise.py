"""Elementwise helpers that keep the reference's derivative rules."""

from __future__ import annotations

import torch


def scalar_like(x: torch.Tensor, v) -> torch.Tensor:
    """``v`` as a 0-dim tensor of x's dtype on x's device.  A Python number
    is filled in on the device, not copied from the host, so the stream
    does not synchronise."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype=x.dtype, device=x.device)
    return torch.full((), v, dtype=x.dtype, device=x.device)


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """min(max(x, lo), hi).  At a bound the tangent splits evenly, as the
    reference's clip does; ``torch.clamp`` would pass all of it."""
    return torch.minimum(torch.maximum(x, scalar_like(x, lo)),
                         scalar_like(x, hi))


# The reference's float32 tanh (XLA's) returns exactly ±1, with zero slope,
# from |x| = 7.9989; torch's correctly rounded tanh reaches ±1 only near
# 9.0, leaving a slope of 1e-7 to 5e-7 between the two.
TANH_ONE = 7.9989


def saturating_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh that is exactly ±1 with zero slope from |x| = ``TANH_ONE``, as
    the reference's is.  The control squash needs it: on a saturated
    channel the residual slope is all the gradient there is, and the
    Riccati step divides it by the ~1e-6 regulariser, which swings the
    channel from bound to bound where the reference holds it still."""
    return torch.where(torch.abs(x) >= TANH_ONE, torch.sign(x),
                       torch.tanh(x))
