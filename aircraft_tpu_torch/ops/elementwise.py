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
