"""Elementwise helpers that keep the reference's derivative rules."""

from __future__ import annotations

import torch


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """min(max(x, lo), hi).  At a bound the tangent splits evenly, as the
    reference's clip does; ``torch.clamp`` would pass all of it."""
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)
