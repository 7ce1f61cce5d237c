"""Forward-mode Jacobians of batched functions.

``torch.func.jacfwd`` under ``vmap`` over single samples promotes the
tangents of 0-dim intermediates multiplied by Python floats to float64.
These helpers keep the batch axis on every intermediate instead: they
push one basis direction per ``vmap`` lane through ``torch.func.jvp`` of
the whole batch.  The samples must be independent (row b of the output
depends only on row b of each input), so each row's tangent is that
sample's Jacobian column.
"""

from __future__ import annotations

import torch


def batched_jacfwd(f, *args):
    """Per-sample Jacobian of ``f``, which maps args (B, d_i) to (B, m):
    returns (B, m, Σ d_i), the input columns in argument order."""
    dims = [a.shape[-1] for a in args]
    eye = torch.eye(sum(dims), dtype=args[0].dtype, device=args[0].device)
    basis = torch.split(eye, dims, dim=1)

    def tangent(*dirs):
        return torch.func.jvp(
            f, args, tuple(d.expand_as(a) for d, a in zip(dirs, args)))[1]

    return torch.func.vmap(tangent)(*basis).permute(1, 2, 0)


def batched_grad_hessian(f, x):
    """Per-sample gradient (B, n) and Hessian (B, n, n) of a batched
    scalar function f: (B, n) -> (B,)."""
    def grad(y):
        return torch.func.grad(lambda z: torch.sum(f(z)))(y)

    return grad(x), batched_jacfwd(grad, x)
