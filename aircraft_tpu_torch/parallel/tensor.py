"""Tensor-parallel training step of the aero surrogate MLP over a
(dp x tp) mesh (``make_mesh(n, tp=...)``).

The reference places the 5-16-32-6 MLP on its device mesh with
``NamedSharding``s and lets GSPMD partition one jitted Adam step
(``__graft_entry__.dryrun_multichip``).  Here that layout is written as
explicit collectives:

* ``w0`` (5, 16) and ``b0`` (16,) are split by output column over tp,
  and ``w1`` (16, 32) by row, so each tp rank holds 16 / tp hidden units
  of the first layer and the matching rows of the second.  The MLP has
  no activation between its first two layers, so each rank's (B, 32)
  partial product is summed with one all-reduce over its tp group before
  ``b1``, tanh and ``w2`` (the row-parallel sum: forward all-reduce,
  backward identity, since every tp rank runs the same tail on the summed
  product).  The standardised input enters the column split through the
  converse (forward identity, backward all-reduce over tp), so the
  scalers' gradients are whole on every rank.
* ``b1``, ``w2``, ``b2`` and the four scalers are replicated; the batch
  is split over dp.
* The loss is the weighted MSE over the global batch.  The gradients of
  the tp-split leaves are all-reduced over the dp group; those of the
  replicated leaves over the world and divided by tp (their tp copies are
  equal, and an all-reduce over every rank keeps the replicas equal bit
  for bit).  Then every rank takes ``torch.optim.Adam``'s step (eps 1e-8
  outside the square root, as ``train_mlp`` and optax take it) on its own
  leaves: Adam is elementwise, so the shards step as the whole would.

The row-parallel sum and the dp all-reduce add in another order than the
unsharded matmul does, so a step matches the unsharded one to rounding,
not bit for bit.
"""

from __future__ import annotations

from dataclasses import replace

import torch
import torch.distributed as dist

from aircraft_tpu_torch.dynamics.coefficients import MLP_KEYS, MLPCoeffParams
from aircraft_tpu_torch.parallel.mesh import Mesh

COLUMN_SPLIT = ("w0", "b0")    # split by output column (dim -1) over tp
ROW_SPLIT = ("w1",)            # split by input row (dim 0) over tp
TP_SPLIT = COLUMN_SPLIT + ROW_SPLIT
REPLICATED = tuple(k for k in MLP_KEYS if k not in TP_SPLIT)


def _split_dim(key: str) -> int:
    return -1 if key in COLUMN_SPLIT else 0


def _block(t: torch.Tensor, key: str, mesh: Mesh) -> torch.Tensor:
    d = _split_dim(key)
    n = t.shape[d]
    if n % mesh.tp_size:
        raise ValueError(f"{key}: {n} hidden units do not split over "
                         f"tp={mesh.tp_size}")
    per = n // mesh.tp_size
    return t.narrow(d, mesh.tp * per, per)


def shard_mlp(cp: MLPCoeffParams, mesh: Mesh) -> MLPCoeffParams:
    """This rank's leaves of ``cp`` (every rank passes the whole MLP):
    its tp block of ``w0``, ``b0`` and ``w1``, the rest whole, each a
    contiguous copy on the rank's device."""
    return replace(cp, **{
        k: (_block(getattr(cp, k), k, mesh) if k in TP_SPLIT
            else getattr(cp, k)).detach().to(mesh.device, copy=True)
        .contiguous() for k in MLP_KEYS})


def gather_mlp(local: MLPCoeffParams, mesh: Mesh) -> MLPCoeffParams:
    """The whole MLP from every tp rank's leaves, on every rank (an
    all-gather over the tp group of each split leaf)."""
    out = {}
    for k in TP_SPLIT:
        t = getattr(local, k).detach().contiguous()
        parts = [t]
        if mesh.tp_size > 1:
            parts = [torch.empty_like(t) for _ in range(mesh.tp_size)]
            dist.all_gather(parts, t, group=mesh.tp_group)
        out[k] = torch.cat(parts, dim=_split_dim(k))
    return replace(local, **out, **{k: getattr(local, k).detach()
                                    for k in REPLICATED})


class _SumOverTP(torch.autograd.Function):
    """Forward: the sum of the tp ranks' partial products.  Backward:
    identity (every tp rank computes the same tail on the sum)."""

    @staticmethod
    def forward(ctx, partial, group):
        out = partial.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToTP(torch.autograd.Function):
    """Forward: identity.  Backward: the sum of the tp ranks' gradients
    (each rank's column block sees only its share of the input's
    gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


def tp_forward(local: MLPCoeffParams, x: torch.Tensor,
               mesh: Mesh) -> torch.Tensor:
    """``mlp_forward`` of the whole MLP on (B, 5) inputs, from this rank's
    leaves: the column block, one all-reduce over tp, the replicated
    tail."""
    h = (x - local.input_mean) / local.input_std
    if mesh.tp_size > 1:
        h = _CopyToTP.apply(h, mesh.tp_group)
    partial = (h @ local.w0 + local.b0) @ local.w1
    if mesh.tp_size > 1:
        partial = _SumOverTP.apply(partial, mesh.tp_group)
    h = torch.tanh(partial + local.b1)
    h = h @ local.w2 + local.b2
    return h * local.output_std + local.output_mean


class TensorParallelTrainer:
    """Adam on this rank's leaves of the MLP (``shard_mlp``): every leaf
    of ``MLPCoeffParams`` is trained, as the reference's step trains
    every leaf of its pytree.  ``step(xb, yb, weights, global_batch)``
    takes this rank's dp block of the batch and returns the global
    loss."""

    def __init__(self, local: MLPCoeffParams, mesh: Mesh, lr: float = 1e-3):
        self.mesh = mesh
        self.leaves = {k: getattr(local, k).detach().clone().requires_grad_()
                       for k in MLP_KEYS}
        self.template = local
        self.opt = torch.optim.Adam(list(self.leaves.values()), lr=lr,
                                    eps=1e-8)

    @property
    def params(self) -> MLPCoeffParams:
        return replace(self.template, **{k: v.detach()
                                         for k, v in self.leaves.items()})

    def step(self, xb: torch.Tensor, yb: torch.Tensor,
             weights: torch.Tensor, global_batch: int) -> torch.Tensor:
        mesh = self.mesh
        self.opt.zero_grad(set_to_none=True)
        pred = tp_forward(replace(self.template, **self.leaves), xb, mesh)
        # this block's share of the mean over the global batch
        loss = torch.sum(weights * (pred - yb) ** 2) / (
            global_batch * yb.shape[-1])
        loss.backward()
        for k, leaf in self.leaves.items():
            g = leaf.grad
            if k in TP_SPLIT:
                if mesh.size > 1:
                    dist.all_reduce(g, op=dist.ReduceOp.SUM, group=mesh.group)
            elif mesh.world > 1:
                dist.all_reduce(g, op=dist.ReduceOp.SUM)
                g.div_(mesh.tp_size)
        self.opt.step()
        total = loss.detach().clone()
        if mesh.size > 1:
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=mesh.group)
        return total
