"""Sequence-parallel Riccati: the horizon sharded over the ranks.

The port of ``aircraft_tpu/parallel/seq_riccati.py``.  The associative
conditional-value reduction (``solvers/riccati.py``) makes the backward
sweep a suffix scan, so it distributes like any parallel prefix:

1. each rank reduces its block of knots by a local suffix scan
   (``block_aggregate``); the block's aggregate is its first suffix;
2. the S aggregates are all-gathered (one collective of S small
   elements per scenario);
3. each rank folds the aggregates of the later blocks and the terminal
   element, late to early (``suffix_fold``);
4. each rank combines that suffix into its local suffixes shifted by one
   knot and recovers its knots' gains (``block_finish``); dv1 and dv2 are
   summed over the ranks, the largest |Qu| and the fail flag maxed.

The port is batch-leading, so the knot axis is axis 1 of every per-knot
tensor.  The three steps are pure functions with the collective between
them: ``backward_associative_blocked`` runs them for S blocks in one
process, stacking the aggregates where the ranks all-gather them, and
``backward_associative_sharded`` runs one block per rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from aircraft_tpu_torch.parallel.mesh import Mesh, current_mesh
from aircraft_tpu_torch.solvers.riccati import (cv_combine, cv_elements,
                                                cv_identity, cv_terminal,
                                                recover_gains, suffix_scan)

SEQ_AXIS = "sp"


def make_seq_mesh(n_devices=None, *, device="cuda") -> Mesh:
    """The 1-D mesh of the current process group whose axis carries the
    horizon."""
    mesh = current_mesh(device, axis_names=(SEQ_AXIS,))
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(f"make_seq_mesh({n_devices}) in a group of "
                         f"{mesh.size} ranks")
    return mesh


def block_aggregate(A, B, lx, lu, lxx, luu, lux, reg):
    """One block of knots (each tensor (Bz, n_blk, ...)) reduced locally:
    its suffixes r_k = e_k ⊕ … ⊕ e_last-of-block (each (Bz, n_blk, ...)),
    its aggregate r_0 (each (Bz, ...)) and the block's fail flag (Bz,)."""
    stage, fail = cv_elements(A, B, lx, lu, lxx, luu, lux, reg)
    suffixes = suffix_scan(stage)
    return suffixes, tuple(s[:, 0] for s in suffixes), fail


def suffix_fold(aggs, vx, vxx, block: int):
    """The value of every knot after block ``block``: the terminal element
    folded late to early with the aggregates of blocks S-1, …, block+1
    (``aggs`` stacked (S, Bz, ...)).  The reference folds all S under the
    mask j > block (SPMD); a rank knows its index, so only the kept
    combines run."""
    carry = cv_terminal(vx, vxx)
    for j in range(aggs[0].shape[0] - 1, block, -1):
        carry = cv_combine(carry, tuple(a[j] for a in aggs))
    return carry


def block_finish(A, B, lu, luu, lux, suffixes, suffix, reg, fail, *,
                 cuda_chol: bool = False):
    """The block's gains from its local suffixes and the suffix of the
    later blocks: V_{k+1} of knot k is ``suffix`` ⊕ r_{k+1}, the identity
    standing in for r past the block's last knot.  Returns K (Bz, n_blk,
    m, n), k (Bz, n_blk, m), the block's Σ dv1, Σ dv2, max |Qu| and fail
    flag, each (Bz,); the Quu solves in one call (one batched-Cholesky
    launch on the kernel route)."""
    Bz, n_blk, n = A.shape[0], A.shape[1], A.shape[-1]
    ident = cv_identity(n, A.dtype, A.device, batch=(Bz, 1))
    shifted = tuple(torch.cat([s[:, 1:], i], dim=1)
                    for s, i in zip(suffixes, ident))
    late = tuple(s[:, None].expand((Bz, n_blk) + s.shape[1:])
                 for s in suffix)
    final = cv_combine(late, shifted)
    K, k, dv1, dv2, qu, bad = recover_gains(A, B, lu, luu, lux, -final[3],
                                            final[4], reg,
                                            cuda_chol=cuda_chol)
    return K, k, dv1.sum(1), dv2.sum(1), qu.amax(1), fail | bad.any(dim=1)


def _check_blocks(N: int, S: int) -> int:
    if N % S:
        raise ValueError(f"a horizon of {N} knots does not split into {S} "
                         "blocks")
    return N // S


def backward_associative_blocked(S: int, A, B, lx, lu, lxx, luu, lux, vx,
                                 vxx, reg, *, cuda_chol: bool = False):
    """The horizon-sharded sweep's arithmetic for S blocks in one process:
    the blocks' aggregates stacked where the ranks all-gather them, each
    block finished with its own suffix.  Arguments and results as
    ``riccati.backward_associative`` (K, k whole)."""
    blk = _check_blocks(A.shape[1], S)
    knots = (A, B, lx, lu, lxx, luu, lux)
    blocks = [block_aggregate(*(t[:, s * blk:(s + 1) * blk] for t in knots),
                              reg) for s in range(S)]
    aggs = tuple(torch.stack(a) for a in zip(*(b[1] for b in blocks)))
    outs = []
    for s, (suffixes, _, fail) in enumerate(blocks):
        A_s, B_s, _, lu_s, _, luu_s, lux_s = (
            t[:, s * blk:(s + 1) * blk] for t in knots)
        outs.append(block_finish(A_s, B_s, lu_s, luu_s, lux_s, suffixes,
                                 suffix_fold(aggs, vx, vxx, s), reg, fail,
                                 cuda_chol=cuda_chol))
    K, k, dv1, dv2, qu, fail = zip(*outs)
    return (torch.cat(K, dim=1), torch.cat(k, dim=1), sum(dv1), sum(dv2),
            torch.stack(qu).amax(0), torch.stack(fail).any(0))


def _all_gather_elements(agg, mesh: Mesh):
    """Every rank's aggregate, stacked (S, Bz, ...), in one collective."""
    Bz = agg[0].shape[0]
    flat = torch.cat([a.reshape(Bz, -1) for a in agg], dim=1).contiguous()
    parts = [torch.empty_like(flat) for _ in range(mesh.size)]
    dist.all_gather(parts, flat, group=mesh.group)
    stacked = torch.stack(parts)
    sizes = [a[0].numel() for a in agg]
    return tuple(p.reshape((mesh.size, Bz) + a.shape[1:]) for p, a in zip(
        torch.split(stacked, sizes, dim=2), agg))


def backward_associative_sharded(mesh: Mesh, A, B, lx, lu, lxx, luu, lux,
                                 vx, vxx, reg, *, cuda_chol: bool = False):
    """Horizon-sharded Riccati backward sweep on this rank's block.

    Every rank passes the whole horizon (per-knot tensors (Bz, N, ...), N
    a multiple of the mesh size; vx (Bz, n), vxx, reg (Bz,)).  Returns this
    rank's K (Bz, N/S, m, n) and k, and the whole horizon's Σ dv1, Σ dv2,
    max |Qu| and fail flag (Bz,), the same on every rank."""
    blk = _check_blocks(A.shape[1], mesh.size)
    sl = slice(mesh.rank * blk, (mesh.rank + 1) * blk)
    A, B, lx, lu, lxx, luu, lux = (t[:, sl] for t in (A, B, lx, lu, lxx,
                                                       luu, lux))
    suffixes, agg, fail = block_aggregate(A, B, lx, lu, lxx, luu, lux, reg)
    aggs = _all_gather_elements(agg, mesh)
    K, k, dv1, dv2, qu, fail = block_finish(
        A, B, lu, luu, lux, suffixes, suffix_fold(aggs, vx, vxx, mesh.rank),
        reg, fail, cuda_chol=cuda_chol)
    sums = torch.stack([dv1, dv2])
    flags = torch.stack([qu, fail.to(qu.dtype)])
    dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=mesh.group)
    dist.all_reduce(flags, op=dist.ReduceOp.MAX, group=mesh.group)
    return K, k, sums[0], sums[1], flags[0], flags[1] > 0
