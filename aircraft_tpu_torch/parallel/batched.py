"""Sharded batched solves: a fleet of MPC scenarios spread over the ranks.

The port of ``aircraft_tpu/parallel/batched.py``.  The solver is already
batch-leading (``solvers/ilqr.py``), so sharding the batch is placement:
each rank solves its contiguous block, and the fleet's summary is reduced
across the ranks by two collectives on device tensors (SUM for the counts
and sums, MAX for the violation), as XLA inserts them for the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from aircraft_tpu_torch.config import SolverConfig
from aircraft_tpu_torch.parallel.mesh import Mesh, shard_batch
from aircraft_tpu_torch.solvers import ilqr
from aircraft_tpu_torch.solvers.ocp import OCPFunctions


class BatchSummary(NamedTuple):
    """Reductions over the whole scenario batch (device tensors, the same
    on every rank)."""

    n_converged: torch.Tensor
    mean_cost: torch.Tensor
    max_violation: torch.Tensor
    mean_iterations: torch.Tensor


def batch_sums(sols: ilqr.ILQRSolution) -> tuple:
    """(converged count, cost sum, iteration sum) as one float32 vector,
    and the largest violation, of a block of solutions."""
    sums = torch.stack([sols.converged.sum().to(torch.float32),
                        sols.cost.sum(),
                        sols.iterations.sum().to(torch.float32)])
    return sums, sols.violation.max()


def summarize(sums, vmax, batch: int) -> BatchSummary:
    """The summary of ``batch`` scenarios from their sums and largest
    violation."""
    return BatchSummary(n_converged=sums[0].to(torch.int64),
                        mean_cost=sums[1] / batch, max_violation=vmax,
                        mean_iterations=sums[2] / batch)


def solve_batch_sharded(ocp: OCPFunctions, x0s: torch.Tensor,
                        us_inits: torch.Tensor, mesh: Mesh,
                        config: SolverConfig = SolverConfig(), *,
                        cuda_chol: bool = False
                        ) -> tuple[ilqr.ILQRSolution, BatchSummary]:
    """Shard the scenario batch over the mesh's ranks and solve.

    Every rank passes the whole batch (x0s (B, n), us_inits (B, N, m)) and
    gets back its own block's ``ILQRSolution`` and the summary of all B
    scenarios (means over the global batch), reduced on the device with no
    host read.  ``ocp`` lives on the rank's device; ``cuda_chol`` puts the
    Riccati solves on the batched-Cholesky kernel."""
    batch = x0s.shape[0]
    sols = ilqr.solve_batch(ocp, shard_batch(x0s, mesh),
                            shard_batch(us_inits, mesh), config,
                            cuda_chol=cuda_chol)
    sums, vmax = batch_sums(sols)
    dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=mesh.group)
    dist.all_reduce(vmax, op=dist.ReduceOp.MAX, group=mesh.group)
    return sols, summarize(sums, vmax, batch)
