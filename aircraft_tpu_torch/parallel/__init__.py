"""Scale-out over ``torch.distributed``: data-parallel fleet solves and the
horizon-sharded Riccati sweep (the port of ``aircraft_tpu/parallel``)."""

from aircraft_tpu_torch.parallel.mesh import (
    BATCH_AXIS,
    TENSOR_AXIS,
    batch_sharding,
    gather_batch,
    make_mesh,
    replicated,
    shard_batch,
    spawn,
)
from aircraft_tpu_torch.parallel.batched import BatchSummary, solve_batch_sharded
from aircraft_tpu_torch.parallel.seq_riccati import (
    SEQ_AXIS,
    backward_associative_sharded,
    make_seq_mesh,
)

__all__ = [
    "BATCH_AXIS",
    "TENSOR_AXIS",
    "SEQ_AXIS",
    "make_mesh",
    "make_seq_mesh",
    "batch_sharding",
    "replicated",
    "shard_batch",
    "gather_batch",
    "spawn",
    "BatchSummary",
    "solve_batch_sharded",
    "backward_associative_sharded",
]
