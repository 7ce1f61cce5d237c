"""Process meshes for scale-out over ``torch.distributed``.

The reference places a scenario batch on a JAX device mesh and lets GSPMD
partition the program (``aircraft_tpu/parallel/mesh.py``).  Here one
process is one rank: a rank holds its contiguous block of the batch on its
own device and the cross-rank reductions are explicit collectives.  On
``cuda`` each rank owns one card and the backend is NCCL, which refuses
two ranks on one card; on ``cpu`` the ranks are gloo processes, standing
in for the reference's virtual CPU devices.  There is no fallback: a mesh
on ``cuda`` runs over NCCL or is not made.

``spawn(fn, world, device=..., args=...)`` starts the ranks and calls
``fn(mesh, *args)`` in each; nothing here starts a process or opens a
group at import time.
"""

from __future__ import annotations

import dataclasses
import datetime
import pickle
import tempfile
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from aircraft_tpu_torch.device import resolve_device

BATCH_AXIS = "dp"
TENSOR_AXIS = "tp"

RENDEZVOUS_TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a mesh.  ``rank`` and ``size`` are its position
    along the first axis (``axis_names[0]``, the axis a batch is split
    over) and that axis' length, ``group`` the process group of the ranks
    on that axis with it (``None``: the default group, when the mesh is
    1-D), ``device`` where its blocks live.

    A (dp x tp) mesh (``make_mesh(tp > 1)``) also carries its coordinates
    ``dp`` and ``tp``, the axis lengths ``tp_size``, and ``tp_group``: the
    ranks of its dp row, which share its batch block and split the
    tensor axis (``group`` is then the ranks of its tp column, the dp
    axis).  A 1-D mesh has ``tp = 0``, ``tp_size = 1`` and no
    ``tp_group``."""

    rank: int
    size: int
    device: torch.device
    group: Optional[object] = None
    axis_names: tuple = (BATCH_AXIS, TENSOR_AXIS)
    tp: int = 0
    tp_size: int = 1
    tp_group: Optional[object] = None

    @property
    def dp(self) -> int:
        return self.rank

    @property
    def world(self) -> int:
        return self.size * self.tp_size


def current_mesh(device="cuda", axis_names=(BATCH_AXIS, TENSOR_AXIS)) -> Mesh:
    """The mesh of the initialised default process group on ``device``:
    NCCL and this rank's card on ``cuda``, gloo on ``cpu``."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: start the ranks with parallel.spawn or call "
            "torch.distributed.init_process_group first")
    backend = dist.get_backend()
    want = "nccl" if dev.type == "cuda" else "gloo"
    if backend != want:
        raise RuntimeError(f"a {dev.type} mesh runs over {want}; the process "
                           f"group runs over {backend}")
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(dist.get_rank(), dist.get_world_size(), dev,
                axis_names=tuple(axis_names))


def make_mesh(n_devices: Optional[int] = None, *, tp: int = 1,
              device="cuda") -> Mesh:
    """The (dp x tp) mesh of the current process group, its ranks laid
    out as an (n // tp, tp) array as the reference lays its devices: rank
    r is at dp r // tp, tp r % tp.  dp carries the scenario batch; tp
    splits the surrogate MLP's hidden layer (``parallel/tensor.py``).
    ``n_devices`` must be the group's size (a smaller mesh is a smaller
    group: spawn fewer ranks) and a multiple of ``tp``.

    ``tp = 1`` is the 1-D mesh of the default group.  For ``tp > 1`` every
    rank opens one group per dp row and one per tp column (each rank
    takes part in every ``new_group`` call, in the same order) and keeps
    its own two."""
    mesh = current_mesh(device)
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(f"make_mesh({n_devices}) in a group of {mesh.size} "
                         "ranks")
    n = mesh.size
    if tp < 1 or n % tp:
        raise ValueError(f"tp={tp} does not divide a mesh of {n} ranks")
    if tp == 1:
        return mesh
    dp, t = divmod(mesh.rank, tp)
    rows = [dist.new_group(list(range(i * tp, (i + 1) * tp)))
            for i in range(n // tp)]
    cols = [dist.new_group(list(range(j, n, tp))) for j in range(tp)]
    return dataclasses.replace(mesh, rank=dp, size=n // tp, group=cols[t],
                               tp=t, tp_size=tp, tp_group=rows[dp])


def batch_sharding(mesh: Mesh, batch: int) -> slice:
    """This rank's rows of a batch of ``batch`` rows: the contiguous
    block the reference's leading-axis ``NamedSharding`` places on it."""
    if batch % mesh.size:
        raise ValueError(f"a batch of {batch} does not split over "
                         f"{mesh.size} ranks")
    per = batch // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def _tree_map(fn, tree):
    """``fn`` on every tensor of a tree of tuples (named or not), lists,
    dicts and dataclasses; other leaves are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a collective moves it: contiguous, and a bool tensor as
    uint8 (gloo moves no bool)."""
    t = t.contiguous()
    return t.to(torch.uint8) if t.dtype == torch.bool else t


def shard_batch(tree, mesh: Mesh):
    """This rank's block of the leading axis of every tensor in ``tree``,
    on the rank's device; raises when a batch does not split evenly."""
    return _tree_map(lambda t: t[batch_sharding(mesh, t.shape[0])].to(
        mesh.device).contiguous(), tree)


def _first_rank(mesh: Mesh) -> int:
    """The global rank of the first rank of ``mesh.group``."""
    return 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)


def replicated(tree, mesh: Mesh):
    """Every tensor of ``tree`` as the first rank of the mesh's batch axis
    holds it, on every rank's device (a broadcast from it)."""
    def bcast(t):
        # a copy: the broadcast writes into it, never into the caller's
        buf = _wire(t.to(mesh.device, copy=True))
        dist.broadcast(buf, src=_first_rank(mesh), group=mesh.group)
        return buf.to(t.dtype)

    return _tree_map(bcast, tree)


def gather_batch(tree, mesh: Mesh):
    """The ranks' blocks of every tensor in ``tree`` joined back along
    the leading axis, on every rank (an all-gather): reading a sharded
    batch whole."""
    def gather(t):
        buf = _wire(t.to(mesh.device))
        parts = [torch.empty_like(buf) for _ in range(mesh.size)]
        dist.all_gather(parts, buf, group=mesh.group)
        return torch.cat(parts).to(t.dtype)

    return _tree_map(gather, tree)


def _rank_main(rank, fn, world, device_type, init_method, out_dir, args):
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        dist.init_process_group("nccl", init_method=init_method,
                                world_size=world, rank=rank,
                                timeout=RENDEZVOUS_TIMEOUT,
                                device_id=torch.device("cuda", rank))
    else:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=init_method,
                                world_size=world, rank=rank,
                                timeout=RENDEZVOUS_TIMEOUT)
    try:
        result = fn(current_mesh(device_type), *args)
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *, device="cuda", args=(), tmpdir=None) -> list:
    """Run ``fn(mesh, *args)`` on ``world`` ranks, one process each,
    started with the ``spawn`` method (CUDA cannot live in a forked
    child), and return their results by rank (each pickled back to the
    caller, so host values only).

    The ranks meet through a ``file://`` store in a new directory under
    ``tmpdir`` (the system's temporary directory by default).  On
    ``cuda`` rank r takes ``cuda:r`` over NCCL; a world larger than the
    visible cards raises before any rank starts, and the kernels are built
    here first, so the ranks only load them.  On ``cpu`` the ranks run
    gloo with one thread each.  A rank that raises makes the call raise
    (the other ranks are stopped)."""
    dev = resolve_device(device)
    if world < 1:
        raise ValueError(f"world={world}")
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(f"{world} ranks need {world} cards; "
                             f"{cards} visible (NCCL takes one rank per card)")
        from aircraft_tpu_torch.kernels import _build

        _build.build_all()
    with tempfile.TemporaryDirectory(prefix="aircraft_tpu_torch_ranks_",
                                     dir=tmpdir) as run_dir:
        init = Path(run_dir, "rendezvous").as_uri()
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, world, dev.type, init, run_dir, args),
            nprocs=world, join=True, start_method="spawn")
        results = []
        for r in range(world):
            with open(Path(run_dir) / f"rank{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
    return results
