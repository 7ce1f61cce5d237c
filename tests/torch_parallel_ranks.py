"""Rank functions of the torch-port parallel tests, for ``parallel.spawn``.

The ranks import this module by name, so it imports neither JAX nor the
JAX package: every rank builds the port's window OCP from numpy arrays
the test process read out of the reference (``port_ocp``).  Ranks return
host values only.
"""

import numpy as np
import torch

from aircraft_tpu_torch.config import glider_config
from aircraft_tpu_torch.control.course import COURSE_OCP_KNOBS
from aircraft_tpu_torch.control.mhtt import build_mhtt_ocp
from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
from aircraft_tpu_torch.dynamics.coefficients import mlp_from_numpy
from aircraft_tpu_torch.parallel import (gather_batch, replicated,
                                         shard_batch, solve_batch_sharded)
from aircraft_tpu_torch.parallel.seq_riccati import (
    backward_associative_sharded)
from aircraft_tpu_torch.solvers import ilqr

SOLUTION_FIELDS = ("xs", "us", "cost", "violation", "converged",
                   "iterations")


def port_ocp(problem: dict, device):
    """The port's window OCP from the reference's numbers: plant arrays,
    MLP weights, track points and length (``torch_port_problem.build_pair``
    makes the same one in the test process)."""
    coeff = mlp_from_numpy(problem["mlp"], device=device)
    params = AircraftParams.from_numpy(problem["params"], coeff=coeff,
                                       device=device)
    knobs = dict(COURSE_OCP_KNOBS)
    knobs["envelope_overrides"] = {**knobs["envelope_overrides"],
                                   "unit_scales": True}
    knobs["squash_box"] = True
    return build_mhtt_ocp(params, glider_config(),
                          torch.as_tensor(problem["pts"]), problem["length"],
                          dt=problem["dt"], v_ref=problem["v_ref"],
                          spec_out={}, **knobs)


def _host(sol) -> dict:
    return {f: getattr(sol, f).cpu().numpy() for f in SOLUTION_FIELDS}


def sweeps(mesh, problems) -> list:
    """``backward_associative_sharded`` on each LQ problem (numpy arrays,
    batch-leading); this rank's K, k block and the reduced scalars."""
    out = []
    for args in problems:
        res = backward_associative_sharded(
            mesh, *(torch.as_tensor(a) for a in args))
        out.append([t.cpu().numpy() for t in res])
    return out


def solve(mesh, problem: dict, z0s, us, config) -> dict:
    """``solve_batch_sharded`` of the fleet (this rank's block and the
    summary) and, on rank 0, the unsharded ``solve_batch`` of the whole
    fleet in the same process."""
    ocp = port_ocp(problem, mesh.device)
    x0s, us0 = torch.as_tensor(z0s), torch.as_tensor(us)
    sols, summary = solve_batch_sharded(ocp, x0s, us0, mesh, config)
    out = {"block": _host(sols),
           "summary": [np.asarray(t.cpu()) for t in summary]}
    if mesh.rank == 0:
        out["whole"] = _host(ilqr.solve_batch(ocp, x0s, us0, config))
    return out


def helpers(mesh) -> dict:
    """The mesh helpers on a tree whose tensors differ by rank: rank 0's
    copy (``replicated``), this rank's block (``shard_batch``) and the
    blocks joined again (``gather_batch``), a bool tensor among them."""
    tree = {"x": torch.arange(6.0).reshape(6, 1) + 10 * mesh.rank,
            "flags": (torch.arange(6) % 3 == mesh.rank)}
    block = shard_batch(tree, mesh)
    return {k: {f: t.numpy() for f, t in v.items()} for k, v in (
        ("replicated", replicated(tree, mesh)), ("block", block),
        ("gathered", gather_batch(block, mesh)))}


def world_two(mesh, lq_problems, solve_args) -> dict:
    """Every two-rank job of the tests in one start of the ranks."""
    return {"sweeps": sweeps(mesh, lq_problems),
            "solve": solve(mesh, *solve_args), "helpers": helpers(mesh)}


def failing(mesh, *args):
    """A rank that raises, whatever it is given."""
    raise RuntimeError(f"rank {mesh.rank} fails")
