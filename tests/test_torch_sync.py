"""No host sync on the served window solve and the kernel-route Riccati
sweep, audited on the CPU.

On the card, a Python number copied to the device, or a device value read
back to the host, waits for the stream: the pipelined serve loop then has
nothing to overlap.  A ``TorchFunctionMode`` sees every such call on the
CPU as well, so these tests audit, after one warm-up call:

* a window solve of ``MHTT._serve_step`` up to its blob's pull, on the
  window kernels' path (``fused=True``, their plain versions here) and on
  the iLQR path (``fused=False``), and ``_serve_step_multi`` with its six
  candidates;
* ``riccati.backward_sequential`` and ``backward_associative`` on the
  kernel route (``cuda_chol=True``) with their fallback rules;
* the implicit-Euler step and its linearisation.

Flagged: ``torch.tensor`` / ``torch.as_tensor`` / ``Tensor.new_tensor``
given host data with a device; ``Tensor.__bool__``, ``__float__``,
``__int__``, ``__index__``, ``item``; ``cpu``, ``numpy``, ``tolist``,
``__array__``; boolean-mask indexing, ``nonzero`` and ``masked_select``
(their result's size is read back).  The same solves run under
``torch.cuda.set_sync_debug_mode("error")`` on the card in
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from aircraft_tpu_torch.config import SolverConfig
from aircraft_tpu_torch.control.mhtt import MHTT
from aircraft_tpu_torch.solvers import riccati

N = 10
WINDOW = dict(num_nodes=N, dt=0.02, overlap=5, substeps=2)
BUDGET = dict(max_al_iters=1, max_inner_iters=2, hessian="gauss_newton")

_HOST_READS = {torch.Tensor.__bool__, torch.Tensor.__float__,
               torch.Tensor.__int__, torch.Tensor.__index__,
               torch.Tensor.item, torch.Tensor.cpu, torch.Tensor.numpy,
               torch.Tensor.tolist, torch.Tensor.__array__}
_SIZE_READS = {torch.nonzero, torch.Tensor.nonzero, torch.masked_select,
               torch.Tensor.masked_select}
_COPIES = {torch.tensor, torch.as_tensor}


def _is_mask(index):
    items = index if isinstance(index, tuple) else (index,)
    return any(isinstance(i, torch.Tensor) and i.dtype in (torch.bool,
                                                           torch.uint8)
               for i in items)


class SyncAudit(TorchFunctionMode):
    """Records every call that would synchronise the stream on the card."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", repr(func))
        if func in _HOST_READS or func in _SIZE_READS:
            self.found.append(name)
        elif func in _COPIES and "device" in kwargs and not isinstance(
                args[0], torch.Tensor):
            self.found.append(f"{name}(host data, device=...)")
        elif func is torch.Tensor.new_tensor and not isinstance(
                args[1], torch.Tensor):
            self.found.append("new_tensor(host data)")
        elif (func in (torch.Tensor.__getitem__, torch.Tensor.__setitem__)
              and _is_mask(args[1])):
            self.found.append(f"{name} with a boolean mask")
        return func(*args, **kwargs)


def audit(fn, *args):
    with SyncAudit() as a:
        out = fn(*args)
    return out, a.found


@pytest.fixture(scope="module")
def course():
    """The reference controller tests' short course, built by the port
    alone (no reference numbers are compared here)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_port_problem import SHORT_COURSE

    from aircraft_tpu_torch.config import TrajectoryConfig
    from aircraft_tpu_torch.control.initialisation import DubinsInitialiser
    from aircraft_tpu_torch.dynamics.aircraft import AircraftParams

    cfg = TrajectoryConfig.from_dict(SHORT_COURSE)
    params = AircraftParams.from_config(cfg.aircraft, device="cpu")
    z0 = torch.as_tensor(np.concatenate(
        [cfg.waypoints.initial_state, [0.0]]).astype(np.float32))
    return cfg, params, DubinsInitialiser(cfg), z0


def test_the_audit_sees_every_kind_of_sync():
    x = torch.ones(3)
    for fn in (lambda: bool(x.all()), lambda: float(x[0]),
               lambda: x[0].item(), lambda: x.tolist(), lambda: x.cpu(),
               lambda: torch.tensor(1.0, device="cpu"),
               lambda: x.new_tensor([1.0]), lambda: x[x > 0],
               lambda: torch.nonzero(x)):
        assert len(audit(fn)[1]) == 1
    assert audit(lambda: torch.full((), 1.0, device="cpu") + x)[1] == []


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "ilqr"])
def test_warm_serve_step_makes_no_host_sync(course, fused):
    cfg, params, track, z0 = course
    m = MHTT(params, cfg, track, **WINDOW, solver_config=SolverConfig(
        **BUDGET), fused=fused, device="cpu")
    us = torch.zeros(N, 7)
    z, us, al, _ = m._serve_step(z0, us, m._al0)          # warm-up
    (z, us, al, pull), found = audit(m._serve_step, z, us, al)
    assert found == []
    assert bool(torch.isfinite(pull[0]).all())
    _, found = audit(m._serve_step_multi, z, us, torch.zeros(N, 7), al, 6)
    assert found == []


@pytest.mark.parametrize("sweep", ["sequential", "associative"])
def test_kernel_route_sweep_makes_no_host_sync(sweep):
    rng = np.random.default_rng(0)
    Bsz, N_, n, m = 4, 6, 14, 7
    W = rng.normal(0, 1, (Bsz, N_, n + m, n + m))
    H = np.einsum("bkij,bklj->bkil", W, W) / (n + m) + np.eye(n + m)
    args = [torch.as_tensor(a, dtype=torch.float32) for a in (
        np.eye(n) + rng.normal(0, 0.1, (Bsz, N_, n, n)),
        rng.normal(0, 0.1, (Bsz, N_, n, m)), rng.normal(0, 1, (Bsz, N_, n)),
        rng.normal(0, 1, (Bsz, N_, m)), H[..., :n, :n], H[..., n:, n:],
        H[..., n:, :n], rng.normal(0, 1, (Bsz, n)),
        np.tile(np.eye(n), (Bsz, 1, 1)))]
    reg = torch.full((Bsz,), 1e-6)
    fn = getattr(riccati, f"backward_{sweep}")
    fn(*args, reg, cuda_chol=True)    # warm-up
    riccati.reset_counts()
    out, found = audit(lambda: fn(*args, reg, cuda_chol=True))
    assert found == []
    assert bool(torch.isfinite(out[0]).all())
    assert riccati.read_fallbacks() == 0


def test_implicit_step_and_its_linearisation_make_no_host_sync(course):
    """The implicit-Euler step (its Newton solve runs ``solve_ex`` with its
    info left unread) and its forward-mode linearisation through the
    Newton iterations."""
    from aircraft_tpu_torch.ops.autodiff import batched_jacfwd
    from aircraft_tpu_torch.solvers import integrators

    _, params, _, z0 = course
    step = integrators.make_step_fn(params, substeps=2, normalize="expmap",
                                    integration="implicit")
    x = z0[:13].expand(4, 13).contiguous()
    u = torch.zeros(4, 7)
    step(x, u, 0.05)                  # warm-up
    out, found = audit(step, x, u, 0.05)
    assert found == []
    J, found = audit(batched_jacfwd, lambda a, b: step(a, b, 0.05), x, u)
    assert found == []
    assert bool(torch.isfinite(out).all()) and J.shape == (4, 13, 20)
