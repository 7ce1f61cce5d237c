"""The fused whole-horizon rollout: one kernel with its plain PyTorch
version, its wrapper and its launch counter.

``make_fused_rollout(params, horizon=N, dt=dt, substeps=s)`` returns
``rollout(x0 (B, 13), us (B, N, 7)) -> xs (B, N+1, 13)``: N knots of
``substeps`` RK4 steps of the glider with the MLP aero surrogate, the
quaternion renormalised after each.  The kernel ``csrc/fused_rollout.cu``
replaces both TPU rollout kernels of
``aircraft_tpu/kernels/rollout_kernel.py``, ``make_fused_rollout`` and
``make_fused_rollout_tiles``, which compute the same function in two TPU
layouts; ``make_fused_rollout_tiles`` here is the same function under the
TPU kernel's name.

The plain version is ``solvers/rollout.batch_rollout`` of
``solvers/integrators.step`` (``normalize="step"``).  The wrapper takes it
only for tensors on the CPU; for CUDA tensors it launches the kernel
(built on first use by ``kernels/_build.py``) or raises.  Only the MLP
model is computed, as on the TPU: any other coefficient model raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import torch

from aircraft_tpu_torch.dynamics.coefficients import MLPCoeffParams
from aircraft_tpu_torch.kernels import _build
from aircraft_tpu_torch.kernels.window import plant_consts
from aircraft_tpu_torch.solvers import integrators
from aircraft_tpu_torch.solvers.rollout import batch_rollout

XS = 13   # plant state
UD = 7    # controls


@dataclass
class RolloutOperands:
    """What the kernel reads besides x0 and us: the constants block (plant
    fields, N, dt, substeps), the folded MLP weights (838 floats) on the
    parameters' device, and the parameters for the plain version.  The
    constants are packed in the kernel's layout at the first launch and
    kept (``packed``)."""

    params: object
    consts: dict
    mlp: torch.Tensor
    horizon: int
    dt: float
    substeps: int
    packed: object = field(default=None, repr=False)

    @property
    def device(self) -> torch.device:
        return self.mlp.device


def make_rollout_operands(params, *, horizon: int, dt: float,
                          substeps: int = 1) -> RolloutOperands:
    if not isinstance(params.coeff, MLPCoeffParams):
        raise NotImplementedError(
            "fused rollout kernel: the MLP coefficient model only, got "
            f"{type(params.coeff).__name__}")
    if horizon < 1 or substeps < 1:
        raise ValueError(f"horizon {horizon}, substeps {substeps}")
    plant, mlp = plant_consts(params)
    consts = dict(plant, N=float(horizon), dt=float(dt),
                  substeps=float(substeps))
    return RolloutOperands(params=params, consts=consts, mlp=mlp,
                           horizon=horizon, dt=float(dt), substeps=substeps)


def rollout_plain(op: RolloutOperands, x0, us):
    """Plain version: the integrator's step loop over the horizon."""
    step = integrators.make_step_fn(op.params, substeps=op.substeps,
                                    normalize="step")
    return batch_rollout(step, x0, us, op.dt)


def _kernel_consts(lib, consts: dict) -> dict:
    """The layout's fields this kernel does not read, zero-filled."""
    return {name: consts.get(name, 0.0 if n == 1 else (0.0,) * n)
            for name, n in lib.layout}


_launcher = None


def _launch_fn():
    """The library and its launcher, argument types set once per load."""
    global _launcher
    if _launcher is None:
        lib = _build.library("fused_rollout")
        fn = lib.fused_rollout_launch
        fn.argtypes = ([ctypes.POINTER(ctypes.c_float), ctypes.c_int]
                       + [ctypes.c_void_p] * 4 + [ctypes.c_int]
                       + [ctypes.c_void_p])
        _launcher = lib, fn
    return _launcher


def fused_rollout(op: RolloutOperands, x0: torch.Tensor,
                  us: torch.Tensor) -> torch.Tensor:
    """x0 (B, 13), us (B, N, 7) -> xs (B, N+1, 13).  CPU tensors take the
    plain version; CUDA tensors launch ``csrc/fused_rollout.cu``."""
    B, N = x0.shape[0], op.horizon
    for name, t, shape in (("x0", x0, (B, XS)), ("us", us, (B, N, UD))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, expected float32")
        if t.device != op.device:
            raise ValueError(f"{name}: on {t.device}, expected {op.device}")
    if x0.device.type == "cpu":
        return rollout_plain(op, x0, us)
    if x0.device.type != "cuda":
        raise RuntimeError(f"fused_rollout: no kernel for {x0.device}")
    lib, fn = _launch_fn()
    if op.packed is None:
        op.packed = _build.pack_consts(lib, _kernel_consts(lib, op.consts))
    if not x0.is_contiguous():
        x0 = x0.contiguous()
    if not us.is_contiguous():
        us = us.contiguous()
    xs = torch.empty((B, N + 1, XS), dtype=torch.float32, device=x0.device)
    err = fn(op.packed, len(op.packed), x0.data_ptr(), us.data_ptr(),
             op.mlp.data_ptr(), xs.data_ptr(), B,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("fused_rollout launch failed: "
                           f"{_build.error_string(lib, err)}")
    fused_rollout.launches += 1
    return xs


fused_rollout.launches = 0

KERNELS = (fused_rollout,)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def make_fused_rollout(params, *, horizon: int, dt: float, substeps: int = 1):
    """``rollout(x0 (B, 13), us (B, N, 7)) -> xs (B, N+1, 13)`` on the
    parameters' device, any B."""
    op = make_rollout_operands(params, horizon=horizon, dt=dt,
                               substeps=substeps)

    def rollout(x0, us):
        return fused_rollout(op, x0, us)

    rollout.operands = op
    return rollout


def make_fused_rollout_tiles(params, *, horizon: int, dt: float,
                             substeps: int = 1, group: int = 8):
    """The same rollout under the TPU tile kernel's name.  ``group`` sized
    the TPU kernel's (group, 128) tiles; it is accepted and changes
    nothing here."""
    if group < 1:
        raise ValueError(f"group {group}")
    return make_fused_rollout(params, horizon=horizon, dt=dt,
                              substeps=substeps)
