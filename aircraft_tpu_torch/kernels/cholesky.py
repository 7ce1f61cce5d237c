"""Batched Cholesky factor-and-solve of small SPD systems: one kernel with
its plain PyTorch version, its wrapper and its launch counter.

``batched_cholesky_solve`` (kernel ``csrc/batched_cholesky.cu``) replaces
the TPU kernel ``aircraft_tpu/kernels/cholesky_kernel.py::
make_batched_cholesky_solve``: X = A⁻¹ rhs for A (B, m, m), rhs (B, m, k),
float32, any B, m ≤ 16 and any k (in column chunks where k is wide).  It
computes that kernel's rule, not a library factorisation: pivots
``sqrt(max(s, 1e-12))`` (a NaN stays NaN), forward then back
substitution, and no fail flag, so a matrix that is not positive definite
gives non-finite or meaningless X for that system only.  The Riccati
sweep (``solvers/riccati.py``) tests for that and falls back.

The plain version unrolls the same rule in PyTorch over the batch; the
wrapper takes it only for tensors on the CPU.  For CUDA tensors it
launches the kernel (built on first use by ``kernels/_build.py``) or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from aircraft_tpu_torch.kernels import _build

MAX_M = 16


def cholesky_solve_plain(a: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Plain version: the unrolled factor and the two substitutions of
    ``_cholesky_solve_rows``, vectorised over the batch and the k columns
    (each column's arithmetic is the same as solving it alone)."""
    m = a.shape[-1]
    floor = torch.full((), 1e-12, dtype=a.dtype, device=a.device)
    L = [[None] * m for _ in range(m)]
    for i in range(m):
        for j in range(i + 1):
            s = a[:, i, j]
            for p in range(j):
                s = s - L[i][p] * L[j][p]
            if i == j:
                # torch.maximum propagates NaN, as jnp.maximum does
                L[i][j] = torch.sqrt(torch.maximum(s, floor))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * m
    for i in range(m):
        s = rhs[:, i]
        for p in range(i):
            s = s - L[i][p][:, None] * y[p]
        y[i] = s / L[i][i][:, None]
    x = [None] * m
    for i in reversed(range(m)):
        s = y[i]
        for p in range(i + 1, m):
            s = s - L[p][i][:, None] * x[p]
        x[i] = s / L[i][i][:, None]
    return torch.stack(x, dim=1)


def _check(a: torch.Tensor, rhs: torch.Tensor) -> None:
    if a.ndim != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"A: shape {tuple(a.shape)}, expected (B, m, m)")
    B, m = a.shape[0], a.shape[1]
    if rhs.ndim != 3 or rhs.shape[:2] != (B, m):
        raise ValueError(f"rhs: shape {tuple(rhs.shape)}, expected ({B}, {m}, k)")
    if not 1 <= m <= MAX_M or rhs.shape[2] < 1:
        raise ValueError(f"m = {m}, k = {rhs.shape[2]}: the kernel takes "
                         f"1 <= m <= {MAX_M}, k >= 1")
    for name, t in (("A", a), ("rhs", rhs)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, expected float32")
        if t.device != a.device:
            raise ValueError(f"{name}: on {t.device}, A on {a.device}")


_launcher = None


def _launch_fn():
    """The library and its launcher, argument types set once per load."""
    global _launcher
    if _launcher is None:
        lib = _build.library("batched_cholesky")
        fn = lib.batched_cholesky_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        _launcher = lib, fn
    return _launcher


def batched_cholesky_solve(a: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """X (B, m, k) with A X = rhs for SPD A (B, m, m).  CPU tensors take
    the plain version; CUDA tensors launch ``csrc/batched_cholesky.cu``."""
    _check(a, rhs)
    if a.device.type == "cpu":
        return cholesky_solve_plain(a, rhs)
    if a.device.type != "cuda":
        raise RuntimeError(f"batched_cholesky_solve: no kernel for {a.device}")
    lib, fn = _launch_fn()
    if not a.is_contiguous():
        a = a.contiguous()
    if not rhs.is_contiguous():
        rhs = rhs.contiguous()
    B, m, k = rhs.shape
    x = torch.empty_like(rhs)
    err = fn(a.data_ptr(), rhs.data_ptr(), x.data_ptr(), B, m, k,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("batched_cholesky launch failed: "
                           f"{_build.error_string(lib, err)}")
    batched_cholesky_solve.launches += 1
    return x


batched_cholesky_solve.launches = 0

KERNELS = (batched_cholesky_solve,)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
