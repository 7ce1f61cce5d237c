"""The work of the port's kernels, counted from their source, and the
card's ceilings: one count that ``chip_smoke.py`` (each kernel's bound)
and the bench's ``roofline`` mode (the whole fused window solve) share.

Operations are fp32 operations of the CUDA source for the call's shapes,
an FMA counted as two; bytes count each input read once and each output
written once.  ``bound_ms`` is the larger of operations over the fp32
peak outside the tensor cores and bytes over the memory rate.  The counts
read the work itself, so they hold whatever implements it.
"""

from __future__ import annotations

from typing import Optional

FP32_PEAK = 67e12        # H100 SXM fp32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

# (fp32 FLOP/s outside the tensor cores, memory bytes/s) by the card's name
# as torch.cuda.get_device_name reports it (NVIDIA's data sheet, SXM part,
# at its full 700 W power limit)
PEAKS = {"h100 80gb hbm3": (FP32_PEAK, HBM_BYTES_PER_S)}


def peaks(kind: str) -> Optional[tuple]:
    """(peak FLOP/s, peak bytes/s) of the card named ``kind``, or None for
    a device the table does not know."""
    kind = kind.lower()
    return next((v for k, v in PEAKS.items() if k in kind), None)


def rk4_flops(is_mlp: bool) -> int:
    """fp32 operations of one rk4_norm of window_physics.cuh, an FMA
    counted as two."""
    mlp = 2 * (5 * 16 + 16 * 32 + 32 * 6) + 32 if is_mlp else 24
    deriv = mlp + 160                       # flow, forces, Newton-Euler
    return 4 * deriv + 13 * 9 + 12          # stages, combination, renorm


def knot_flops(op) -> int:
    """fp32 operations of one primal knot (window_physics.cuh::knot) of
    the window operands ``op``."""
    extras = 60 + 40 + 4 * op.nr + 6 * op.ng + 10
    return op.spec.substeps * rk4_flops(op.is_mlp) + extras


def backward_work(op, B):
    """(operations, bytes) of one window_backward call on B scenarios."""
    N, nr, ng = op.spec.N, op.nr, op.ng
    f = knot_flops(op)
    tangents = 21 * 2 * f                   # a dual op: value + tangent
    assembly = 2 * 21 * 21 * (nr + ng) + 2 * 21 * (nr + ng)
    riccati = (2 * 21 * 14 * 14 + 2 * 21 * 21 * 14 + 2 * 21 * 14
               + 7 ** 3 // 3 + 2 * 15 * 49 + 2 * 14 * 7 * 7
               + 2 * 14 * 14 * 7 * 2 + 2 * 14 * 7 * 3)
    flops = B * N * (f + tangents + assembly + riccati)
    floats_in = (B * (N + 1) * 14 + B * N * 7 + B * N * ng + 2 * B
                 + B * ng + B * 14 + B * 196 + op.mlp.numel()
                 + op.table.numel() + N)
    floats_out = B * N * 98 + B * N * 7 + 3 * B
    return flops, 4 * (floats_in + floats_out) + B


def forward_work(op, B):
    """(operations, bytes) of one window_forward call on B scenarios."""
    N, A = op.spec.N, len(op.alphas)
    per_knot = knot_flops(op) + 2 * 7 * 14 + 3 * 7 + 2 * 14 + 8 * op.ng + 10
    flops = B * A * (N * per_knot + 12)
    floats_in = (B * (N + 1) * 14 + B * N * 7 + B * N * 98 + B * N * 7
                 + B * N * op.ng + B + B * op.ng + op.mlp.numel()
                 + op.table.numel() + N)
    floats_out = B * (N + 1) * 14 + B * N * 7 + B * (A + 3)
    return flops, 4 * (floats_in + floats_out)


def cholesky_work(B, m, k):
    """batched_cholesky.cu: the factor (a multiply-subtract as two, a
    divide, a max and a square root as one each) and two substitutions per
    column; A and rhs read once, X written once."""
    factor = sum(2 * j + (2 if i == j else 1)
                 for i in range(m) for j in range(i + 1))
    flops = B * (factor + k * 2 * m * m)
    return flops, 4 * B * (m * m + 2 * m * k)


def rollout_work(B, N, substeps, mlp_floats):
    """fused_rollout.cu: N knots of `substeps` RK4 steps per scenario."""
    flops = B * N * substeps * rk4_flops(True)
    return flops, 4 * (B * 13 + B * N * 7 + B * (N + 1) * 13 + mlp_floats)


def initial_rollout_work(op, B):
    """The window solve's open-loop rollout of its warm start: N knots of
    the plant's RK4 steps per scenario; the start states and controls
    read, the trajectory (B, N+1, 14) written."""
    N = op.spec.N
    flops = B * N * op.spec.substeps * rk4_flops(op.is_mlp)
    return flops, 4 * (B * 14 + B * N * 7 + B * (N + 1) * 14
                       + op.mlp.numel())


# what solve_work counts and leaves out of one fused window solve
COUNTED = ("initial rollout", "window_backward per inner iteration",
           "window_forward per inner iteration")
UNCOUNTED = ("terminal expansion per inner iteration",
             "accept / regularisation / convergence masks",
             "AL multiplier update per AL round",
             "true cost and violation at the end")


def solve_work(op, B, inner_iterations):
    """(operations, bytes) of one fused window solve on B scenarios: the
    initial rollout and, per inner iteration, one call of each window
    kernel (``COUNTED``); ``UNCOUNTED`` is left out, so the count is a
    lower bound."""
    parts = [initial_rollout_work(op, B)] + inner_iterations * [
        backward_work(op, B), forward_work(op, B)]
    return sum(p[0] for p in parts), sum(p[1] for p in parts)


def bound_ms(work, peak_flops=FP32_PEAK, peak_bytes=HBM_BYTES_PER_S):
    """(the least time in ms the card could take for ``work``, and which
    of "operations" or "bytes" binds)."""
    flops, nbytes = work
    t_ops, t_bytes = flops / peak_flops, nbytes / peak_bytes
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")
