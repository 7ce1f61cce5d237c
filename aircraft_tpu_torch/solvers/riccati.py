"""The sequential Riccati backward sweep of the iLQR solver, batch-leading.

Every knot's Quu solve goes one of two routes, both with the reference's
semantics (``aircraft_tpu/solvers/riccati.py``):

* the reference route, ``chol_solve_reference``: symmetrise, Cholesky of
  M + reg·I; where that factor fails, retry with a Gershgorin shift; a
  scenario that still fails takes L = I and is flagged;
* the kernel route (``cuda_chol=True``), the port of the TPU path that
  ``enable_pallas_chol`` switches in: the batched-Cholesky kernel
  (``kernels/cholesky.py``) on M_sym = ½(M+Mᵀ) + reg·I, and when any entry
  of the batch's result is non-finite, the whole batch takes the
  reference route instead and its flags (the reference's own numeric
  fallback, counted in ``chol_fallbacks``).  The test costs one host sync
  per knot.

The associative (parallel-in-time) sweep is not ported yet.
"""

from __future__ import annotations

import torch

from aircraft_tpu_torch.kernels.cholesky import batched_cholesky_solve

V_LIM = 1e14    # value-function clamp: far above AL curvature, far below f32 overflow

chol_fallbacks = 0   # kernel-route calls whose batch took the reference route


def reset_counts() -> None:
    global chol_fallbacks
    chol_fallbacks = 0


def _sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


def chol_solve_reference(M, rhs, reg):
    """PD solve of M (B, m, m) for rhs (B, m, k) with the regulariser reg
    (B,): Cholesky first, a Gershgorin-shifted retry where it fails
    (exact AL curvature can be indefinite), L = I and the flag where the
    retry fails too.  Returns (X, bad (B,) bool)."""
    m = M.shape[-1]
    eye = torch.eye(m, dtype=M.dtype, device=M.device)
    M = _sym(M)

    def factor(shift):
        L, info = torch.linalg.cholesky_ex(M + shift[:, None, None] * eye)
        # JAX's Cholesky returns NaNs where LAPACK reports failure
        return L, (info > 0) | torch.isnan(L).any(dim=(-1, -2))

    L0, bad0 = factor(reg)
    diag = torch.diagonal(M, dim1=-2, dim2=-1)
    off = torch.sum(torch.abs(M), dim=-1) - torch.abs(diag)
    gersh = torch.clamp_min(-torch.amin(diag - off, dim=-1) + 1e-6, 0.0)
    L1, bad1 = factor(reg + gersh)
    L = torch.where(bad0[:, None, None], L1, L0)
    bad = torch.where(bad0, bad1, bad0)
    L = torch.where(bad[:, None, None], eye, L)
    return torch.cholesky_solve(rhs, L), bad


def chol_solve_kernel(M, rhs, reg):
    """The kernel route: ``batched_cholesky_solve`` on ½(M+Mᵀ) + reg·I; the
    whole batch falls back to ``chol_solve_reference`` when any entry of X
    is non-finite.  Returns (X, bad)."""
    global chol_fallbacks
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    X = batched_cholesky_solve(_sym(M) + reg[:, None, None] * eye, rhs)
    if bool(torch.isfinite(X).all()):
        return X, torch.zeros(M.shape[0], dtype=torch.bool, device=M.device)
    chol_fallbacks += 1
    return chol_solve_reference(M, rhs, reg)


def _clamp(t):
    return torch.clamp(torch.nan_to_num(t, nan=0.0, posinf=V_LIM,
                                        neginf=-V_LIM), -V_LIM, V_LIM)


def backward_sequential(A, B, lx, lu, lxx, luu, lux, vx, vxx, reg, *,
                        cuda_chol: bool = False):
    """O(N) Riccati recursion over a batch of horizons.

    A (Bz, N, n, n) and B (Bz, N, n, m) are the step Jacobians; lx, lu,
    lxx, luu, lux the stage expansion; vx (Bz, n), vxx (Bz, n, n) the
    terminal one; reg (Bz,).  ``cuda_chol`` sends each knot's solve down
    the kernel route.  Returns K (Bz, N, m, n), k (Bz, N, m), Σ dv1, Σ dv2,
    max |Qu| over the horizon and the fail flag, each (Bz,)."""
    solve = chol_solve_kernel if cuda_chol else chol_solve_reference
    N = A.shape[1]
    Vx, Vxx = vx, vxx
    fail = torch.zeros(A.shape[0], dtype=torch.bool, device=A.device)
    Ks, ks, dv1, dv2, qu = [None] * N, [None] * N, [], [], []
    for t in reversed(range(N)):
        At, Bt = A[:, t], B[:, t]
        AT, BT = At.transpose(-1, -2), Bt.transpose(-1, -2)
        Qx = lx[:, t] + (AT @ Vx[..., None])[..., 0]
        Qu = lu[:, t] + (BT @ Vx[..., None])[..., 0]
        Qxx = lxx[:, t] + AT @ Vxx @ At
        Quu = luu[:, t] + BT @ Vxx @ Bt
        Qux = lux[:, t] + BT @ Vxx @ At
        sol, bad = solve(Quu, torch.cat([Qu[..., None], Qux], dim=-1), reg)
        kk, KK = -sol[..., 0], -sol[..., 1:]
        KT = KK.transpose(-1, -2)
        Quu_k = (Quu @ kk[..., None])[..., 0]
        Vx = (Qx + (KT @ Quu_k[..., None])[..., 0] + (KT @ Qu[..., None])[..., 0]
              + (Qux.transpose(-1, -2) @ kk[..., None])[..., 0])
        Vxx = Qxx + KT @ Quu @ KK + KT @ Qux + Qux.transpose(-1, -2) @ KK
        Vx, Vxx = _clamp(Vx), _clamp(_sym(Vxx))
        Ks[t], ks[t] = KK, kk
        dv1.append(torch.sum(kk * Qu, dim=-1))
        dv2.append(0.5 * torch.sum(kk * Quu_k, dim=-1))
        qu.append(torch.amax(torch.abs(Qu), dim=-1))
        fail = fail | bad
    return (torch.stack(Ks, dim=1), torch.stack(ks, dim=1),
            torch.stack(dv1).sum(0), torch.stack(dv2).sum(0),
            torch.stack(qu).amax(0), fail)

