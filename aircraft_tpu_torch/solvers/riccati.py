"""The Riccati backward sweeps of the iLQR solver, batch-leading:
sequential, and associative (parallel in time).

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
  fallback).  The reference decides that on the device (``lax.cond``);
  so does the port, with no host read: both routes are computed and a
  0-dim device flag selects one (``torch.where``).  The fallbacks are
  added into a device counter and folded into ``chol_fallbacks`` by
  ``read_fallbacks``, one host read, which ``ilqr.solve_impl`` makes once
  per solve.

On the card the kernel route's sequential sweep is a CUDA graph, captured
at the first sweep of each input shape and replayed after it: the same
arithmetic without the host's cost of ~35 launches per knot.  The graph
adds the Cholesky kernel's launches it holds to the kernel's counter at
every replay, and the fallbacks into the same device counter.

The associative sweep (``backward_associative``) reduces the horizon in
log depth: each knot is a conditional-value element, the elements combine
associatively (``cv_combine``), and a suffix scan of ⌈log2(N+1)⌉ batched
combines gives every V_{k+1}; ``recover_gains`` then solves all B·N Quu
systems in one call, on the kernel route one launch per sweep.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from aircraft_tpu_torch.kernels import cholesky
from aircraft_tpu_torch.kernels.cholesky import MAX_M, batched_cholesky_solve

V_LIM = 1e14    # value-function clamp: far above AL curvature, far below f32 overflow

chol_fallbacks = 0   # kernel-route runs of systems that took the reference route
_counters = {}       # device -> 0-dim int64: fallbacks counted there, unread
_unread = False      # whether a counter may hold fallbacks not yet read


def reset_counts() -> None:
    global chol_fallbacks, _unread
    chol_fallbacks = 0
    for c in _counters.values():
        c.zero_()
    _unread = False


def read_fallbacks() -> int:
    """Fold the device-side fallback counts into ``chol_fallbacks`` (one
    host read, none when nothing was counted since the last); returns the
    total."""
    global chol_fallbacks, _unread
    if _unread:
        chol_fallbacks += int(sum(c.cpu() for c in _counters.values()))
        for c in _counters.values():
            c.zero_()
        _unread = False
    return chol_fallbacks


def _count_fallbacks(fell_back: torch.Tensor) -> None:
    """Add the runs that fell back into the device's counter (created
    before any graph is captured, so a graph adds into the same one)."""
    global _unread
    c = _counters.get(fell_back.device)
    if c is None:
        c = _counters[fell_back.device] = torch.zeros(
            (), dtype=torch.int64, device=fell_back.device)
    c.add_(fell_back.sum())
    _unread = True


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
    return _cho_solve(L, rhs), bad


def _cho_solve(L, rhs):
    """X with L Lᵀ X = rhs, by two triangular solves as the reference's
    ``cho_solve`` does.  On the card they are cuBLAS calls, which a CUDA
    graph captures; the batched ``torch.cholesky_solve`` goes to MAGMA
    there, which refuses capture."""
    y = torch.linalg.solve_triangular(L, rhs, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)


def chol_solve_kernel(M, rhs, reg, groups: int = 1):
    """The kernel route: ``batched_cholesky_solve`` on ½(M+Mᵀ) + reg·I.  The
    systems form ``groups`` equal runs of consecutive systems, and a run
    with any non-finite entry of X takes ``chol_solve_reference``'s result
    and flags instead: the whole batch by default, as the reference's
    ``lax.cond`` decides at a knot of the sequential sweep.  Both routes
    are computed and selected on the device, and the runs that fell back
    are counted there (``read_fallbacks``).  Systems larger than the
    kernel takes (m > ``MAX_M``) go to the reference route, as the
    reference sends them to its library solve.  Returns (X, bad)."""
    if M.shape[-1] > MAX_M:
        return chol_solve_reference(M, rhs, reg)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    X = batched_cholesky_solve(_sym(M) + reg[:, None, None] * eye, rhs)
    runs = X.reshape((groups, -1) + X.shape[1:])
    fell_back = ~torch.isfinite(runs).flatten(1).all(dim=1)     # (groups,)
    _count_fallbacks(fell_back)
    X_ref, bad_ref = chol_solve_reference(M, rhs, reg)
    X = torch.where(fell_back[:, None, None, None],
                    X_ref.reshape(runs.shape), runs).reshape(X.shape)
    bad = fell_back[:, None] & bad_ref.reshape(groups, -1)
    return X, bad.reshape(-1)


def _clamp(t):
    return torch.clamp(torch.nan_to_num(t, nan=0.0, posinf=V_LIM,
                                        neginf=-V_LIM), -V_LIM, V_LIM)


class _Captured(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: tuple      # the graph's static input buffers
    outputs: tuple     # its output buffers
    launches: int      # Cholesky-kernel launches per replay


_graphs = {}   # the inputs' shapes and dtypes, device -> _Captured


def backward_sequential(A, B, lx, lu, lxx, luu, lux, vx, vxx, reg, *,
                        cuda_chol: bool = False):
    """O(N) Riccati recursion over a batch of horizons.

    A (Bz, N, n, n) and B (Bz, N, n, m) are the step Jacobians; lx, lu,
    lxx, luu, lux the stage expansion; vx (Bz, n), vxx (Bz, n, n) the
    terminal one; reg (Bz,).  ``cuda_chol`` sends each knot's solve down
    the kernel route; on the card that sweep runs on contiguous copies of
    its inputs (a library matmul may round otherwise on other strides), as
    a CUDA graph of itself captured at the first sweep of its input shapes,
    which runs eagerly: the inputs are copied into the graph's buffers and
    the outputs cloned out.  Returns K (Bz, N, m, n), k (Bz, N, m), Σ dv1,
    Σ dv2, max |Qu| over the horizon and the fail flag, each (Bz,)."""
    args = (A, B, lx, lu, lxx, luu, lux, vx, vxx, reg)
    if not (cuda_chol and A.is_cuda):
        return _sequential(*args, cuda_chol=cuda_chol)
    global _unread
    key = tuple((a.shape, a.dtype) for a in args) + (A.device,)
    cap = _graphs.get(key)
    if cap is None:
        inputs = tuple(torch.empty(a.shape, dtype=a.dtype,
                                   device=a.device).copy_(a) for a in args)
        out = _sequential(*inputs, cuda_chol=True)  # also warms every library up
        _graphs[key] = _capture(inputs)
        return out
    for buf, a in zip(cap.inputs, args):
        buf.copy_(a)
    cap.graph.replay()
    cholesky.batched_cholesky_solve.launches += cap.launches
    _unread = True
    return tuple(t.clone() for t in cap.outputs)


def _capture(inputs) -> _Captured:
    """A CUDA graph of the kernel-route sweep on the static buffers
    ``inputs``.  The capture launches nothing, so the Cholesky wrapper's
    count taken during it is the count each replay adds, and is taken back
    out."""
    before = cholesky.batched_cholesky_solve.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        outputs = _sequential(*inputs, cuda_chol=True)
    launches = cholesky.batched_cholesky_solve.launches - before
    cholesky.batched_cholesky_solve.launches = before
    return _Captured(graph, inputs, outputs, launches)


def _sequential(A, B, lx, lu, lxx, luu, lux, vx, vxx, reg, *,
                cuda_chol: bool):
    """``backward_sequential``'s recursion, eagerly."""
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


# ---------------------------------------------------------------------------
# the associative (parallel-in-time) sweep
# ---------------------------------------------------------------------------


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def cv_elements(A, B, lx, lu, lxx, luu, lux, reg):
    """Per-knot conditional-value elements (A_e, b_e, C_e, η_e, J_e), each
    (Bz, N, ...), for the associative reduction, and the fail flag (Bz,).
    The cross terms go by ū = u + L x, L = luu⁻¹ lux.  luu's own Cholesky
    (library, with reg): a scenario where any knot's factor fails takes
    L = I at every knot and is flagged, as in the reference."""
    m = B.shape[-1]
    eye_m = torch.eye(m, dtype=A.dtype, device=A.device)
    chol, info = torch.linalg.cholesky_ex(_sym(luu)
                                          + reg[:, None, None, None] * eye_m)
    fail = ((info > 0) | torch.isnan(chol).any(dim=(-1, -2))).any(dim=1)
    chol = torch.where(fail[:, None, None, None], eye_m, chol)
    Lmat = torch.cholesky_solve(lux, chol)
    lu_bar = torch.cholesky_solve(lu[..., None], chol)[..., 0]
    luxT = lux.transpose(-1, -2)
    A_bar = A - B @ Lmat
    lxx_bar = lxx - luxT @ Lmat
    lx_bar = lx - _mv(luxT, lu_bar)
    BRinv = B @ torch.cholesky_solve(eye_m.expand_as(chol), chol)
    C_e = BRinv @ B.transpose(-1, -2)
    b_e = -_mv(BRinv, lu)
    return (A_bar, b_e, C_e, -lx_bar, lxx_bar), fail


def cv_terminal(vx, vxx):
    """Terminal element, appended past the last stage: (0, 0, 0, -vx,
    vxx), each (Bz, ...)."""
    z = torch.zeros_like(vxx)
    return z, torch.zeros_like(vx), z, -vx, vxx


def cv_identity(n, dtype, device, batch=()):
    """Identity of ``cv_combine``: A = I, everything else zero, with the
    leading axes ``batch``."""
    eye = torch.eye(n, dtype=dtype, device=device).expand(batch + (n, n))
    z = torch.zeros(batch + (n,), dtype=dtype, device=device)
    return eye, z, torch.zeros_like(eye), z, torch.zeros_like(eye)


def cv_combine(e_late, e_early):
    """The associative combination, over any leading axes, with
    G = (I + C1 J2)⁻¹:
        A = A2 G A1
        b = A2 G (b1 + C1 η2) + b2
        C = A2 G C1 A2ᵀ + C2
        η = A1ᵀ Gᵀ (η2 − J2 b1) + η1
        J = A1ᵀ Gᵀ J2 A1 + J1
    ``e_late`` holds the later knots, ``e_early`` the earlier ones."""
    A1, b1, C1, eta1, J1 = e_early
    A2, b2, C2, eta2, J2 = e_late
    eye = torch.eye(A1.shape[-1], dtype=A1.dtype, device=A1.device)
    G, _ = torch.linalg.solve_ex(eye + C1 @ J2, eye.expand_as(C1))
    A2G = A2 @ G
    A1T_GT = A1.transpose(-1, -2) @ G.transpose(-1, -2)
    J = A1T_GT @ J2 @ A1 + J1
    return (A2G @ A1, _mv(A2G, b1 + _mv(C1, eta2)) + b2,
            A2G @ C1 @ A2.transpose(-1, -2) + C2,
            _mv(A1T_GT, eta2 - _mv(J2, b1)) + eta1, _sym(J))


def suffix_scan(elems):
    """Every suffix of the elements along axis 1, S_k = e_k ⊕ … ⊕ e_last
    (⊕ = ``cv_combine`` with the later part first), in ⌈log2 L⌉ levels of
    one batched combine each: at the level of offset o, S_k takes
    cv_combine(S_{k+o}, S_k) for every k with a partner."""
    L = elems[0].shape[1]
    o = 1
    while o < L:
        late = tuple(e[:, o:] for e in elems)
        early = tuple(e[:, :L - o] for e in elems)
        elems = tuple(torch.cat([c, e[:, L - o:]], dim=1)
                      for c, e in zip(cv_combine(late, early), elems))
        o *= 2
    return elems


def recover_gains(A, B, lu, luu, lux, Vx_next, Vxx_next, reg, *,
                  cuda_chol: bool = False):
    """Every knot's gains from the scanned V_{k+1}, its Quu solves (Bz·N
    systems) in one call: K (Bz,N,m,n), k (Bz,N,m), dv1, dv2, max |Qu|
    and the flags, each (Bz,N).  On the kernel route a scenario whose
    systems give any non-finite entry takes the reference route for all
    its knots: the reference's rule runs under the outer ``vmap`` over
    scenarios, so its ``lax.cond`` decides per scenario."""
    Bz, N = A.shape[:2]
    BT = B.transpose(-1, -2)
    Qu = lu + _mv(BT, Vx_next)
    Quu = luu + BT @ Vxx_next @ B
    Qux = lux + BT @ Vxx_next @ A
    M = Quu.flatten(0, 1)
    rhs = torch.cat([Qu[..., None], Qux], dim=-1).flatten(0, 1)
    reg_k = reg.repeat_interleave(N)
    if cuda_chol:
        sol, bad = chol_solve_kernel(M, rhs, reg_k, groups=Bz)
    else:
        sol, bad = chol_solve_reference(M, rhs, reg_k)
    sol = sol.reshape((Bz, N) + sol.shape[1:])
    K, k = -sol[..., 1:], -sol[..., 0]
    dv1 = torch.sum(k * Qu, dim=-1)
    dv2 = 0.5 * torch.sum(k * _mv(Quu, k), dim=-1)
    return (K, k, dv1, dv2, torch.amax(torch.abs(Qu), dim=-1),
            bad.reshape(Bz, N))


def backward_associative(A, B, lx, lu, lxx, luu, lux, vx, vxx, reg, *,
                         cuda_chol: bool = False):
    """O(log N)-depth Riccati sweep: the knots' conditional-value elements
    and the terminal one reduced by ``suffix_scan``, then every knot's
    gains at once (``recover_gains``, its solves on the kernel route with
    ``cuda_chol``).  Arguments and results as ``backward_sequential``."""
    stage, fail = cv_elements(A, B, lx, lu, lxx, luu, lux, reg)
    elems = tuple(torch.cat([s, t[:, None]], dim=1)
                  for s, t in zip(stage, cv_terminal(vx, vxx)))
    scanned = suffix_scan(elems)
    # S_k combines knots k..N: V_{k+1} for k = 0..N-1
    Vx_next, Vxx_next = -scanned[3][:, 1:], scanned[4][:, 1:]
    K, k, dv1, dv2, qu, bad = recover_gains(A, B, lu, luu, lux, Vx_next,
                                            Vxx_next, reg,
                                            cuda_chol=cuda_chol)
    return (K, k, dv1.sum(1), dv2.sum(1), qu.amax(1),
            fail | bad.any(dim=1))
