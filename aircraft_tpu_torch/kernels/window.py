"""The fused inner iteration of the MHTT window solve: two kernels, each
with its plain PyTorch version, its wrapper and its launch counter.

* ``window_backward`` (kernels in ``csrc/window_backward.cu``) replaces the
  TPU kernel ``aircraft_tpu/kernels/window_kernel.py::make_backward_kernel``.
  Per scenario, for k = N-1..0: linearise the augmented knot step (RK4 x
  substeps of the 13-state plant + the Euler progress channel) on its 21
  basis directions (14 state + 7 control), assemble the residual
  Gauss-Newton AL curvature g = Jrᵀr + Jgᵀy + ∇rest, H = JrᵀJr + JgᵀWJg,
  and run one Riccati step with a 7x7 Cholesky whose pivot < -1e-6 flags
  the scenario.  Emits K (B,N,7,14), k (B,N,7), dv1, dv2, max|Qu| and fail.
  On the card it is two launches: every knot linearised at once into a
  (B, N, KNOT_FLOATS) buffer of [grad | H | F], then one Riccati sweep
  per scenario.
* ``window_forward`` (kernel ``csrc/window_forward.cu``) replaces
  ``::make_forward_kernel``: one closed-loop rollout per line-search step
  α, w = w_ref + α k + K (x - x_ref), summing the AL stage cost and the
  terminal cost; a knot whose next state is non-finite or exceeds 1e6
  freezes and costs FREEZE_PENALTY.  The best α per scenario (first
  strictly lower cost in candidate order) selects the stored trajectory.
  On the card each rollout is one warp, and a scenario's reference sits in
  its block's shared memory, which bounds the horizon
  (``forward_smem_bytes``).

The plain versions compute the same function batched over scenarios, the
derivatives by ``torch.func`` forward mode; a wrapper takes its plain
version only for tensors on the CPU.  For CUDA tensors it launches the
kernel (built on first use by ``kernels/_build.py``) or raises.

The knot function is built from the resolved formulation constants that
``control/mhtt.build_mhtt_ocp`` writes into ``spec_out``, so the kernels,
their plain versions and the OCP callables read one spec.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from aircraft_tpu_torch.config import RHO
from aircraft_tpu_torch.device import resolve_device
from aircraft_tpu_torch.control.mhtt import (
    W_BACKWARD,
    W_CONTROL,
    W_LOW_VELOCITY,
    W_PROGRESS,
    W_PROGRESS_RATE,
    W_TERMINAL_ALIGN,
    W_TRACKING,
)
from aircraft_tpu_torch.dynamics import base as dyn_base
from aircraft_tpu_torch.dynamics.aircraft import C_D_FLAPS, C_Z_FLAPS
from aircraft_tpu_torch.dynamics.coefficients import (
    DEG2RAD,
    DefaultCoeffParams,
    MLPCoeffParams,
    default_coeff_vector,
    fold_mlp,
)
from aircraft_tpu_torch.ops.autodiff import batched_jacfwd
from aircraft_tpu_torch.ops.elementwise import clip, saturating_tanh
from aircraft_tpu_torch.solvers.ilqr import FREEZE_PENALTY, line_search_alphas

XD = 14          # augmented state [x(13), s]
UD = 7           # controls
NDIR = XD + UD   # linearisation basis
A_MAX = 16       # line-search candidates the kernels take
KNOT_FLOATS = NDIR + NDIR * NDIR + NDIR * XD   # [grad | H | F] of one knot
SMEM_MAX = 232448   # bytes of shared memory one block may use on sm_90


class WindowSpec(NamedTuple):
    """Formulation constants of one window, resolved from the spec dict
    that ``build_mhtt_ocp`` fills."""

    N: int
    dt: float
    substeps: int
    L: float
    progress_correction: float
    dim_mask: tuple           # (3,) 0/1
    v_ref: float
    w_speed: float
    w_rate: float
    alpha_guard: float        # radians, 0 = off
    beta_guard: float         # radians, 0 = off
    stall_margin: float
    stall_factor: float
    speed_lo2: float
    speed_hi2: float
    lo_scale: float
    hi_scale: float
    alpha_lim: float
    beta_lim: float
    squash_mid: Optional[tuple]   # None = physical controls
    squash_half: Optional[tuple]
    include_box: bool             # AL control-box rows before the envelope
    box_lb: Optional[tuple]
    box_ub: Optional[tuple]
    rest_factors: tuple           # (N,) progress-reward damping per knot
    M: int                        # track points


def make_window_spec(spec: dict, N: int) -> tuple[WindowSpec, np.ndarray]:
    """Resolve ``spec`` into window constants plus the pre-shifted
    Catmull-Rom table (M, 12) = [P(i-1) | P(i) | P(i+1) | P(i+2)]."""
    if spec.get("wind_channels"):
        raise NotImplementedError("window kernels: wind channels")
    env = spec["envelope"]
    if env is None:
        raise NotImplementedError("window kernels: unresolved envelope")
    include_box = bool(env["include_control_box"])
    pts = np.asarray(torch.as_tensor(spec["track_points"]).cpu(), np.float32)
    M = pts.shape[0]
    idx = np.arange(M)
    table = np.concatenate(
        [pts[np.clip(idx - 1, 0, M - 1)], pts[idx],
         pts[np.clip(idx + 1, 0, M - 1)], pts[np.clip(idx + 2, 0, M - 1)]],
        axis=1).astype(np.float32)
    tail = spec.get("tail_damp")
    rest_factors = tuple(
        (tail[1] if (tail is not None and k >= tail[0]) else 1.0)
        for k in range(N))
    if spec["squash_box"]:
        lb, ub = (np.asarray(b, np.float32) for b in spec["squash_bounds"])
        mid = tuple(float(v) for v in 0.5 * (lb + ub))
        half = tuple(float(v) for v in 0.5 * (ub - lb))
    else:
        mid = half = None
    ws = WindowSpec(
        N=N, dt=float(spec["dt"]), substeps=int(spec["substeps"]),
        L=float(spec["track_length"]),
        progress_correction=float(spec["progress_correction"]),
        dim_mask=tuple(1.0 if d in spec["track_dims"] else 0.0
                       for d in range(3)),
        v_ref=float(spec["v_ref"]), w_speed=float(spec["w_speed"]),
        w_rate=float(spec["w_rate"]),
        alpha_guard=float(np.deg2rad(spec["alpha_guard_deg"])),
        beta_guard=float(np.deg2rad(spec["beta_guard_deg"])),
        stall_margin=float(spec["stall_guard"][0]),
        stall_factor=float(spec["stall_guard"][1]),
        speed_lo2=float(env["speed_bounds"][0] ** 2),
        speed_hi2=float(env["speed_bounds"][1] ** 2),
        lo_scale=float(env["lo_scale"]), hi_scale=float(env["hi_scale"]),
        alpha_lim=float(env["alpha_lim"]), beta_lim=float(env["beta_lim"]),
        squash_mid=mid, squash_half=half, include_box=include_box,
        box_lb=(tuple(float(v) for v in env["lb"]) if include_box else None),
        box_ub=(tuple(float(v) for v in env["ub"]) if include_box else None),
        rest_factors=rest_factors, M=M)
    return ws, table


def n_ineq_rows(ws: WindowSpec) -> int:
    """Inequality rows in envelope_ineq's order: [u - ub (7), lb - u (7)]
    when the AL box is on, then the 7 envelope rows."""
    return (14 if ws.include_box else 0) + 7


def n_residual_rows(ws: WindowSpec) -> int:
    nr = 3 + 1 + 1 + 7 + 1   # tracking, backward, low-v, control, overspeed
    if ws.w_speed > 0.0:
        nr += 2              # speed hold + stall guard
    if ws.w_rate > 0.0:
        nr += 3              # body rates
    if ws.alpha_guard > 0.0:
        nr += 1
    if ws.beta_guard > 0.0:
        nr += 1
    return nr


# ---------------------------------------------------------------------------
# operands shared by the kernels and their plain versions
# ---------------------------------------------------------------------------


def _residual_coefs(ws: WindowSpec) -> list[float]:
    """√(2w) factors of the residual rows, in float64 then rounded once."""
    return [float(np.float32(v)) for v in (
        np.sqrt(2.0 * W_TRACKING), np.sqrt(2.0 * W_BACKWARD),
        np.sqrt(2.0 * W_LOW_VELOCITY), np.sqrt(2.0 * W_CONTROL),
        np.sqrt(2.0), np.sqrt(2.0 * ws.w_speed),
        np.sqrt(2.0 * ws.stall_factor * ws.w_speed),
        np.sqrt(2.0 * ws.w_rate), np.sqrt(20.0))]


@dataclass
class WindowOperands:
    """Everything the two kernels read besides the per-call tensors: the
    host constants (plant, spec, line search), the folded MLP weights
    (838 floats, or one zero for the default model), the track table
    (M, 12) and the rest factors (N,), on the solve's device.  ``consts``
    is read-only once built: ``packed`` keeps it packed per kernel
    library, so a launch reuses the packed block."""

    spec: WindowSpec
    consts: dict            # name -> float or tuple of floats
    mlp: torch.Tensor
    table: torch.Tensor
    restfac: torch.Tensor
    alphas: tuple
    alpha_vec: torch.Tensor     # the alphas on the device, (A,)
    is_mlp: bool
    nr: int
    ng: int
    packed: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.table.device


def kernel_coeff_supported(params) -> bool:
    """Whether the kernels compute this plant's coefficient model: the MLP
    surrogate or the default closed-form aero."""
    return isinstance(params.coeff, (MLPCoeffParams, DefaultCoeffParams))


def plant_consts(params):
    """The plant fields of the kernels' constants block (geometry, the
    parallel-axis inertia and its inverse, the coefficient model) and the
    folded MLP weights (838 floats, or one zero for the default model) on
    the parameters' device.  Raises NotImplementedError on coefficient
    models other than the MLP and the default, and on plant switches the
    kernels do not compute."""
    cp = params.coeff
    if not kernel_coeff_supported(params):
        raise NotImplementedError(
            f"CUDA kernels: coefficient model {type(cp).__name__}")
    if (params.stall_scaling or params.thrust_enabled or params.com_in_control
            or not params.com_in_moments):
        raise NotImplementedError("CUDA kernels: plant switches")
    f = lambda t: t.detach().cpu().numpy().astype(np.float32)
    com = f(params.com)
    J = dyn_base.inertia_about_com(
        params.static_inertia.detach().cpu(), params.mass.detach().cpu(),
        params.com.detach().cpu()).numpy().astype(np.float32)
    Jinv = np.linalg.inv(J).astype(np.float32)
    is_mlp = isinstance(cp, MLPCoeffParams)
    consts = dict(
        mass=float(f(params.mass)), area=float(f(params.S)),
        span=float(f(params.b)), chord=float(f(params.c)),
        eps=float(params.epsilon), Cn_rudder=float(cp.Cn_rudder),
        com=tuple(map(float, com)), gravity=tuple(map(float, f(params.gravity))),
        J=tuple(map(float, J.ravel())), Jinv=tuple(map(float, Jinv.ravel())),
        is_mlp=float(is_mlp),
        dflt=tuple(default_coeff_vector(
            cp if not is_mlp else DefaultCoeffParams())))
    mlp = (fold_mlp(cp) if is_mlp
           else torch.zeros(1, dtype=torch.float32, device=params.device))
    return consts, mlp.to(params.device).contiguous()


def make_window_operands(spec: dict, N: int, *, gain_clip: float = 1e4,
                         alphas: tuple = line_search_alphas(6),
                         device="cuda") -> WindowOperands:
    """Resolve ``spec`` (``build_mhtt_ocp``'s ``spec_out``) for the
    kernels.  Raises NotImplementedError on what the kernels do not
    compute: wind channels, an unresolved envelope, coefficient models
    other than the MLP and the default."""
    ws, table = make_window_spec(spec, N)
    if not 2 <= len(alphas) <= A_MAX:
        raise ValueError(f"window kernels take 2..{A_MAX} step sizes")
    dev = resolve_device(device)
    plant, mlp = plant_consts(spec["params"])
    zeros7 = (0.0,) * 7
    consts = dict(
        plant,
        N=float(N), substeps=float(ws.substeps), M=float(ws.M), dt=ws.dt,
        L=ws.L, progress_correction=ws.progress_correction,
        dim_mask=ws.dim_mask, v_ref=ws.v_ref, w_speed=ws.w_speed,
        w_rate=ws.w_rate, alpha_guard=ws.alpha_guard,
        beta_guard=ws.beta_guard, stall_margin=ws.stall_margin,
        stall_factor=ws.stall_factor, speed_lo2=ws.speed_lo2,
        speed_hi2=ws.speed_hi2, lo_scale=ws.lo_scale, hi_scale=ws.hi_scale,
        alpha_lim=ws.alpha_lim, beta_lim=ws.beta_lim,
        squash=float(ws.squash_mid is not None),
        squash_mid=ws.squash_mid or zeros7, squash_half=ws.squash_half or zeros7,
        include_box=float(ws.include_box), box_lb=ws.box_lb or zeros7,
        box_ub=ws.box_ub or zeros7, nr=float(n_residual_rows(ws)),
        ng=float(n_ineq_rows(ws)), rcoef=tuple(_residual_coefs(ws)),
        gain_clip=float(gain_clip), n_alpha=float(len(alphas)),
        alphas=tuple(alphas) + (0.0,) * (A_MAX - len(alphas)),
    )
    return WindowOperands(
        spec=ws, consts=consts, mlp=mlp.to(dev).contiguous(),
        table=torch.as_tensor(table, device=dev).contiguous(),
        restfac=torch.tensor(ws.rest_factors, dtype=torch.float32,
                             device=dev),
        alphas=tuple(alphas),
        alpha_vec=torch.tensor(alphas, dtype=torch.float32, device=dev),
        is_mlp=bool(plant["is_mlp"]),
        nr=n_residual_rows(ws), ng=n_ineq_rows(ws))


# ---------------------------------------------------------------------------
# plain versions: the knot function, batched over leading axes
# ---------------------------------------------------------------------------


def _abs(x):
    """|x| with the reference's derivative +1 at 0 (JAX's abs rule)."""
    return torch.where(x >= 0.0, x, -x)


def _mlp_split(op: WindowOperands):
    w = op.mlp
    return (w[0:80].reshape(5, 16), w[80:96], w[96:608].reshape(16, 32),
            w[608:640], w[640:832].reshape(32, 6), w[832:838])


def _coeff6(op: WindowOperands, qbar, alpha, beta, ail, elev, rud, rates):
    C = op.consts
    if op.is_mlp:
        w0, b0, w1, b1, w2, b2 = _mlp_split(op)
        inp = torch.stack([qbar, alpha, beta, ail, elev], dim=-1)
        h = torch.tanh((inp @ w0 + b0) @ w1 + b1)
        out = h @ w2 + b2
        cn = out[..., 5] + C["Cn_rudder"] * 6.0 * rud * DEG2RAD
        return [out[..., i] for i in range(5)] + [cn]
    (CD0, CD_a, CL0, CL_a, CY_b, Cl_ail, Cl_p, Cm_el, Cm_q, Cn_rud,
     Cn_r) = C["dflt"]
    p, q, r = rates
    CD = CD0 + CD_a * alpha * alpha
    CL = CL0 + CL_a * alpha
    return [-CD, CY_b * beta, -CL,
            Cl_ail * 4.0 * ail * DEG2RAD + Cl_p * p,
            Cm_el * 5.0 * elev * DEG2RAD + Cm_q * q,
            Cn_rud * 6.0 * rud * DEG2RAD + Cn_r * r]


def _rel_flow(op: WindowOperands, x):
    """Body-frame relative flow + eps, v², alpha, beta at state rows x."""
    eps = op.consts["eps"]
    v0, v1, v2 = x[..., 3], x[..., 4], x[..., 5]
    qx, qy, qz, qw = x[..., 6], x[..., 7], x[..., 8], x[..., 9]
    ux, uy, uz = -qx, -qy, -qz
    tx = 2.0 * (uy * v2 - uz * v1)
    ty = 2.0 * (uz * v0 - ux * v2)
    tz = 2.0 * (ux * v1 - uy * v0)
    vr0 = v0 + qw * tx + (uy * tz - uz * ty) + eps
    vr1 = v1 + qw * ty + (uz * tx - ux * tz) + eps
    vr2 = v2 + qw * tz + (ux * ty - uy * tx) + eps
    vsq = vr0 * vr0 + vr1 * vr1 + vr2 * vr2
    airspeed = torch.sqrt(vsq + eps)
    alpha = torch.atan2(vr2, vr0 + eps)
    beta = torch.asin(clip(vr1 / airspeed, -1.0, 1.0))
    return vr0, vsq, alpha, beta


def _derivative(op: WindowOperands, x, u):
    """ẋ of the 13-state plant (dynamics/aircraft.state_derivative with
    the parallel-axis inertia and its inverse precomputed)."""
    C = op.consts
    v0, v1, v2 = x[..., 3], x[..., 4], x[..., 5]
    qx, qy, qz, qw = x[..., 6], x[..., 7], x[..., 8], x[..., 9]
    wx, wy, wz = x[..., 10], x[..., 11], x[..., 12]
    vr0, vsq, alpha, beta = _rel_flow(op, x)
    qbar = 0.5 * RHO * vsq
    co = _coeff6(op, qbar, alpha, beta, u[..., 0], u[..., 1], u[..., 2],
                 (wx, wy, wz))
    flaps = u[..., 6]
    c0 = co[0] + C_D_FLAPS * flaps
    c2 = co[2] + C_Z_FLAPS * flaps
    qS = qbar * C["area"]
    f0 = c0 * qS * torch.sign(vr0)
    f1 = co[1] * qS
    f2 = c2 * qS
    cx, cy, cz = C["com"]
    m0 = co[3] * qS * C["span"] + (cy * f2 - cz * f1)
    m1 = co[4] * qS * C["chord"] + (cz * f0 - cx * f2)
    m2 = co[5] * qS * C["span"] + (cx * f1 - cy * f0)
    tx = 2.0 * (qy * f2 - qz * f1)
    ty = 2.0 * (qz * f0 - qx * f2)
    tz = 2.0 * (qx * f1 - qy * f0)
    inv_m = 1.0 / C["mass"]
    g = C["gravity"]
    a0 = (f0 + qw * tx + (qy * tz - qz * ty)) * inv_m + g[0]
    a1 = (f1 + qw * ty + (qz * tx - qx * tz)) * inv_m + g[1]
    a2 = (f2 + qw * tz + (qx * ty - qy * tx)) * inv_m + g[2]
    qd0 = 0.5 * (qw * wx + qy * wz - qz * wy)
    qd1 = 0.5 * (qw * wy - qx * wz + qz * wx)
    qd2 = 0.5 * (qw * wz + qx * wy - qy * wx)
    qd3 = 0.5 * (-qx * wx - qy * wy - qz * wz)
    J, Ji = C["J"], C["Jinv"]
    Jw0 = J[0] * wx + J[1] * wy + J[2] * wz
    Jw1 = J[3] * wx + J[4] * wy + J[5] * wz
    Jw2 = J[6] * wx + J[7] * wy + J[8] * wz
    t0 = m0 - (wy * Jw2 - wz * Jw1)
    t1 = m1 - (wz * Jw0 - wx * Jw2)
    t2 = m2 - (wx * Jw1 - wy * Jw0)
    wd0 = Ji[0] * t0 + Ji[1] * t1 + Ji[2] * t2
    wd1 = Ji[3] * t0 + Ji[4] * t1 + Ji[5] * t2
    wd2 = Ji[6] * t0 + Ji[7] * t1 + Ji[8] * t2
    return torch.stack([v0, v1, v2, a0, a1, a2, qd0, qd1, qd2, qd3,
                        wd0, wd1, wd2], dim=-1)


def _rk4_norm(op: WindowOperands, x, u, h):
    k1 = _derivative(op, x, u)
    k2 = _derivative(op, x + 0.5 * h * k1, u)
    k3 = _derivative(op, x + 0.5 * h * k2, u)
    k4 = _derivative(op, x + h * k3, u)
    x = x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    q = x[..., 6:10]
    inv = 1.0 / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-12)
    return torch.cat([x[..., :6], q * inv, x[..., 10:]], dim=-1)


def _track(op: WindowOperands, s):
    """Catmull-Rom position and d/ds at progress s, by direct index into
    the pre-shifted table; the segment index carries no derivative."""
    M = op.spec.M
    u = clip(s, 0.0, 1.0) * (M - 1)
    i = torch.floor(u)
    # a NaN progress reads segment 0, as the kernels' fmaxf does
    i = torch.clamp(torch.where(torch.isnan(i), torch.zeros_like(i), i),
                    0.0, M - 2.0)
    t = (u - i)[..., None]
    rows = op.table[i.to(torch.int64)]
    p0, p1, p2, p3 = rows[..., 0:3], rows[..., 3:6], rows[..., 6:9], rows[..., 9:12]
    t2 = t * t
    pos = 0.5 * ((2.0 * p1) + (-p0 + p2) * t
                 + (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3) * t2
                 + (-p0 + 3.0 * p1 - 3.0 * p2 + p3) * (t2 * t))
    dp = 0.5 * ((-p0 + p2) + 2.0 * (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3) * t
                + 3.0 * (-p0 + 3.0 * p1 - 3.0 * p2 + p3) * t2)
    return pos, dp * (M - 1)


def _squash(op: WindowOperands, w):
    ws = op.spec
    if ws.squash_mid is None:
        return w
    cols = []
    for c in range(UD):
        if ws.squash_half[c] == 0.0:
            cols.append(torch.zeros_like(w[..., c]) + ws.squash_mid[c])
        else:
            cols.append(ws.squash_mid[c] + ws.squash_half[c]
                        * saturating_tanh(w[..., c]))
    return torch.stack(cols, dim=-1)


def knot_outputs(op: WindowOperands, x, w, rf):
    """(x_next (..., 14), r (..., NR), g (..., NG), rest (...)) of one knot:
    the plant step, the residual rows of build_mhtt_ocp, the inequality
    rows of envelope_ineq, and the progress reward."""
    ws = op.spec
    rc = op.consts["rcoef"]
    u = _squash(op, w)
    dm = ws.dim_mask
    Linv = 1.0 / ws.L
    s = x[..., 13]
    pos, tan = _track(op, s)
    tangent = [tan[..., d] * (dm[d] * Linv) for d in range(3)]
    tnorm = torch.sqrt(tangent[0] ** 2 + tangent[1] ** 2 + tangent[2] ** 2)
    denom = torch.where(tnorm > 1e-3, tnorm, torch.ones_like(tnorm))
    tdir = [t / denom for t in tangent]
    s_dot = (x[..., 3] * tdir[0] + x[..., 4] * tdir[1]
             + x[..., 5] * tdir[2]) * Linv
    pos_err = [(x[..., d] - pos[..., d]) * dm[d] for d in range(3)]
    corr = (pos_err[0] * tdir[0] + pos_err[1] * tdir[1]
            + pos_err[2] * tdir[2]) * Linv

    xn = x[..., :13]
    for _ in range(ws.substeps):
        xn = _rk4_norm(op, xn, u, ws.dt / ws.substeps)
    s_next = clip(s + s_dot * ws.dt + ws.progress_correction * corr, 0.0, 1.05)
    x_next = torch.cat([xn, s_next[..., None]], dim=-1)

    zero = torch.zeros_like(s)
    speed = torch.sqrt(x[..., 3] ** 2 + x[..., 4] ** 2 + x[..., 5] ** 2)
    _, vsq, alpha, beta = _rel_flow(op, x)
    r = [rc[0] * pos_err[d] for d in range(3)]
    r.append(rc[1] * torch.maximum(zero, -s_dot))
    r.append(rc[2] * torch.maximum(0.1 - speed, zero))
    r += [rc[3] * u[..., c] for c in range(UD)]
    r.append(rc[4] * torch.maximum(speed - 110.0, zero))
    if ws.w_speed > 0.0:
        r.append(rc[5] * (speed - ws.v_ref))
        r.append(rc[6] * torch.maximum((ws.v_ref - ws.stall_margin) - speed,
                                       zero))
    if ws.w_rate > 0.0:
        r += [rc[7] * x[..., 10 + d] for d in range(3)]
    if ws.alpha_guard > 0.0:
        r.append(rc[8] * torch.maximum(_abs(alpha) - ws.alpha_guard, zero))
    if ws.beta_guard > 0.0:
        r.append(rc[8] * torch.maximum(_abs(beta) - ws.beta_guard, zero))

    g = []
    if ws.include_box:
        g += [u[..., c] - ws.box_ub[c] for c in range(UD)]
        g += [ws.box_lb[c] - u[..., c] for c in range(UD)]
    g += [(ws.speed_lo2 - vsq) * ws.lo_scale, (vsq - ws.speed_hi2) * ws.hi_scale,
          beta - ws.beta_lim, -ws.beta_lim - beta,
          alpha - ws.alpha_lim, -ws.alpha_lim - alpha, x[..., 2]]
    rest = (-W_PROGRESS * s - W_PROGRESS_RATE * (0.5 * torch.tanh(s_dot / 0.5))) * rf
    return x_next, torch.stack(r, dim=-1), torch.stack(g, dim=-1), rest


def al_stage_cost(op: WindowOperands, x, w, rf, lam, mu, mu_row):
    """AL stage cost of one knot and the next state: 0.5‖r‖² + rest +
    PHR terms with the per-row penalty μ·μ_row."""
    x_next, r, g, rest = knot_outputs(op, x, w, rf)
    c = 0.5 * torch.sum(r * r, dim=-1) + rest
    mu_g = mu[..., None] * mu_row
    gplus = torch.clamp_min(g + lam / mu_g, 0.0)
    c = c + 0.5 * torch.sum(mu_g * gplus * gplus, dim=-1)
    c = c - 0.5 * torch.sum(lam * lam / mu_g, dim=-1)
    return c, x_next


def terminal_cost(op: WindowOperands, x):
    """W_TERMINAL_ALIGN·‖(p - track(s))·mask + 1e-9‖ - 10·W_PROGRESS·s."""
    dm = op.spec.dim_mask
    s = x[..., 13]
    pos, _ = _track(op, s)
    e = [(x[..., d] - pos[..., d]) * dm[d] + 1e-9 for d in range(3)]
    align = torch.sqrt(e[0] ** 2 + e[1] ** 2 + e[2] ** 2)
    return W_TERMINAL_ALIGN * align - W_PROGRESS * 10.0 * s


def _sanitize(t, lim):
    t = torch.where(torch.isfinite(t), t, torch.zeros_like(t))
    return torch.clamp(t, -lim, lim)


def _chol_solve(a, rhs):
    """Unrolled Cholesky of a (B, 7, 7) and solve for rhs (B, 7, k); a
    pivot below -1e-6 flags the scenario, pivots are floored at 1e-12."""
    m = a.shape[-1]
    L = [[None] * m for _ in range(m)]
    bad = torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
    for i in range(m):
        for j in range(i + 1):
            s = a[:, i, j]
            for p in range(j):
                s = s - L[i][p] * L[j][p]
            if i == j:
                bad = bad | (s < -1e-6)
                L[i][j] = torch.sqrt(torch.clamp_min(s, 1e-12))
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
    return torch.stack(x, dim=1), bad


def backward_plain(op: WindowOperands, xs, ws, lam, mu, reg, mu_row, vx, vxx):
    """Plain version of the backward kernel (same arguments and results as
    ``window_backward``).  All N knots are linearised at once in forward
    mode; the Riccati sweep then runs knot by knot."""
    B, N = ws.shape[0], ws.shape[1]
    NR, NG = op.nr, op.ng
    rf = op.restfac

    rf_bn = rf.repeat(B)

    def f(x, w):
        x_next, r, g, rest = knot_outputs(op, x, w, rf_bn)
        return torch.cat([x_next, r, g, rest[..., None]], dim=-1)

    X, W = xs[:, :N].reshape(B * N, XD), ws.reshape(B * N, UD)
    out = f(X, W).reshape(B, N, -1)
    D = batched_jacfwd(f, X, W).transpose(-1, -2).reshape(B, N, NDIR, -1)
    dxn, dr, dg, drest = (D[..., :XD], D[..., XD:XD + NR],
                          D[..., XD + NR:XD + NR + NG], D[..., -1])
    r, g = out[..., XD:XD + NR], out[..., XD + NR:XD + NR + NG]

    mu_g = mu[:, None] * mu_row
    Vx, Vxx = vx, vxx
    K = xs.new_empty((B, N, UD, XD))
    kff = xs.new_empty((B, N, UD))
    dv1 = xs.new_zeros(B)
    dv2 = xs.new_zeros(B)
    qumax = xs.new_zeros(B)
    fail = torch.zeros(B, dtype=torch.bool, device=xs.device)
    clipk = op.consts["gain_clip"]
    for k in reversed(range(N)):
        gk, lk = g[:, k], lam[:, k]
        act = (gk + lk / mu_g) > 0.0
        y = torch.where(act, lk + mu_g * gk, torch.zeros_like(gk))
        wgt = torch.where(act, mu_g, torch.zeros_like(gk))
        grad = (dr[:, k] @ r[:, k, :, None])[..., 0] \
            + (dg[:, k] @ y[..., None])[..., 0] + drest[:, k]
        H = dr[:, k] @ dr[:, k].transpose(-1, -2) \
            + (dg[:, k] * wgt[:, None, :]) @ dg[:, k].transpose(-1, -2)
        grad = _sanitize(grad, 1e8)
        H = _sanitize(H, 1e8)
        F = _sanitize(dxn[:, k], 1e6)                 # (B, 21, 14) = [Aᵀ; Bᵀ]
        Qv = grad + (F @ Vx[..., None])[..., 0]       # [Qx; Qu]
        Q = H + F @ Vxx @ F.transpose(-1, -2)         # [[Qxx, ·], [Qux, Quu]]
        Qx, Qu = Qv[:, :XD], Qv[:, XD:]
        Qxx, Qux, Quu = Q[:, :XD, :XD], Q[:, XD:, :XD], Q[:, XD:, XD:]
        a = 0.5 * (Quu + Quu.transpose(-1, -2)) \
            + reg[:, None, None] * torch.eye(UD, device=xs.device)
        sol, bad = _chol_solve(a, torch.cat([Qu[..., None], Qux], dim=-1))
        kk = torch.clamp(-sol[..., 0], -clipk, clipk)
        KK = torch.clamp(-sol[..., 1:], -clipk, clipk)
        K[:, k], kff[:, k] = KK, kk
        KT = KK.transpose(-1, -2)
        Quu_k = (Quu @ kk[..., None])[..., 0]
        Vx = Qx + (KT @ Quu_k[..., None])[..., 0] + (KT @ Qu[..., None])[..., 0] \
            + (Qux.transpose(-1, -2) @ kk[..., None])[..., 0]
        KQx = KT @ Qux
        Vxx = Qxx + (KT @ Quu) @ KK + KQx + KQx.transpose(-1, -2)
        Vxx = 0.5 * (Vxx + Vxx.transpose(-1, -2))
        Vx, Vxx = _sanitize(Vx, 1e14), _sanitize(Vxx, 1e14)
        dv1 = dv1 + torch.sum(kk * Qu, dim=-1)
        dv2 = dv2 + 0.5 * torch.sum(kk * Quu_k, dim=-1)
        qumax = torch.maximum(qumax, torch.amax(torch.abs(Qu), dim=-1))
        fail = fail | bad
    return K, kff, dv1, dv2, qumax, fail


def forward_plain(op: WindowOperands, xs, ws, K, kff, lam, mu, mu_row):
    """Plain version of the forward kernel: all candidates as one batch
    (B, A), then the best α per scenario selects the stored trajectory."""
    B, N = ws.shape[0], ws.shape[1]
    A = len(op.alphas)
    alpha = op.alpha_vec
    x = xs[:, None, 0].expand(B, A, XD)
    cost = xs.new_zeros((B, A))
    nfro = xs.new_zeros((B, A))
    xs_c = [x]
    ws_c = []
    for k in range(N):
        dx = x - xs[:, None, k]
        w = (ws[:, None, k] + alpha[None, :, None] * kff[:, None, k]
             + (K[:, None, k] @ dx[..., None])[..., 0])
        c, x_next = al_stage_cost(op, x, w, op.restfac[k], lam[:, None, k],
                                  mu[:, None], mu_row[:, None])
        finite = (torch.isfinite(x_next).all(dim=-1)
                  & (torch.amax(torch.abs(x_next), dim=-1) < 1e6))
        x = torch.where(finite[..., None], x_next, x)
        cost = cost + c
        nfro = nfro + (~finite).to(xs.dtype)
        xs_c.append(x)
        ws_c.append(w)
    cost = cost + terminal_cost(op, x)
    cost = torch.where(torch.isnan(cost), torch.full_like(cost, np.inf), cost)
    cost = cost + FREEZE_PENALTY * nfro
    best_i = torch.zeros(B, dtype=torch.int64, device=xs.device)
    best_c = cost[:, 0]
    for a in range(1, A):
        better = cost[:, a] < best_c
        best_c = torch.where(better, cost[:, a], best_c)
        best_i = torch.where(better, torch.full_like(best_i, a), best_i)
    rows = torch.arange(B, device=xs.device)
    xs_new = torch.stack(xs_c, dim=2)[rows, best_i]
    ws_new = torch.stack(ws_c, dim=2)[rows, best_i]
    misc = torch.cat([cost, best_c[:, None], nfro[rows, best_i][:, None],
                      alpha[best_i][:, None]], dim=1)
    return xs_new, ws_new, misc


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _consts(op: WindowOperands, name: str):
    """The library ``name`` and ``op.consts`` packed in its layout, packed
    once per operands and library."""
    from aircraft_tpu_torch.kernels import _build

    lib = _build.library(name)
    packed = op.packed.get(name)
    if packed is None:
        packed = op.packed[name] = _build.pack_consts(lib, op.consts)
    return lib, packed


def forward_smem_bytes(N: int, ng: int, A: int) -> int:
    """Shared memory of one block of the forward kernel: the scenario's
    xs, ws, K, k, lam and mu_row, then the pick's 2A + 1 words
    (``forward_smem_floats`` in ``csrc/window_forward.cu``)."""
    return 4 * ((N + 1) * XD + N * (UD + UD * XD + UD + ng) + ng + 2 * A + 1)


def launch_backward(op: WindowOperands, args, quad, outs, phases: int = 3):
    """Launch the backward kernels on the current stream: phase A (bit 1)
    fills ``quad`` (B, N, KNOT_FLOATS) from ``args`` = (xs, ws, lam, mu,
    reg, mu_row, vx, vxx), phase B (bit 2) sweeps it into ``outs`` = (K,
    kff, dv1, dv2, qu_max, fail).  No checks and no count: the wrapper
    ``window_backward`` does both."""
    from aircraft_tpu_torch.kernels import _build

    lib, consts = _consts(op, "window_backward")
    if lib.window_backward_knot_floats() != KNOT_FLOATS:
        raise RuntimeError("window_backward: the library's knot record is not "
                           f"{KNOT_FLOATS} floats")
    xs, ws, lam, mu, reg, mu_row, vx, vxx = args
    err = lib.window_backward_launch(
        consts, ctypes.c_int(len(consts)),
        *(_ptr(t) for t in (xs, ws, lam, mu, reg, mu_row, vx, vxx, op.mlp,
                            op.table, op.restfac, quad, *outs)),
        ctypes.c_int(ws.shape[0]), ctypes.c_int(phases),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"window_backward launch failed: {_build.error_string(lib, err)}")


def window_backward(op: WindowOperands, xs, ws, lam, mu, reg, mu_row, vx,
                    vxx):
    """Backward pass of one inner iteration.  xs (B,N+1,14), ws (B,N,7),
    lam (B,N,NG), mu (B,), reg (B,), mu_row (B,NG), vx (B,14),
    vxx (B,14,14) -> K (B,N,7,14), k (B,N,7), dv1, dv2, qu_max (B,) and
    fail (B,) bool.  CPU tensors take the plain version; CUDA tensors
    launch the two kernels of ``csrc/window_backward.cu`` (one count)."""
    B, N = ws.shape[0], ws.shape[1]
    NG = op.ng
    for name, t, shape in (("xs", xs, (B, N + 1, XD)), ("ws", ws, (B, N, UD)),
                           ("lam", lam, (B, N, NG)), ("mu", mu, (B,)),
                           ("reg", reg, (B,)), ("mu_row", mu_row, (B, NG)),
                           ("vx", vx, (B, XD)), ("vxx", vxx, (B, XD, XD))):
        _check(name, t, shape, op.device)
    if N != op.spec.N:
        raise ValueError(f"horizon {N}, operands built for {op.spec.N}")
    if xs.device.type == "cpu":
        return backward_plain(op, xs, ws, lam, mu, reg, mu_row, vx, vxx)
    if xs.device.type != "cuda":
        raise RuntimeError(f"window_backward: no kernel for {xs.device}")
    dev = xs.device
    quad = torch.empty((B, N, KNOT_FLOATS), dtype=torch.float32, device=dev)
    outs = (torch.empty((B, N, UD, XD), dtype=torch.float32, device=dev),
            torch.empty((B, N, UD), dtype=torch.float32, device=dev),
            *(torch.empty(B, dtype=torch.float32, device=dev) for _ in range(3)),
            torch.empty(B, dtype=torch.bool, device=dev))
    launch_backward(op, (xs, ws, lam, mu, reg, mu_row, vx, vxx), quad, outs)
    window_backward.launches += 1
    return outs


window_backward.launches = 0


def window_forward(op: WindowOperands, xs, ws, K, kff, lam, mu, mu_row):
    """Line-search forward pass of one inner iteration.  xs (B,N+1,14),
    ws (B,N,7), K (B,N,7,14), kff (B,N,7), lam (B,N,NG), mu (B,),
    mu_row (B,NG) -> xs_new, ws_new and misc (B, A+3) = [A candidate
    costs, best cost, frozen knots of the best, best α].  CPU tensors take
    the plain version; CUDA tensors launch ``csrc/window_forward.cu``.
    Raises ValueError, on every device, for a horizon whose reference does
    not fit the kernel's shared memory."""
    B, N = ws.shape[0], ws.shape[1]
    NG = op.ng
    A = len(op.alphas)
    for name, t, shape in (("xs", xs, (B, N + 1, XD)), ("ws", ws, (B, N, UD)),
                           ("K", K, (B, N, UD, XD)), ("kff", kff, (B, N, UD)),
                           ("lam", lam, (B, N, NG)), ("mu", mu, (B,)),
                           ("mu_row", mu_row, (B, NG))):
        _check(name, t, shape, op.device)
    if N != op.spec.N:
        raise ValueError(f"horizon {N}, operands built for {op.spec.N}")
    smem = forward_smem_bytes(N, NG, A)
    if smem > SMEM_MAX:
        raise ValueError(
            f"window_forward: horizon {N} needs {smem} bytes of shared memory "
            f"per block, more than the {SMEM_MAX} a block may use")
    if xs.device.type == "cpu":
        return forward_plain(op, xs, ws, K, kff, lam, mu, mu_row)
    if xs.device.type != "cuda":
        raise RuntimeError(f"window_forward: no kernel for {xs.device}")
    from aircraft_tpu_torch.kernels import _build

    lib, consts = _consts(op, "window_forward")
    dev = xs.device
    xs_new = torch.empty((B, N + 1, XD), dtype=torch.float32, device=dev)
    ws_new = torch.empty((B, N, UD), dtype=torch.float32, device=dev)
    misc = torch.empty((B, A + 3), dtype=torch.float32, device=dev)
    cand_xs = torch.empty((B, A, N + 1, XD), dtype=torch.float32, device=dev)
    cand_ws = torch.empty((B, A, N, UD), dtype=torch.float32, device=dev)
    err = lib.window_forward_launch(
        consts, ctypes.c_int(len(consts)),
        *(_ptr(t) for t in (xs, ws, K, kff, lam, mu, mu_row, op.mlp,
                            op.table, op.restfac, xs_new, ws_new, misc,
                            cand_xs, cand_ws)),
        ctypes.c_int(B), ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"window_forward launch failed: {_build.error_string(lib, err)}")
    window_forward.launches += 1
    return xs_new, ws_new, misc


window_forward.launches = 0

KERNELS = (window_backward, window_forward)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
