"""Trim search: a batched, projected Levenberg-Marquardt Gauss-Newton
solve of ‖v̇‖² + ‖ω̇‖² (+ an airspeed target) over the decision vector
z = [v_ned(3), rotvec(3), aileron, elevator, rudder, com(3)].

Orientation is a rotation vector, so the unit-quaternion constraint
vanishes; body rates are pinned to 0; box constraints are projections.
Every start of a multistart is one row of one batched solve.

The stability analysis around a trim point (``continuous_jacobians`` ...
``discrete_stability_analysis``) takes the spectra of the continuous
Jacobian and of the RK4 step map's, over a cloud of perturbed states and
a sweep of time steps, each cloud as one batch; only the 13x13
eigendecompositions run on the host.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from aircraft_tpu_torch.dynamics import aircraft as ac
from aircraft_tpu_torch.device import resolve_device
from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
from aircraft_tpu_torch.ops import quaternion as quat
from aircraft_tpu_torch.ops.autodiff import batched_jacfwd
from aircraft_tpu_torch.solvers import integrators
from aircraft_tpu_torch.utils import perturb_quaternion

_NZ = 12

# centre and spread of the random start cloud of multistart_trim
START_MID = (50.0, 0.0, 2.0, 0.0, 0.05, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
START_SPREAD = (10.0, 1.0, 3.0, 0.05, 0.1, 0.05, 1.0, 1.0, 1.0, 0.1, 0.02,
                0.02)
# the reference's start clouds, drawn once from jax.random.PRNGKey(0) and
# stored as data: torch cannot replay JAX's random stream
REFERENCE_STARTS = Path(__file__).with_name("trim_starts.npz")


class TrimResult(NamedTuple):
    state: torch.Tensor     # (..., 13) trimmed state
    control: torch.Tensor   # (..., 10) trimmed control incl. CoM
    residual: torch.Tensor  # ‖[v̇, ω̇]‖ at the trim point
    converged: torch.Tensor


def _unpack(z, base_pos):
    v = z[..., 0:3]
    q = quat.expmap(z[..., 3:6])
    zero = torch.zeros_like(z[..., :1])
    controls = torch.cat([z[..., 6:9], zero, zero, zero, zero, z[..., 9:12]],
                         dim=-1)
    state = torch.cat([base_pos.expand(v.shape), v, q, zero, zero, zero],
                      dim=-1)
    return state, controls


def _residual(params, z, base_pos, target_airspeed, w_speed):
    state, controls = _unpack(z, base_pos)
    xdot = ac.state_derivative(params, state, controls)
    r = torch.cat([xdot[..., 3:6], xdot[..., 10:13]], dim=-1)
    if target_airspeed is not None:
        speed = torch.sqrt(torch.sum(state[..., 3:6] ** 2, dim=-1))
        r = torch.cat([r, (w_speed * (speed - target_airspeed))[..., None]],
                      dim=-1)
    return r


def solve_trim(params: AircraftParams, z0: torch.Tensor, bounds,
               target_airspeed: Optional[float] = None, *,
               base_pos: Optional[torch.Tensor] = None, iters: int = 60,
               w_speed: float = 1.0) -> TrimResult:
    """Projected Levenberg-Marquardt from each row of z0 (S, 12)."""
    dev, dt = z0.device, z0.dtype
    if base_pos is None:
        base_pos = torch.tensor([0.0, 0.0, -200.0], dtype=dt, device=dev)
    lb, ub = (torch.as_tensor(b, dtype=dt, device=dev) for b in bounds)

    def res1(z):
        return _residual(params, z, base_pos, target_airspeed, w_speed)

    eye = torch.eye(_NZ, dtype=dt, device=dev)
    z = z0
    lam = torch.full(z0.shape[:1], 1e-3, dtype=dt, device=dev)
    for _ in range(iters):
        r = res1(z)
        J = batched_jacfwd(res1, z)
        Jt = J.transpose(-1, -2)
        H = Jt @ J + lam[:, None, None] * eye
        dz = -torch.linalg.solve(H, (Jt @ r[..., None]))[..., 0]
        z_new = torch.minimum(torch.maximum(z + dz, lb), ub)
        r_new = res1(z_new)
        improved = torch.sum(r_new * r_new, -1) < torch.sum(r * r, -1)
        z = torch.where(improved[:, None], z_new, z)
        lam = torch.where(improved, torch.clamp_min(lam * 0.5, 1e-10),
                          lam * 4.0)
    r = res1(z)
    rnorm = torch.sqrt(torch.sum(r[..., :6] ** 2, dim=-1))
    state, control = _unpack(z, base_pos)
    return TrimResult(state=state, control=control, residual=rnorm,
                      converged=rnorm < 1e-3)


def default_trim_bounds(control_envelope=None):
    """(lb, ub) numpy bounds on the trim decision vector: airspeed through
    the velocity box, controls and CoM from the envelope when given."""
    lb = np.array([5.0, -20.0, -20.0, -1.0, -1.0, -np.pi, -5.0, -5.0, -5.0,
                   -0.5, -0.1, -0.1], np.float32)
    ub = np.array([100.0, 20.0, 20.0, 1.0, 1.0, np.pi, 5.0, 5.0, 5.0, 0.5,
                   0.1, 0.1], np.float32)
    if control_envelope is not None:
        clb, cub = control_envelope.bounds(10)
        lb[6:9], lb[9:12] = clb[:3], clb[7:10]
        ub[6:9], ub[9:12] = cub[:3], cub[7:10]
    return lb, ub


def start_cloud(n_starts: int, generator: torch.Generator,
                device="cuda") -> torch.Tensor:
    """(n_starts, 12) random trim starts around START_MID, drawn from a
    CPU ``generator`` and moved to ``device``."""
    dev = resolve_device(device)
    noise = torch.randn((n_starts, _NZ), generator=generator,
                        dtype=torch.float32)
    z = (torch.tensor(START_MID) + torch.tensor(START_SPREAD) * noise)
    return z.to(dev)


def reference_start_cloud(n_starts: int) -> np.ndarray:
    """(n_starts, 12) float32: the reference's multistart cloud,
    START_MID + START_SPREAD · N(0, 1) drawn from jax.random.PRNGKey(0)
    and clipped to ``default_trim_bounds()``, for the sizes its bench draws
    (8 per best-glide speed, 32 for the fleet trim)."""
    with np.load(REFERENCE_STARTS) as d:
        key = f"starts_{n_starts}"
        if key not in d.files:
            raise ValueError(f"no reference start cloud of {n_starts} "
                             f"starts (have {sorted(d.files)})")
        return d[key].copy()


def _take(sols: TrimResult, idx) -> TrimResult:
    return TrimResult(*(t[idx] for t in sols))


def multistart_trim(params: AircraftParams, z0s: Optional[torch.Tensor] = None,
                    *, n_starts: int = 64,
                    target_airspeed: Optional[float] = 50.0, bounds=None,
                    prefer_coordinated: bool = False,
                    generator: Optional[torch.Generator] = None
                    ) -> TrimResult:
    """Best trim over a cloud of starts: ``z0s`` (S, 12), or ``n_starts``
    drawn from ``generator``.  ``prefer_coordinated`` picks, among the
    converged starts, the one with the least sideslip instead of the least
    residual.  When no start converges, a ladder of glide-angle seeds is
    tried and every found point is re-solved without the speed penalty.
    The search runs in the dtype of ``params`` (float32, or float64 for
    parameters cast with ``params.to(torch.float64)``)."""
    dev, dt = params.device, params.mass.dtype
    if bounds is None:
        bounds = default_trim_bounds()
    lb, ub = (torch.as_tensor(b, dtype=dt, device=dev) for b in bounds)
    if z0s is None:
        gen = generator if generator is not None else torch.Generator()
        z0s = start_cloud(n_starts, gen, dev)
    z0s = torch.minimum(torch.maximum(
        torch.as_tensor(z0s, dtype=dt, device=dev), lb), ub)
    sols = solve_trim(params, z0s, (lb, ub), target_airspeed)

    def lat(state):
        v_body = quat.rotate_inv(state[..., 6:10], state[..., 3:6])
        return torch.abs(v_body[..., 1])

    if prefer_coordinated:
        score = torch.where(sols.residual < 1e-3, lat(sols.state),
                            1e6 + sols.residual)
    else:
        score = sols.residual
    if not bool(torch.any(sols.residual < 1e-3)):
        v_seed = 30.0 if target_airspeed is None else float(target_airspeed)
        glide = []
        for v_s in dict.fromkeys((v_seed, 35.0, 50.0)):
            for g_deg in (2.0, 6.0, 10.0, 15.0, 20.0, 26.0, 32.0, 38.0):
                g = np.deg2rad(g_deg)
                for a0, de0 in ((0.0, 0.0), (0.08, -1.0), (0.0, 3.0)):
                    glide.append([v_s * np.cos(g), 0.0, v_s * np.sin(g),
                                  0.0, a0 - g, 0.0, 0.0, de0, 0.0,
                                  0.0, 0.0, 0.0])
        z0s_g = torch.minimum(torch.maximum(torch.tensor(
            glide, dtype=dt, device=dev), lb), ub)
        sols_g = solve_trim(params, z0s_g, (lb, ub), target_airspeed)
        sols = TrimResult(*(torch.cat([a, b], 0)
                            for a, b in zip(sols, sols_g)))
        z_found = torch.cat([sols.state[:, 3:6],
                             quat.logmap(sols.state[:, 6:10]),
                             sols.control[:, 0:3], sols.control[:, 7:10]],
                            dim=-1)
        polished = solve_trim(params, z_found, (lb, ub), None)
        better = polished.residual < sols.residual
        sols = TrimResult(*(
            torch.where(better.reshape((-1,) + (1,) * (p.ndim - 1)), p, s)
            for p, s in zip(polished, sols)))
        speeds = torch.sqrt(torch.sum(sols.state[:, 3:6] ** 2, dim=-1))
        dv = (torch.abs(speeds - target_airspeed)
              if target_airspeed is not None else torch.zeros_like(speeds))
        if prefer_coordinated:
            score = torch.where(sols.residual < 1e-3,
                                lat(sols.state) + 0.01 * dv,
                                1e6 + sols.residual)
        else:
            score = torch.where(sols.residual < 1e-3, dv,
                                1e6 + sols.residual)
    return _take(sols, int(torch.argmin(score)))


def _rows(state, control):
    """state and control broadcast to rows (B, ·), and the leading shape."""
    lead = torch.broadcast_shapes(state.shape[:-1], control.shape[:-1])
    return (state.expand(lead + state.shape[-1:]).reshape(
                -1, state.shape[-1]).contiguous(),
            control.expand(lead + control.shape[-1:]).reshape(
                -1, control.shape[-1]).contiguous(), lead)


def continuous_jacobians(params: AircraftParams, state, control):
    """A = ∂f/∂x, B = ∂f/∂u of the continuous dynamics at a point (or at
    each point of leading axes)."""
    x, u, lead = _rows(state, control)
    J = batched_jacfwd(lambda xx, uu: ac.state_derivative(params, xx, uu),
                       x, u)
    J = J.reshape(lead + J.shape[1:])
    return J[..., :x.shape[-1]], J[..., x.shape[-1]:]


def stability_eigenvalues(params: AircraftParams, state, control):
    """Eigenvalues of the continuous-time Jacobian at (state, control),
    decomposed on the host in float64."""
    A, _ = continuous_jacobians(params, state, control)
    return np.linalg.eigvals(A.detach().cpu().numpy().astype(np.float64))


def discrete_jacobians(params: AircraftParams, state, control, dt,
                       substeps: int = 1):
    """A_d = ∂F/∂x, B_d = ∂F/∂u of the RK4 step map F(x, u, dt), over the
    leading axes of state, control and a tensor dt."""
    x, u, lead = _rows(state, control)
    if isinstance(dt, torch.Tensor) and dt.ndim:
        lead = torch.broadcast_shapes(lead, dt.shape)
        x = x.expand(lead + x.shape[-1:]).reshape(-1, x.shape[-1]).clone()
        u = u.expand(lead + u.shape[-1:]).reshape(-1, u.shape[-1]).clone()
        dt = dt.expand(lead).reshape(-1).clone()

    def step(xx, uu):
        return integrators.step(params, xx, uu, dt, substeps=substeps)

    J = batched_jacfwd(step, x, u)
    J = J.reshape(lead + J.shape[1:])
    return J[..., :x.shape[-1]], J[..., x.shape[-1]:]


class DiscreteStabilityReport(NamedTuple):
    """Spectra of the discrete step map around an operating point."""

    eigenvalues: np.ndarray         # (n_perturb, 13) complex
    spectral_radius: np.ndarray     # (n_perturb,) max |eig| per point
    condition_numbers: np.ndarray   # (n_perturb,) cond(A_d) per point
    dt_sweep: np.ndarray            # (n_dt,) time steps of the sweep
    dt_spectral_radius: np.ndarray  # (n_dt,) max |eig| at the nominal point


def perturbation_cloud(state, n_perturb: int = 25, state_delta: float = 0.1,
                       quat_delta: float = 0.01, seed: int = 0) -> np.ndarray:
    """(n_perturb, 13) float32 states: ``state`` offset by a linear ramp
    of ±state_delta in every component, each quaternion replaced by a
    random rotation of quat_delta from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    state = np.asarray(state, dtype=np.float32)
    cloud = np.repeat(state[None], n_perturb, axis=0)
    cloud += np.linspace(-state_delta, state_delta, n_perturb)[:, None]
    for i in range(n_perturb):
        cloud[i, 6:10] = perturb_quaternion(state[6:10], quat_delta, rng=rng)
    return cloud


def discrete_stability_analysis(params: AircraftParams, state, control,
                                dt: float = 0.01, n_perturb: int = 25,
                                state_delta: float = 0.1,
                                quat_delta: float = 0.01, dt_sweep=None,
                                seed: int = 0,
                                device="cuda") -> DiscreteStabilityReport:
    """Eigenvalues and condition numbers of the discrete dynamics over a
    cloud of perturbed states (``perturbation_cloud``), and the spectral
    radius at the nominal point over a log-spaced dt sweep; each cloud is
    one batched Jacobian, the eigendecompositions run on the host."""
    dev = resolve_device(device)
    if params.device != dev:
        params = params.to(dev)
    state_np = np.asarray(torch.as_tensor(state).detach().cpu(), np.float32)
    control = torch.as_tensor(control, dtype=torch.float32, device=dev)
    cloud = torch.as_tensor(perturbation_cloud(
        state_np, n_perturb, state_delta, quat_delta, seed), device=dev)
    A_cloud, _ = discrete_jacobians(params, cloud, control, dt)
    A_cloud = A_cloud.detach().cpu().numpy().astype(np.float64)
    eigs = np.linalg.eigvals(A_cloud)
    if dt_sweep is None:
        dt_sweep = np.logspace(-4, 0, 20)
    dts = torch.as_tensor(np.asarray(dt_sweep, np.float32), device=dev)
    A_dts, _ = discrete_jacobians(params, torch.as_tensor(state_np,
                                                          device=dev),
                                  control, dts)
    dt_radius = np.abs(np.linalg.eigvals(
        A_dts.detach().cpu().numpy().astype(np.float64))).max(axis=-1)
    return DiscreteStabilityReport(
        eigenvalues=eigs, spectral_radius=np.abs(eigs).max(axis=-1),
        condition_numbers=np.linalg.cond(A_cloud),
        dt_sweep=np.asarray(dt_sweep), dt_spectral_radius=dt_radius)
