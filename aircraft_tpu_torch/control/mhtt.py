"""Moving-horizon trajectory tracking (MHTT): the window OCP and the
receding-horizon controller around it.

Track progress s in [0, 1] is an augmented state with dynamics
ṡ = v·t̂(s)/L (+ a position-error correction), so one window is one smooth
iLQR problem over z = [x(13), s] (+ wind(3) when ``wind_channels``).

``MHTT`` is the receding-horizon loop: solve a window, commit its
non-overlap prefix, carry the state, the shifted controls and the gated
duals to the next window on the device, and pull one packed blob of what
the host needs per window.  ``run`` flies one aircraft (pipelined: window
w+1 is dispatched before window w's blob is read); ``run_batch`` and
``run_batch_scan`` advance a batch of scenarios in lockstep.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from aircraft_tpu_torch.config import SolverConfig, TrajectoryConfig
from aircraft_tpu_torch.control.aircraft import envelope_ineq
from aircraft_tpu_torch.control.initialisation import (
    DubinsInitialiser,
    catmull_rom_eval,
    catmull_rom_tangent,
)
from aircraft_tpu_torch.device import resolve_device
from aircraft_tpu_torch.dynamics import aircraft as ac
from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
from aircraft_tpu_torch.ops.elementwise import clip
from aircraft_tpu_torch.solvers import ilqr, integrators
from aircraft_tpu_torch.solvers import ocp as ocp_mod
from aircraft_tpu_torch.solvers.ocp import ALState, OCPFunctions, squash_controls

# loss weights
W_TRACKING = 10.0
W_PROGRESS = 5.0
W_PROGRESS_RATE = 2.0
W_BACKWARD = 50.0
W_TERMINAL_ALIGN = 20.0
W_LOW_VELOCITY = 10.0
W_CONTROL = 100.0 / 100.0


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def build_mhtt_ocp(params: AircraftParams, config: TrajectoryConfig,
                   track_points: torch.Tensor, track_length: float, *,
                   dt: float, substeps: int = 1,
                   progress_correction: float = 0.05,
                   wind_channels: bool = False,
                   track_dims: tuple = (0, 1, 2), v_ref: float = 0.0,
                   w_speed: float = 0.0, w_rate: float = 0.0,
                   alpha_guard_deg: float = 0.0, beta_guard_deg: float = 0.0,
                   envelope_overrides: Optional[dict] = None,
                   stall_guard: tuple = (2.0, 10.0), squash_box: bool = False,
                   tail_damp: Optional[tuple] = None,
                   spec_out: Optional[dict] = None) -> OCPFunctions:
    """The window OCP over z = [x(13), s].  ``track_dims`` restricts the
    tracking error and the progress tangent to the declared objective
    dimensions; ``w_speed`` adds a speed hold at ``v_ref`` plus a stall
    guard; ``w_rate`` damps body rates; the alpha/beta guards add soft
    margins inside the hard envelope rows; ``squash_box`` enforces the
    control box through the tanh reparameterisation; ``tail_damp`` =
    (knot, factor) damps the progress reward past a knot.  ``spec_out``
    receives the resolved formulation constants the window kernels read."""
    dev = params.device
    track_points = torch.as_tensor(track_points, dtype=torch.float32,
                                   device=dev)
    dim_mask = torch.zeros(3, dtype=torch.float32, device=dev)
    dim_mask[list(track_dims)] = 1.0
    step13 = integrators.make_step_fn(params, substeps=substeps,
                                      normalize="step")
    L = float(track_length)
    env_overrides = dict(envelope_overrides or {})
    if squash_box:
        env_overrides["include_control_box"] = False
    env = envelope_ineq(params, config.state, config.control, **env_overrides)

    def progress_rate(z):
        x, s = z[..., :13], z[..., 13]
        tangent = catmull_rom_tangent(track_points, s) / L * dim_mask
        tnorm = _norm(tangent)
        tdir = tangent / torch.where(tnorm > 1e-3, tnorm,
                                     torch.ones_like(tnorm))[..., None]
        s_dot = torch.sum(x[..., 3:6] * tdir, dim=-1) / L
        pos_err = (x[..., 0:3] - catmull_rom_eval(track_points, s)) * dim_mask
        corr = torch.sum(pos_err * tdir, dim=-1) / L
        return s_dot, corr, pos_err

    def step(z, u, k):
        x, s = z[..., :13], z[..., 13]
        s_dot, corr, _ = progress_rate(z)
        # the upper clip sits above 1 so the terminal progress reward keeps
        # a live gradient through s = 1
        s_next = clip(s + s_dot * dt + progress_correction * corr, 0.0, 1.05)
        if wind_channels:
            w = z[..., 14:17]
            x_next = integrators.step(
                params, x, u, dt, substeps=substeps, normalize="step",
                derivative_fn=lambda xx, uu: ac.state_derivative(
                    params, xx, uu, wind=w))
            return torch.cat([x_next, s_next[..., None], w], dim=-1)
        return torch.cat([step13(x, u, dt), s_next[..., None]], dim=-1)

    def stage_residuals(z, u, k):
        """Least-squares part of the stage cost: r with cost 0.5·‖r‖²."""
        x = z[..., :13]
        s_dot, _, pos_err = progress_rate(z)
        speed = _norm(x[..., 3:6])
        zero = torch.zeros_like(speed)
        parts = [
            np.sqrt(2.0 * W_TRACKING) * pos_err,
            (np.sqrt(2.0 * W_BACKWARD) * torch.maximum(zero, -s_dot))[..., None],
            (np.sqrt(2.0 * W_LOW_VELOCITY)
             * torch.maximum(0.1 - speed, zero))[..., None],
            np.sqrt(2.0 * W_CONTROL) * u,
            (np.sqrt(2.0) * torch.maximum(speed - 110.0, zero))[..., None],
        ]
        if w_speed > 0.0:
            parts.append((np.sqrt(2.0 * w_speed) * (speed - v_ref))[..., None])
            parts.append((np.sqrt(2.0 * stall_guard[1] * w_speed)
                          * torch.maximum((v_ref - stall_guard[0]) - speed,
                                          zero))[..., None])
        if w_rate > 0.0:
            parts.append(np.sqrt(2.0 * w_rate) * x[..., 10:13])
        if alpha_guard_deg > 0.0 or beta_guard_deg > 0.0:
            aero = ac.aero_state(params, x, u)
            if alpha_guard_deg > 0.0:
                a_lim = float(np.deg2rad(alpha_guard_deg))
                parts.append((np.sqrt(20.0) * torch.maximum(
                    torch.abs(aero.alpha) - a_lim, zero))[..., None])
            if beta_guard_deg > 0.0:
                b_lim = float(np.deg2rad(beta_guard_deg))
                parts.append((np.sqrt(20.0) * torch.maximum(
                    torch.abs(aero.beta) - b_lim, zero))[..., None])
        return torch.cat(parts, dim=-1)

    def stage_rest(z, u, k):
        """Progress rewards: exact gradient in the Gauss-Newton expansion,
        curvature dropped."""
        s = z[..., 13]
        s_dot, _, _ = progress_rate(z)
        rate_reward = 0.5 * torch.tanh(s_dot / 0.5)
        rest = -W_PROGRESS * s - W_PROGRESS_RATE * rate_reward
        if tail_damp is not None:
            rest = rest * torch.where(ocp_mod.knot_tensor(k, s) >= tail_damp[0],
                                      float(tail_damp[1]), 1.0)
        return rest

    def stage_cost(z, u, k):
        r = stage_residuals(z, u, k)
        return 0.5 * torch.sum(r * r, dim=-1) + stage_rest(z, u, k)

    def terminal_cost(z):
        # align to the track point at the terminal progress achieved
        x, s = z[..., :13], z[..., 13]
        goal = catmull_rom_eval(track_points, s)
        align = _norm((x[..., :3] - goal) * dim_mask + 1e-9)
        return W_TERMINAL_ALIGN * align - W_PROGRESS * 10.0 * s

    def ineq(z, u, k):
        return env(z[..., :13], u, k)

    built = OCPFunctions(step=step, stage_cost=stage_cost,
                         terminal_cost=terminal_cost, ineq=ineq,
                         stage_residuals=stage_residuals,
                         stage_rest=stage_rest)
    if squash_box:
        lb, ub = config.control.bounds(7)
        built, _, _ = squash_controls(built, lb, ub, device=dev)
    if spec_out is not None:
        spec_out.update(
            params=params, track_points=track_points, track_length=L, dt=dt,
            substeps=substeps, progress_correction=progress_correction,
            track_dims=tuple(track_dims), v_ref=v_ref, w_speed=w_speed,
            w_rate=w_rate, alpha_guard_deg=alpha_guard_deg,
            beta_guard_deg=beta_guard_deg, stall_guard=tuple(stall_guard),
            tail_damp=tail_damp, wind_channels=wind_channels,
            envelope=env.resolved, squash_box=squash_box,
            squash_bounds=(config.control.bounds(7) if squash_box else None))
    return built


class MHTTWindow(NamedTuple):
    xs: torch.Tensor          # (N+1, 14) augmented states [x(13), s]
    us: torch.Tensor          # (N, 7)
    cost: torch.Tensor
    violation: torch.Tensor
    converged: torch.Tensor


def start_pull(blob: torch.Tensor):
    """Start copying a window's blob to the host: on the card into pinned
    memory behind the work already queued on the stream, with an event to
    wait on, so the host can queue the next window before it reads this
    one.  Returns the pull for ``finish_pull``."""
    if blob.device.type != "cuda":
        return blob.detach(), None
    host = torch.empty(blob.shape, dtype=blob.dtype, pin_memory=True)
    host.copy_(blob, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def finish_pull(pull) -> np.ndarray:
    """Wait for a pull started by ``start_pull``; the blob as numpy."""
    host, done = pull
    if done is not None:
        done.synchronize()
    return host.numpy()


class MHTT:
    """Receding-horizon controller around one window solve, on ``device``
    (``cuda`` unless the caller asks for the CPU).

    ``fused=None`` takes the two window kernels (``solvers/fused.py``)
    when the device is ``cuda`` and the kernels compute the plant's
    coefficient model, and ``ilqr.solve_batch`` otherwise; ``fused=True``
    on the CPU runs the kernels' plain versions."""

    def __init__(
        self,
        params: AircraftParams,
        config: TrajectoryConfig,
        track: DubinsInitialiser,
        *,
        num_nodes: int = 50,
        dt: float = 0.01,
        overlap: int = 30,
        substeps: int = 1,
        solver_config: Optional[SolverConfig] = None,
        track_dims: Optional[tuple] = None,
        v_ref: Optional[float] = None,
        w_speed: Optional[float] = None,
        w_rate: float = 0.0,
        alpha_guard_deg: float = 0.0,
        beta_guard_deg: float = 0.0,
        envelope_overrides: Optional[dict] = None,
        progress_correction: float = 0.05,
        stall_guard: tuple = (2.0, 10.0),
        dual_carry: bool = True,
        carry_gate: float = 10.0,
        fused: Optional[bool] = None,
        device="cuda",
    ):
        from aircraft_tpu_torch.kernels.window import kernel_coeff_supported

        dev = resolve_device(device)
        if params.device != dev:
            params = params.to(dev)
        if v_ref is None:
            v_ref = float(config.waypoints.default_velocity)
        if track_dims is None:
            # full 3D tracking: the track's z-profile anchors the unstable
            # longitudinal axis (xy-only tracking leaves the phugoid free)
            track_dims = (0, 1, 2)
        if w_speed is None:
            # a speed hold only when the vertical axis is untracked
            w_speed = 0.5 if 2 not in track_dims else 0.0
        self.device = dev
        self.params = params
        self.config = config
        self.track = track
        self.N = num_nodes
        self.dt = dt
        self.overlap = overlap
        self.commit = num_nodes - overlap
        self.solver_config = solver_config or SolverConfig(
            max_al_iters=2, max_inner_iters=12, hessian="gauss_newton",
            reg_escalate=100.0)
        self._spec = {}
        self.ocp = build_mhtt_ocp(
            params, config, track.track_points, track.length(), dt=dt,
            substeps=substeps, track_dims=track_dims, v_ref=v_ref,
            w_speed=w_speed, w_rate=w_rate, alpha_guard_deg=alpha_guard_deg,
            beta_guard_deg=beta_guard_deg,
            envelope_overrides=envelope_overrides,
            progress_correction=progress_correction, stall_guard=stall_guard,
            spec_out=self._spec)
        if fused is None:
            fused = dev.type == "cuda" and kernel_coeff_supported(params)
        self.fused = bool(fused)
        if self.fused:
            from aircraft_tpu_torch.solvers.fused import make_fused_solver

            self._fused_solve = make_fused_solver(
                self.ocp, self._spec, num_nodes, self.solver_config)
        else:
            self._fused_solve = None
        self.dual_carry = dual_carry
        # a window whose violation exceeds the gate hands cold duals to the
        # next window: its multipliers were integrating a transient
        self.carry_gate = carry_gate
        # cold multipliers: zero duals at the initial penalty, a batch of one
        self._al0 = ocp_mod.init_al_state(
            self.ocp, torch.zeros(1, 14, device=dev),
            torch.zeros(1, 7, device=dev), num_nodes,
            mu0=self.solver_config.penalty_init)

    # -- window solves --------------------------------------------------

    def _solve(self, z0s, us, al=None):
        """One window solve of the reference path (``ilqr.solve_impl``)."""
        return ilqr.solve_impl(self.ocp, z0s, us, self.solver_config,
                               al_init=al)

    def _solve_batch(self, z0s, us, al=None):
        if self.fused:
            return self._fused_solve(z0s, us, al)
        return ilqr.solve_batch(self.ocp, z0s, us, self.solver_config,
                                al_inits=al)

    def _shift_al(self, al: ALState, violation) -> ALState:
        """Shift the multipliers by the committed prefix, restart the
        penalty, cold duals past the carry gate."""
        return ocp_mod.shift_al_state(
            al, self.commit, mu0=self.solver_config.penalty_init,
            decay=ocp_mod.gated_decay(violation, self.carry_gate))

    def _commit(self, sols, b):
        """The carry (z, us, AL duals) of scenario ``b`` (a (1,) index
        tensor) of ``sols`` and its packed host blob
        ``[xs[1:c+1, :14] | us[:c] | cost, violation, finite, s_next]``."""
        c = self.commit
        xs, us = sols.xs.index_select(0, b)[0], sols.us.index_select(0, b)[0]
        cost = sols.cost.index_select(0, b)
        viol = sols.violation.index_select(0, b)
        z_next = xs[c]
        us_next = torch.cat([us[c:], us[-1:].expand(c, -1)], dim=0)
        al_next = self._shift_al(sols.al.index(b), viol)
        finite = torch.isfinite(xs).all().to(torch.float32)[None]
        blob = torch.cat([xs[1:c + 1, :14].reshape(-1), us[:c].reshape(-1),
                          cost, viol, finite, xs[c, 13:14]])
        return z_next, us_next.contiguous(), al_next, blob

    def _serve_step(self, z0, us, al):
        """One window solve from z0 (14,), us (N, 7) and the multipliers
        ``al`` (a batch of one); returns the carry and the blob's pull.
        The carry never leaves the device."""
        sols = self._solve_batch(z0[None], us[None],
                                 al if self.dual_carry else None)
        z, us_n, al_n, blob = self._commit(
            sols, torch.zeros(1, dtype=torch.int64, device=self.device))
        return z, us_n, al_n, start_pull(blob)

    def _serve_step_multi(self, z0, us_carry, us_reset, al, n_candidates):
        """One window solved from up to six warm starts as one batch (the
        shifted carry, the clean reset, three blends of the two, a damped
        carry); commits the best by cost + 100·violation, non-finite
        candidates last.  The clean reset starts from cold duals, the
        others from the carried ones."""
        candidates = [
            us_carry,
            us_reset,
            0.5 * (us_carry + us_reset),
            0.25 * us_carry + 0.75 * us_reset,
            0.75 * us_carry + 0.25 * us_reset,
            0.5 * us_carry + 0.5 * torch.mean(us_carry, dim=0, keepdim=True),
        ]
        us_stack = torch.stack(candidates[:n_candidates]).contiguous()
        nc = us_stack.shape[0]
        z_stack = z0[None].expand(nc, -1).contiguous()
        al_stack = (ALState.cat([al, self._al0, al, al, al, al][:nc])
                    if self.dual_carry else None)
        sols = self._solve_batch(z_stack, us_stack, al_stack)
        finite = torch.isfinite(sols.xs).flatten(1).all(dim=1)
        inf = torch.full_like(sols.cost, float("inf"))
        score = (torch.nan_to_num(sols.cost, nan=float("inf"))
                 + 100.0 * torch.nan_to_num(sols.violation, nan=float("inf"))
                 + torch.where(finite, torch.zeros_like(inf), inf))
        b = torch.argmin(score).reshape(1)
        z, us_n, al_n, blob = self._commit(sols, b)
        return z, us_n, al_n, start_pull(blob)

    def _al0_batch(self, B: int) -> ALState:
        """Cold multipliers tiled over a scenario batch."""
        return self._al0.index(torch.zeros(B, dtype=torch.int64))

    def diagnose_window(self, z0, us) -> dict:
        """Post-mortem of one window solve: re-solves the window for the
        whole solution (the serving path only pulls a blob) and reports the
        active constraints with their duals, Quu conditioning, defects and
        envelope traces (``observability.diagnose``).  One extra solve,
        off the hot path."""
        from aircraft_tpu_torch import observability as obs
        from aircraft_tpu_torch.control.aircraft import envelope_registry

        f32 = lambda t: torch.as_tensor(t, dtype=torch.float32,
                                        device=self.device)
        sol = self._solve(f32(z0)[None], f32(us)[None])
        report = obs.diagnose(sol, self.ocp, registry=envelope_registry(),
                              params=self.params)
        report["text"] = obs.format_diagnosis(report)
        return report

    def solve_window(self, x0, s0: float, us_init) -> MHTTWindow:
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=self.device)
        z0 = torch.cat([x0, x0.new_tensor([s0])])
        us = torch.as_tensor(us_init, dtype=torch.float32, device=self.device)
        sol = self._solve(z0[None], us[None])
        return MHTTWindow(xs=sol.xs[0], us=sol.us[0], cost=sol.cost[0],
                          violation=sol.violation[0],
                          converged=sol.converged[0])

    # -- closed loops ---------------------------------------------------

    def _batch_start(self, x0s, s0s):
        x = torch.as_tensor(x0s, dtype=torch.float32, device=self.device)
        B = x.shape[0]
        s = (torch.zeros(B, device=self.device) if s0s is None
             else torch.as_tensor(s0s, dtype=torch.float32,
                                  device=self.device))
        us = torch.zeros((B, self.N, 7), device=self.device)
        al = self._al0_batch(B) if self.dual_carry else None
        return x, s, us, al

    def _batch_window(self, solve, x, s, us, al):
        """One lockstep window of a scenario batch: solve, commit, shift."""
        c = self.commit
        sols = solve(torch.cat([x, s[:, None]], dim=-1), us, al)
        x = sols.xs[:, c, :13]
        s = torch.maximum(s, sols.xs[:, c, 13])
        us = torch.cat([sols.us[:, c:], sols.us[:, -1:].expand(-1, c, -1)],
                       dim=1).contiguous()
        if self.dual_carry:
            al = self._shift_al(sols.al, sols.violation)
        return x, s, us, al

    def run_batch(self, x0s, *, s0s=None, max_windows: int = 50,
                  progress_target: float = 0.99) -> dict:
        """Closed-loop receding-horizon MPC over a scenario batch (B, 13):
        every scenario replans in lockstep, each window one batched solve;
        finished scenarios keep solving with their progress held, so the
        batch keeps its shape.  Stops when every scenario reaches
        ``progress_target`` or after ``max_windows``."""
        x, s, us, al = self._batch_start(x0s, s0s)
        windows = 0
        progress_hist = [s.cpu().numpy()]
        while (windows < max_windows
               and float(torch.min(s)) < progress_target):
            x, s, us, al = self._batch_window(self._solve_batch, x, s, us, al)
            windows += 1
            progress_hist.append(s.cpu().numpy())
        s_np = s.cpu().numpy()
        return {
            "progress": s_np,
            "windows": windows,
            "success_rate": float(np.mean(s_np >= progress_target)),
            "progress_history": np.stack(progress_hist),
        }

    def run_batch_scan(self, x0s, n_windows: int, *, s0s=None) -> dict:
        """``n_windows`` lockstep windows with no host read between them:
        solve, commit and shift all stay on the device, and the progress
        history comes back once at the end.  The windows run
        ``ilqr.solve_batch`` whatever ``fused`` says."""
        def solve(z0s, us, al):
            return ilqr.solve_batch(self.ocp, z0s, us, self.solver_config,
                                    al_inits=al)

        x, s, us, al = self._batch_start(x0s, s0s)
        s_hist = []
        for _ in range(n_windows):
            x, s, us, al = self._batch_window(solve, x, s, us, al)
            s_hist.append(s)
        s_np = s.cpu().numpy()
        return {
            "progress": s_np,
            "windows": n_windows,
            "success_rate": float(np.mean(s_np >= 0.99)),
            "progress_history": torch.stack(s_hist).cpu().numpy(),
            "final_states": x.cpu().numpy(),
        }

    def run(
        self,
        x0,
        *,
        s0: float = 0.0,
        max_windows: int = 200,
        progress_target: float = 0.99,
        us_init=None,
        verbose: bool = False,
        recorder=None,
        abort_violation: float = 50.0,
        abort_patience: int = 2,
        n_candidates: int = 1,
        pipeline: bool = True,
        diagnose_on_abort: bool = True,
    ) -> dict:
        """Closed-loop MPC of one aircraft until the track is consumed.
        ``us_init`` seeds the first window (e.g. trim controls over the
        horizon).

        ``recorder``: a ``native.telemetry.TelemetryRecorder`` of
        ``FLIGHT_REC_FLOATS``-wide records; each committed window is
        pushed without blocking the loop.

        Abort policy: non-finite states abort at once; a window whose
        violation exceeds ``abort_violation`` aborts only after
        ``abort_patience`` such windows in a row.  Retry policy: such a
        window is solved once more from the clean ``us_init`` with cold
        duals, and the better of the two is committed.
        ``n_candidates > 1`` (with ``us_init``) solves every window from
        up to 6 warm starts as one batch and commits the best.

        ``pipeline`` (default on): window w+1 is dispatched from the
        carry on the device before window w's blob is read, so the blob's
        copy, the host's bookkeeping and the telemetry push overlap the
        next solve.  The commits are the synchronous loop's, bit for bit;
        a retry or an abort discards at most one speculative solve."""
        dev = self.device
        f32 = lambda t: torch.as_tensor(t, dtype=torch.float32, device=dev)
        us = torch.zeros((self.N, 7), device=dev) if us_init is None else f32(us_init)
        us_reset = None if us_init is None else f32(us_init)
        x = f32(x0)
        z = torch.cat([x, x.new_tensor([s0])])
        s = float(s0)
        c = self.commit

        committed_states = [x.cpu().numpy()]
        committed_controls = []
        windows = 0
        success = True
        viol_streak = 0
        retries = 0
        abort_reason = None
        diagnosis = None
        window_walls = []
        t_prev = time.perf_counter()
        verbose_every = 1 if (isinstance(verbose, int) and verbose > 1) else 10
        al = self._al0

        def dispatch(z_c, us_c, al_c):
            if n_candidates > 1 and us_reset is not None:
                return self._serve_step_multi(z_c, us_c, us_reset, al_c,
                                              min(int(n_candidates), 6))
            return self._serve_step(z_c, us_c, al_c)

        # a call that would not enter the loop pays no window solve
        pending = (dispatch(z, us, al)
                   if pipeline and s < progress_target and max_windows > 0
                   else None)

        while s < progress_target and windows < max_windows:
            if pipeline:
                z_new, us_new, al_new, pull = pending
                # dispatch the next window from this one's carry on the
                # device, then read this one's blob
                pending = dispatch(z_new, us_new, al_new)
            else:
                z_new, us_new, al_new, pull = dispatch(z, us, al)
            host = finish_pull(pull)
            # blob tail: [cost, violation, finite, s_next]
            if (n_candidates <= 1 and us_reset is not None
                    and host[-3] > abort_violation):
                # bounded retry from the clean warm start and cold duals
                z_r, us_r, al_r, pull_r = self._serve_step(z, us_reset,
                                                           self._al0)
                host_r = finish_pull(pull_r)
                if host_r[-3] < host[-3]:
                    z_new, us_new, al_new, host = z_r, us_r, al_r, host_r
                    retries += 1
                    if pipeline:
                        # the speculative dispatch used the rejected carry
                        pending = dispatch(z_new, us_new, al_new)
            xs14 = host[: c * 14].reshape(c, 14)
            us_c = host[c * 14: c * 21].reshape(c, 7)
            cost, violation, finite, s_next = host[-4:]
            if verbose and windows % verbose_every == 0:
                v = float(np.linalg.norm(xs14[-1, 3:6]))
                x_h = (committed_states[-1][-1] if windows
                       else committed_states[0])
                print(f"  window {windows}: s={s:.3f} viol={violation:.2f} "
                      f"pos=({x_h[0]:.0f},{x_h[1]:.0f},{x_h[2]:.0f}) "
                      f"v={v:.1f}", flush=True)
            # abort on divergence or on persistent gross infeasibility
            if finite != 1.0:
                success = False
                abort_reason = "divergence"
                if diagnose_on_abort:
                    diagnosis = self.diagnose_window(z, us)
                break
            viol_streak = viol_streak + 1 if violation > abort_violation else 0
            if viol_streak >= abort_patience:
                success = False
                abort_reason = (f"violation_streak ({viol_streak} windows > "
                                f"{abort_violation}, last {violation:.1f})")
                if diagnose_on_abort:
                    diagnosis = self.diagnose_window(z, us)
                break
            committed_controls.append(us_c)
            committed_states.append(xs14[:, :13])
            if recorder is not None:
                from aircraft_tpu_torch.native.telemetry import flight_records

                recorder.push(flight_records(
                    windows, xs14[:, :13], us_c, xs14[:, 13], float(cost),
                    float(violation)))
            z, us, al = z_new, us_new, al_new
            s = float(s_next)
            windows += 1
            t_now = time.perf_counter()
            window_walls.append(t_now - t_prev)
            t_prev = t_now

        states = (np.concatenate([np.atleast_2d(committed_states[0])]
                                 + committed_states[1:], axis=0)
                  if committed_controls else np.atleast_2d(x.cpu().numpy()))
        return {
            "states": states,
            "controls": (np.concatenate(committed_controls, axis=0)
                         if committed_controls else np.zeros((0, 7))),
            "progress": s,
            "windows": windows,
            "success": success and s >= progress_target,
            "abort_reason": abort_reason,
            "diagnosis": diagnosis,
            "retries": retries,
            # window 0 carries the first use's set-up (kernel builds)
            "window_walls_s": window_walls,
            "first_window_wall_s": window_walls[0] if window_walls else None,
            "p50_window_wall_s": (float(np.percentile(window_walls[1:], 50))
                                  if len(window_walls) > 1 else None),
            "p90_window_wall_s": (float(np.percentile(window_walls[1:], 90))
                                  if len(window_walls) > 1 else None),
        }
