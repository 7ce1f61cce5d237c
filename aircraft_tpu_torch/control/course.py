"""Full-course waypoint traversal, the flagship closed-loop flight.

``solve_full_course`` flies the configured waypoint course closed loop:

  1. trim at the initial state's speed (an off-trim seed excites the
     phugoid and stalls the first window);
  2. a Dubins track through the waypoints' xy sequence, turn radii sized
     for the flight speed, the z-profile laid on the plant's achievable
     glide slope for 2D objectives (``course_track``);
  3. receding-horizon ``MHTT`` with full 3D tracking and the stall guards
     (``COURSE_OCP_KNOBS``);
  4. waypoint passage checked over the declared objective dimensions and
     tolerance (``waypoint_misses``).

Every commit is a step of the plant itself, so the misses are flown.

    python -m aircraft_tpu_torch.control.course [--device cpu]
        [--max-windows 400]

flies it and prints one JSON line of the flight's numbers.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np
import torch

from aircraft_tpu_torch.config import SolverConfig, TrajectoryConfig
from aircraft_tpu_torch.control.initialisation import DubinsInitialiser
from aircraft_tpu_torch.device import resolve_device
from aircraft_tpu_torch.dynamics.aircraft import AircraftParams


def waypoint_misses(states: np.ndarray, config: TrajectoryConfig) -> list:
    """Ordered closest-approach distances over the declared objective
    dimensions: each waypoint is searched only from the previous one's
    passage knot on."""
    dims = [i for i in config.waypoints.waypoint_indices if i < 3]
    wps = np.asarray(config.waypoints.array())
    prev = 0
    out = []
    for w in wps:
        d = np.linalg.norm(states[:, dims] - w[dims], axis=1)
        d[:prev] = np.inf
        k = int(np.argmin(d))
        out.append(float(d[k]))
        prev = k
    return out


def course_track(config: TrajectoryConfig, *, v_ref: float,
                 v0_init: Optional[float] = None, glide_ld: float = 13.0,
                 r_min: Optional[float] = None, r_min_per_segment=None,
                 track_extend: float = 150.0,
                 n_track_points: int = 512) -> DubinsInitialiser:
    """Reference track of the course recipe: a flyable glide z-profile for
    2D objectives, turn radii sized for the flight speed with a wide first
    turnaround, and a straight run-out past the final waypoint."""
    two_d = len([i for i in config.waypoints.waypoint_indices if i < 3]) < 3
    x0_np = np.asarray(config.waypoints.initial_state, dtype=np.float32)
    if v0_init is None:
        v0_init = float(np.linalg.norm(x0_np[3:6]))
    if r_min is None:
        r_min = (v_ref + 4.0) ** 2 / 9.81
    if (r_min_per_segment is None and two_d
            and len(config.waypoints.waypoints) > 1):
        r_fast = (0.8 * max(v0_init, v_ref)) ** 2 / 9.81
        r_slow = max((v_ref + 6.0) ** 2 / 9.81, 80.0)
        pts = config.waypoints.all_points()
        diffs = np.diff(pts[:, :2], axis=0)
        seg_psi = np.arctan2(diffs[:, 1], diffs[:, 0])
        psi_prev = (float(np.arctan2(x0_np[4], x0_np[3]))
                    if np.hypot(x0_np[3], x0_np[4]) > 1e-6 else seg_psi[0])
        r_min_per_segment = []
        first_rev_seen = False
        for i in range(len(seg_psi)):
            turn = np.arctan2(np.sin(seg_psi[i] - psi_prev),
                              np.cos(seg_psi[i] - psi_prev))
            if abs(turn) > np.pi / 2 and not first_rev_seen:
                r_min_per_segment.append(r_fast)
                first_rev_seen = True
            else:
                r_min_per_segment.append(r_slow)
            psi_prev = seg_psi[i]

    return DubinsInitialiser(
        config, r_min=r_min, n_track_points=n_track_points,
        z_mode="glide" if two_d else "waypoints", glide_ld=glide_ld,
        r_min_per_segment=r_min_per_segment, extend=track_extend)


# MHTT/OCP knobs of the course recipe
COURSE_OCP_KNOBS = dict(
    w_speed=0.2, w_rate=0.2, alpha_guard_deg=10.0, beta_guard_deg=9.0,
    progress_correction=0.10, stall_guard=(0.0, 20.0),
    envelope_overrides={
        "speed_bounds": (20.0, 100.0),
        "alpha_limit_deg": 20.0,
        "beta_limit_deg": 10.0,
    },
)


def _course_uses_fused(params, device) -> bool:
    """MHTT's choice of solver (the window kernels on ``cuda`` for the
    models they compute), so the inner budget matches the solver that
    runs."""
    from aircraft_tpu_torch.kernels.window import kernel_coeff_supported

    return (resolve_device(device).type == "cuda"
            and kernel_coeff_supported(params))


def build_course_mhtt(
    config: TrajectoryConfig,
    params: Optional[AircraftParams] = None,
    *,
    v_ref: Optional[float] = None,
    glide_ld: float = 13.0,
    r_min: Optional[float] = None,
    num_nodes: int = 30,
    dt: float = 0.05,
    substeps: int = 5,
    overlap: int = 20,
    solver_config: Optional[SolverConfig] = None,
    progress_correction: float = 0.10,
    stall_guard: tuple = (0.0, 20.0),
    r_min_per_segment=None,
    track_extend: float = 150.0,
    dual_carry: bool = True,
    device="cuda",
):
    """The course's controller (steps 2-3 of the module docstring):
    returns (mhtt, track, v_ref).  On ``cuda`` it runs the window kernels
    for the models they compute, at 4 AL rounds x 20 inner iterations."""
    from aircraft_tpu_torch.control.mhtt import MHTT

    dev = resolve_device(device)
    if params is None:
        params = AircraftParams.from_config(config.aircraft, device=dev)
    two_d = len([i for i in config.waypoints.waypoint_indices if i < 3]) < 3
    v0 = float(np.linalg.norm(np.asarray(config.waypoints.initial_state,
                                         np.float32)[3:6]))
    if v_ref is None:
        # 2D glide-limit courses settle just above the envelope floor
        # (20 m/s -> hold 22); 3D objectives track the cruise speed
        v_ref = 22.0 if two_d else float(config.waypoints.default_velocity) + 1.0
    track = course_track(config, v_ref=v_ref, v0_init=v0, glide_ld=glide_ld,
                         r_min=r_min, r_min_per_segment=r_min_per_segment,
                         track_extend=track_extend)
    fused = _course_uses_fused(params, dev)
    mhtt = MHTT(
        params, config, track, num_nodes=num_nodes, dt=dt, overlap=overlap,
        substeps=substeps, v_ref=v_ref,
        **{**COURSE_OCP_KNOBS, "progress_correction": progress_correction,
           "stall_guard": stall_guard},
        # inner budget: the window kernels fly the course at 20; the
        # reference path on the card needs 30 at the turnarounds
        solver_config=solver_config or SolverConfig(
            max_al_iters=4,
            max_inner_iters=20 if fused or dev.type != "cuda" else 30,
            hessian="gauss_newton"),
        # the carry is violation-gated (MHTT.carry_gate), so infeasible
        # windows hand cold duals forward
        dual_carry=dual_carry, device=dev)
    return mhtt, track, v_ref


def solve_full_course(
    config: TrajectoryConfig,
    params: Optional[AircraftParams] = None,
    *,
    v_ref: Optional[float] = None,
    glide_ld: float = 13.0,
    r_min: Optional[float] = None,
    num_nodes: int = 30,
    dt: float = 0.05,
    substeps: int = 5,
    overlap: int = 20,
    max_windows: int = 400,
    solver_config: Optional[SolverConfig] = None,
    trim_starts: int = 32,
    trim_cloud: Optional[torch.Tensor] = None,
    verbose: bool = False,
    progress_correction: float = 0.10,
    stall_guard: tuple = (0.0, 20.0),
    r_min_per_segment=None,
    track_extend: float = 150.0,
    abort_patience: int = 3,
    n_candidates: Optional[int] = None,
    dual_carry: bool = True,
    device="cuda",
) -> dict:
    """Fly the configured waypoint course closed loop on ``device``;
    returns the flown trajectory, the per-waypoint misses and success over
    the declared tolerance, with the replan cadence.  The trim starts are
    ``trim_cloud`` (S, 12) or ``trim_starts`` draws of a
    ``torch.Generator`` seeded 0.  On ``cuda`` every window is solved from
    6 warm starts as one batch (``build_course_mhtt`` has the budget); on
    the CPU from one."""
    from aircraft_tpu_torch.solvers.trim import multistart_trim

    dev = resolve_device(device)
    mhtt, track, v_ref = build_course_mhtt(
        config, params, v_ref=v_ref, glide_ld=glide_ld, r_min=r_min,
        num_nodes=num_nodes, dt=dt, substeps=substeps, overlap=overlap,
        solver_config=solver_config, progress_correction=progress_correction,
        stall_guard=stall_guard, r_min_per_segment=r_min_per_segment,
        track_extend=track_extend, dual_carry=dual_carry, device=dev)
    params = mhtt.params
    x0_np = np.asarray(config.waypoints.initial_state, dtype=np.float32)
    v0 = float(np.linalg.norm(x0_np[3:6]))
    x0 = torch.as_tensor(x0_np, device=dev)
    if trim_cloud is None:
        trim = multistart_trim(params, n_starts=trim_starts,
                               target_airspeed=max(v0, v_ref),
                               generator=torch.Generator().manual_seed(0))
    else:
        trim = multistart_trim(params, trim_cloud,
                               target_airspeed=max(v0, v_ref))
    us0 = trim.control[:7].to(torch.float32)[None].expand(num_nodes, 7)

    # stop just past the final waypoint, not at the end of the run-out
    target_s = 1.0 - 0.7 * track_extend / max(track.total_length, 1.0)
    # candidates: a batch of 6 warm starts costs the card little more than
    # one, and removes the turnaround windows' sensitivity to the carry
    if n_candidates is None:
        n_candidates = 6 if dev.type == "cuda" else 1
    out = mhtt.run(x0, max_windows=max_windows, progress_target=target_s,
                   us_init=us0.contiguous(), verbose=verbose,
                   abort_patience=abort_patience, n_candidates=n_candidates)
    states = np.asarray(out["states"])
    misses = waypoint_misses(states, config)
    tol = float(config.waypoints.tolerance)
    speeds = np.linalg.norm(states[:, 3:6], axis=1)
    return {
        "states": states,
        "controls": np.asarray(out["controls"]),
        "progress": out["progress"],
        "windows": out["windows"],
        "abort_reason": out.get("abort_reason"),
        "retries": out.get("retries"),
        "track": track,
        "trim": trim,
        "misses": misses,
        # the objective is waypoint passage; "mpc_healthy" says whether the
        # closed loop itself ran to its progress target
        "success": all(m < tol for m in misses)
        and bool(np.isfinite(states).all()),
        "mpc_healthy": bool(out["success"]),
        "tolerance": tol,
        "speed_range": (float(speeds.min()), float(speeds.max())),
        "final_altitude": float(-states[-1, 2]),
        "first_window_wall_s": out.get("first_window_wall_s"),
        "p50_window_wall_s": out.get("p50_window_wall_s"),
        "p90_window_wall_s": out.get("p90_window_wall_s"),
        "window_walls_s": out.get("window_walls_s"),
    }


def main(argv=None) -> None:
    from aircraft_tpu_torch.config import glider_config

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--max-windows", type=int, default=400)
    p.add_argument("--verbose", action="store_true")
    a = p.parse_args(argv)
    out = solve_full_course(glider_config(), max_windows=a.max_windows,
                            verbose=a.verbose, device=a.device)
    walls = np.asarray(out["window_walls_s"] or [0.0])
    print(json.dumps({
        "windows": out["windows"], "retries": out["retries"],
        "abort_reason": out["abort_reason"], "misses_m": out["misses"],
        "tolerance_m": out["tolerance"], "success": out["success"],
        "mpc_healthy": out["mpc_healthy"], "progress": float(out["progress"]),
        "speed_range": out["speed_range"],
        "final_altitude": out["final_altitude"],
        "first_window_wall_s": out["first_window_wall_s"],
        "p50_window_wall_s": out["p50_window_wall_s"],
        "p90_window_wall_s": out["p90_window_wall_s"],
        "flight_wall_s": float(walls.sum()),
        "finite": bool(np.isfinite(out["states"]).all()),
        "device": (torch.cuda.get_device_name() if
                   resolve_device(a.device).type == "cuda" else "cpu"),
    }))


if __name__ == "__main__":
    main()
