"""Classical PID attitude control: a scalar PID and a roll/pitch
attitude hold around the 6-DoF plant, with a closed-loop episode."""

from __future__ import annotations

from typing import NamedTuple

import torch

from aircraft_tpu_torch.device import resolve_device
from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
from aircraft_tpu_torch.ops import quaternion as quat
from aircraft_tpu_torch.solvers import integrators


class PIDState(NamedTuple):
    integral: torch.Tensor
    prev_error: torch.Tensor


class PIDGains(NamedTuple):
    kp: float
    ki: float
    kd: float
    limit: float = 5.0


def pid_init(dim: int = 1, device="cuda") -> PIDState:
    dev = resolve_device(device)
    return PIDState(integral=torch.zeros(dim, device=dev),
                    prev_error=torch.zeros(dim, device=dev))


def pid_step(gains: PIDGains, state: PIDState, error: torch.Tensor,
             dt) -> tuple[torch.Tensor, PIDState]:
    """One PID update: (output, new state).  The integral is clamped to
    what saturates the output (anti-windup)."""
    i_lim = gains.limit / max(gains.ki, 1e-9)
    integral = torch.clamp(state.integral + error * dt, -i_lim, i_lim)
    deriv = (error - state.prev_error) / dt
    out = gains.kp * error + gains.ki * integral + gains.kd * deriv
    out = torch.clamp(out, -gains.limit, gains.limit)
    return out, PIDState(integral=integral, prev_error=error)


class AttitudePIDState(NamedTuple):
    roll: PIDState
    pitch: PIDState


def attitude_pid_init(device="cuda") -> AttitudePIDState:
    return AttitudePIDState(roll=pid_init(device=device),
                            pitch=pid_init(device=device))


DEFAULT_ROLL_GAINS = PIDGains(kp=2.0, ki=0.1, kd=0.5)
DEFAULT_PITCH_GAINS = PIDGains(kp=4.0, ki=0.2, kd=1.0)


def attitude_pid_control(x: torch.Tensor, pid_state: AttitudePIDState,
                         roll_target, pitch_target, dt,
                         roll_gains: PIDGains = DEFAULT_ROLL_GAINS,
                         pitch_gains: PIDGains = DEFAULT_PITCH_GAINS
                         ) -> tuple[torch.Tensor, AttitudePIDState]:
    """Roll and pitch hold of one aircraft: aileron from the roll error,
    elevator (sign flipped) from the pitch error."""
    eul = quat.to_euler(x[..., 6:10])
    roll_err = torch.atleast_1d(roll_target - eul[..., 0])
    pitch_err = torch.atleast_1d(pitch_target - eul[..., 1])
    aileron, roll_state = pid_step(roll_gains, pid_state.roll, roll_err, dt)
    elevator, pitch_state = pid_step(pitch_gains, pid_state.pitch,
                                     pitch_err, dt)
    u = torch.zeros(x.shape[:-1] + (7,), dtype=x.dtype, device=x.device)
    u[..., 0] = aileron[..., 0]
    u[..., 1] = -elevator[..., 0]
    return u, AttitudePIDState(roll=roll_state, pitch=pitch_state)


def simulate_pid(params: AircraftParams, x0, roll_targets, pitch_targets,
                 dt: float, substeps: int = 5, device="cuda"
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """A closed-loop PID episode of T = len(roll_targets) steps: (states
    (T+1, 13), controls (T, 7))."""
    dev = resolve_device(device)
    if params.device != dev:
        params = params.to(dev)
    step = integrators.make_step_fn(params, substeps=substeps,
                                    normalize="step")
    x = torch.as_tensor(x0, dtype=torch.float32, device=dev)
    targets = torch.stack([torch.as_tensor(roll_targets, dtype=torch.float32),
                           torch.as_tensor(pitch_targets,
                                           dtype=torch.float32)],
                          dim=-1).to(dev)
    pid_state = attitude_pid_init(dev)
    xs, us = [x], []
    for k in range(targets.shape[0]):
        u, pid_state = attitude_pid_control(x, pid_state, targets[k, 0],
                                            targets[k, 1], dt)
        x = step(x, u, dt)
        xs.append(x)
        us.append(u)
    return torch.stack(xs), torch.stack(us)
