"""DDPG training against the 6-DoF glider dynamics.

The agent (``rl/ddpg.py``) flies the default-aero glider from the
configuration's initial state toward a goal ahead of it, the distance
set by the curriculum's stage; the environment step is the solvers' own
plant step (``integrators.make_step_fn``, RK4, 2 substeps of dt 0.02).
Rewards are progress toward the goal less 0.01·|a|²; training starts
once the replay buffer holds more than 1000 transitions.

    python -m aircraft_tpu_torch.examples.train_ddpg [--episodes 50]
        [--steps 150] [--device cuda]

Prints one line per episode, then one JSON record (``device`` holding
the card's name and power limit).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from aircraft_tpu_torch.config import glider_config
from aircraft_tpu_torch.device import resolve_device
from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
from aircraft_tpu_torch.rl import (CurriculumLearning, DDPGAgent, OUNoise,
                                   ReplayBuffer)
from aircraft_tpu_torch.solvers import integrators


def make_env(params, dt=0.02, substeps=2):
    """``env_step(x, action) -> x_next``: the three surface deflections
    of ``action`` (aileron, elevator, rudder) on the plant's step, the
    other controls 0; x and x_next numpy."""
    step = integrators.make_step_fn(params, substeps=substeps,
                                    normalize="step")
    dev = params.device

    def env_step(x, action):
        u = torch.zeros(7, device=dev)
        u[:3] = torch.as_tensor(np.asarray(action, np.float32), device=dev)
        with torch.no_grad():
            x_next = step(torch.as_tensor(np.asarray(x, np.float32),
                                          device=dev), u, dt)
        return x_next.cpu().numpy()

    return env_step


def obs_from_state(x, goal):
    x = np.asarray(x)
    return np.concatenate([
        (goal - x[:3]) / 100.0, x[3:6] / 50.0, x[6:10], x[10:13],
    ]).astype(np.float32)


def run(episodes=50, steps=150, *, device="cuda", log=print) -> dict:
    """Train for ``episodes`` episodes of at most ``steps`` steps; returns
    the record (returns, final distances, updates, walls)."""
    from aircraft_tpu_torch.bench import _card

    dev = resolve_device(device)
    t0 = time.perf_counter()
    cfg = glider_config()
    params = AircraftParams.from_config(cfg.aircraft, device=dev)
    env_step = make_env(params)
    rng = np.random.default_rng(0)

    agent = DDPGAgent(obs_dim=13, act_dim=3, action_scale=5.0, seed=0,
                      device=dev)
    buf = ReplayBuffer(100_000, 13, 3, device=dev)
    noise = OUNoise(3, sigma=0.3, rng=rng)
    curriculum = CurriculumLearning()

    x_init = np.asarray(cfg.waypoints.initial_state, np.float32)
    returns, finals, updates, n_steps = [], [], 0, 0
    for ep in range(episodes):
        stage = curriculum.stage
        goal = x_init[:3] + np.array([stage.goal_distance, 0.0, 0.0])
        x = x_init.copy()
        noise.reset()
        total_r, prev_d = 0.0, np.linalg.norm(goal - x[:3])
        for t in range(steps):
            o = obs_from_state(x, goal)
            a = agent.act(o, noise=noise.sample())
            x_next = env_step(x, a)
            n_steps += 1
            if not np.all(np.isfinite(x_next)):
                buf.add(o, a, -50.0, o * 0, True)
                break
            d = np.linalg.norm(goal - x_next[:3])
            r = (prev_d - d) - 0.01 * float(np.sum(a**2))  # progress reward
            done = d < 10.0
            buf.add(o, a, r, obs_from_state(x_next, goal), done)
            total_r += r
            x, prev_d = x_next, d
            if done:
                break
            if buf.size > 1000:
                agent.train_step(buf.sample(rng, 64))
                updates += 1
        success = prev_d < 25.0 or stage.goal_distance == 0.0
        advanced = curriculum.record(success)
        returns.append(float(total_r))
        finals.append(float(prev_d))
        log(f"ep {ep:3d} stage={stage.name:13s} return={total_r:8.2f} "
            f"final_d={prev_d:7.1f}{'  -> advanced' if advanced else ''}")
    wall = time.perf_counter() - t0
    return {"experiment": "train_ddpg", "device": _card(dev),
            "episodes": episodes, "env_steps": n_steps, "updates": updates,
            "returns": returns, "final_distances": finals,
            "stage": curriculum.stage.name, "wall_s": round(wall, 3)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--episodes", type=int, default=50)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rec = run(args.episodes, args.steps, device=args.device,
              log=lambda line: print(line, flush=True))
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
