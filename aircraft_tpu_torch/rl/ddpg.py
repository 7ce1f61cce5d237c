"""DDPG reinforcement-learning controller in PyTorch.

A 256/128 ReLU actor (tanh output) and critic, a host-side replay buffer,
Ornstein-Uhlenbeck, parameter-space and ε-greedy exploration, soft target
updates (τ = 1e-3), Adam on both nets.  One update is the critic's TD
step, then the actor's step through the critic as just updated; the
environment rollout can use the solvers' own plant step
(``examples/train_ddpg.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from aircraft_tpu_torch.device import resolve_device


# ---------------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MLPParams:
    layers: tuple  # tuple of (w (in, out), b (out,))

    @classmethod
    def init(cls, generator: torch.Generator, sizes: Sequence[int],
             final_scale: float = 3e-3, device="cuda") -> "MLPParams":
        """Uniform(±1/√fan_in) weights (±final_scale on the last layer)
        drawn from ``generator``, zero biases."""
        dev = resolve_device(device)
        layers = []
        for i in range(len(sizes) - 1):
            bound = (final_scale if i == len(sizes) - 2
                     else 1.0 / np.sqrt(sizes[i]))
            w = (2.0 * torch.rand((sizes[i], sizes[i + 1]),
                                  generator=generator) - 1.0) * bound
            layers.append((w.to(dev), torch.zeros(sizes[i + 1], device=dev)))
        return cls(layers=tuple(layers))

    def tensors(self) -> list:
        return [t for layer in self.layers for t in layer]

    def clone(self) -> "MLPParams":
        """A copy that shares no storage with this one."""
        return MLPParams(layers=tuple((w.detach().clone(), b.detach().clone())
                                      for w, b in self.layers))


def mlp_params_from_numpy(layers, device="cuda") -> MLPParams:
    """``MLPParams`` from a sequence of (w, b) numpy pairs (new storage)."""
    dev = resolve_device(device)
    return MLPParams(layers=tuple(
        (torch.tensor(np.asarray(w, np.float32), device=dev),
         torch.tensor(np.asarray(b, np.float32), device=dev))
        for w, b in layers))


def mlp_apply(p: MLPParams, x, final_tanh=False):
    h = x
    n = len(p.layers)
    for i, (w, b) in enumerate(p.layers):
        h = h @ w + b
        if i < n - 1:
            h = torch.relu(h)
    return torch.tanh(h) if final_tanh else h


@dataclass(frozen=True)
class DDPGParams:
    actor: MLPParams
    critic: MLPParams
    target_actor: MLPParams
    target_critic: MLPParams


def ddpg_params_from_numpy(actor, critic, target_actor=None,
                           target_critic=None, device="cuda") -> DDPGParams:
    """``DDPGParams`` from (w, b) numpy pair sequences; each target defaults
    to a copy of its online net.  No two nets share storage, so the soft
    update moves the targets."""
    actor_p = mlp_params_from_numpy(actor, device)
    critic_p = mlp_params_from_numpy(critic, device)
    return DDPGParams(
        actor=actor_p, critic=critic_p,
        target_actor=(actor_p.clone() if target_actor is None
                      else mlp_params_from_numpy(target_actor, device)),
        target_critic=(critic_p.clone() if target_critic is None
                       else mlp_params_from_numpy(target_critic, device)))


class Transition(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    next_obs: torch.Tensor
    done: torch.Tensor


class ReplayBuffer:
    """Host-side ring buffer; ``sample`` hands the batch to ``device``."""

    def __init__(self, capacity: int, obs_dim: int, act_dim: int,
                 device="cuda"):
        self.device = resolve_device(device)
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.action = np.zeros((capacity, act_dim), np.float32)
        self.reward = np.zeros((capacity,), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.done = np.zeros((capacity,), np.float32)
        self.idx = 0
        self.size = 0

    def add(self, obs, action, reward, next_obs, done):
        i = self.idx
        self.obs[i] = obs
        self.action[i] = action
        self.reward[i] = reward
        self.next_obs[i] = next_obs
        self.done[i] = done
        self.idx = (i + 1) % self.capacity
        self.size = min(self.size + 1, self.capacity)

    def sample(self, rng: np.random.Generator, batch: int) -> Transition:
        idx = rng.integers(0, self.size, batch)
        return Transition(*(torch.as_tensor(a[idx], device=self.device)
                            for a in (self.obs, self.action, self.reward,
                                      self.next_obs, self.done)))


class OUNoise:
    """Ornstein–Uhlenbeck exploration."""

    def __init__(self, dim, mu=0.0, theta=0.15, sigma=0.2, rng=None):
        self.mu = mu * np.ones(dim)
        self.theta = theta
        self.sigma = sigma
        self.state = self.mu.copy()
        self.rng = rng or np.random.default_rng(0)

    def reset(self):
        self.state = self.mu.copy()

    def sample(self):
        dx = (self.theta * (self.mu - self.state)
              + self.sigma * self.rng.standard_normal(len(self.mu)))
        self.state = self.state + dx
        return self.state


class ParameterSpaceNoise:
    """Adaptive parameter-space exploration: perturb the actor's weights
    with Gaussian noise whose stddev adapts so the induced ACTION-space
    distance tracks a target."""

    def __init__(self, initial_std=0.1, target_action_std=0.2, adapt=1.01,
                 rng=None):
        self.std = initial_std
        self.target = target_action_std
        self.adapt = adapt
        self.rng = rng or np.random.default_rng(0)

    def perturb(self, params: MLPParams) -> MLPParams:
        def noisy(t):
            n = self.rng.normal(0.0, self.std, tuple(t.shape))
            return t + torch.as_tensor(n, dtype=t.dtype, device=t.device)

        return MLPParams(layers=tuple((noisy(w), noisy(b))
                                      for w, b in params.layers))

    def update(self, action_distance: float) -> None:
        """Grow noise when the perturbed policy moved less than the target
        action distance, shrink when it moved more."""
        if action_distance < self.target:
            self.std *= self.adapt
        else:
            self.std /= self.adapt


class EpsilonGreedy:
    """ε-greedy gate over a continuous policy: with probability ε replace
    the policy action by a uniform random one; ε decays geometrically per
    sample."""

    def __init__(self, eps=1.0, eps_min=0.05, decay=0.995, rng=None):
        self.eps = eps
        self.eps_min = eps_min
        self.decay = decay
        self.rng = rng or np.random.default_rng(0)

    def select(self, action: np.ndarray, low: float,
               high: float) -> np.ndarray:
        explore = self.rng.random() < self.eps
        self.eps = max(self.eps_min, self.eps * self.decay)
        if explore:
            return self.rng.uniform(low, high, np.shape(action))
        return np.asarray(action)


class DDPGAgent:
    """Actor-critic with soft target updates.  The nets start from
    ``params`` when given, else from ``MLPParams.init`` with a generator
    seeded with ``seed``; the targets start as copies of the online
    nets."""

    def __init__(
        self,
        obs_dim: int,
        act_dim: int,
        *,
        action_scale: float = 5.0,
        gamma: float = 0.99,
        tau: float = 1e-3,
        actor_lr: float = 1e-4,
        critic_lr: float = 1e-3,
        seed: int = 0,
        hidden: tuple = (256, 128),
        params: Optional[DDPGParams] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator().manual_seed(seed)
            actor = MLPParams.init(gen, (obs_dim, *hidden, act_dim),
                                   device=self.device)
            critic = MLPParams.init(gen, (obs_dim + act_dim, *hidden, 1),
                                    device=self.device)
            params = DDPGParams(actor=actor, critic=critic,
                                target_actor=actor, target_critic=critic)
        # own storage for all four nets: a target aliasing its online net
        # would follow it exactly and the soft update would be a no-op
        self.params = DDPGParams(*(MLPParams(layers=tuple(
            (w.detach().to(self.device, copy=True),
             b.detach().to(self.device, copy=True)) for w, b in net.layers))
            for net in (params.actor, params.critic, params.target_actor,
                        params.target_critic)))
        for t in self.params.actor.tensors() + self.params.critic.tensors():
            t.requires_grad_()
        self.action_scale = action_scale
        self.gamma = gamma
        self.tau = tau
        self.actor_opt = torch.optim.Adam(self.params.actor.tensors(),
                                          lr=actor_lr, eps=1e-8)
        self.critic_opt = torch.optim.Adam(self.params.critic.tensors(),
                                           lr=critic_lr, eps=1e-8)

    def act(self, obs, noise: Optional[np.ndarray] = None) -> np.ndarray:
        with torch.no_grad():
            a = mlp_apply(self.params.actor,
                          torch.as_tensor(np.asarray(obs, np.float32),
                                          device=self.device),
                          final_tanh=True)
        a = a.cpu().numpy() * self.action_scale
        if noise is not None:
            a = a + noise
        return np.clip(a, -self.action_scale, self.action_scale)

    def train_step(self, batch: Transition):
        """One update on ``batch``; returns the (critic, actor) losses."""
        p, gamma, tau, scale = self.params, self.gamma, self.tau, \
            self.action_scale
        # critic: TD target from the target nets
        with torch.no_grad():
            next_a = mlp_apply(p.target_actor, batch.next_obs,
                               final_tanh=True) * scale
            q_next = mlp_apply(p.target_critic, torch.cat(
                [batch.next_obs, next_a], -1))[..., 0]
            target = batch.reward + gamma * (1.0 - batch.done) * q_next

        self.critic_opt.zero_grad(set_to_none=True)
        q = mlp_apply(p.critic, torch.cat([batch.obs, batch.action],
                                          -1))[..., 0]
        cl = torch.mean((q - target) ** 2)
        cl.backward()
        self.critic_opt.step()

        # actor: through the critic as just updated, detached, so its
        # gradient reaches neither the critic nor the critic's Adam state
        critic = MLPParams(layers=tuple((w.detach(), b.detach())
                                        for w, b in p.critic.layers))
        self.actor_opt.zero_grad(set_to_none=True)
        act = mlp_apply(p.actor, batch.obs, final_tanh=True) * scale
        al = -torch.mean(mlp_apply(critic, torch.cat([batch.obs, act],
                                                     -1))[..., 0])
        al.backward()
        self.actor_opt.step()

        with torch.no_grad():
            for tgt, src in ((p.target_actor, p.actor),
                             (p.target_critic, p.critic)):
                for t, s in zip(tgt.tensors(), src.tensors()):
                    t.copy_((1 - tau) * t + tau * s)
        return float(cl.detach()), float(al.detach())


class CurriculumStage(NamedTuple):
    """Distance-graduated goal stage."""

    name: str
    goal_distance: float
    success_threshold: float


DEFAULT_CURRICULUM = (
    CurriculumStage("stable_flight", 0.0, 0.8),
    CurriculumStage("straight_line", 50.0, 0.7),
    CurriculumStage("near_goal", 100.0, 0.6),
    CurriculumStage("far_goal", 200.0, 0.5),
)


class CurriculumLearning:
    """Advances through stages on rolling success rate."""

    def __init__(self, stages=DEFAULT_CURRICULUM, window: int = 50):
        self.stages = stages
        self.window = window
        self.stage_idx = 0
        self.results: list[bool] = []

    @property
    def stage(self) -> CurriculumStage:
        return self.stages[self.stage_idx]

    def record(self, success: bool) -> bool:
        """Record an episode; returns True if the curriculum advanced."""
        self.results.append(bool(success))
        recent = self.results[-self.window:]
        if (
            len(recent) >= self.window
            and np.mean(recent) >= self.stage.success_threshold
            and self.stage_idx < len(self.stages) - 1
        ):
            self.stage_idx += 1
            self.results = []
            return True
        return False
