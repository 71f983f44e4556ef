"""DQN. Port of ray_tpu/rllib/dqn.py (reference: rllib/algorithms/dqn/ —
RLModule + Learner + EnvRunnerGroup + replay buffer; double-DQN target,
target network, epsilon-greedy exploration with linear annealing).

The gradient step runs on the module's device over fixed-size minibatches
drawn from a host-side circular replay buffer (a copy of the reference's);
the target network is a real copy of the online weights, refreshed every
``target_update_period`` SGD steps.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup, env_factory
from ray_tpu_torch.rllib.learner import ClippedAdam, leaf_params
from ray_tpu_torch.rllib.rl_module import (
    Weights,
    clone_weights,
    dense_stack,
    init_weights,
    to_tensor,
)
from ray_tpu_torch.utils.device import resolve_device


class QNet(nn.Module):
    def __init__(self, obs_dim: int, num_actions: int,
                 hidden: Sequence[int] = (64, 64)):
        super().__init__()
        self.hidden = tuple(hidden)
        dense_stack(self, (obs_dim,) + self.hidden + (num_actions,))

    def forward(self, obs):
        x = obs
        for i in range(len(self.hidden)):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{len(self.hidden)}")(x)


class DQNModule:
    """Q-network module, interface-compatible with SingleAgentEnvRunner:
    forward_inference(weights, obs, generator) -> (action, logp, value).
    Weights travel as a bundle {"params", "epsilon"} so exploration anneals
    through the same sync_weights path as the parameters."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hidden: Sequence[int] = (64, 64), device=None):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.device = resolve_device(device)
        with torch.device("meta"):
            self.net = QNet(obs_dim, num_actions, tuple(hidden))

    def init_params(self, seed: int) -> Weights:
        return init_weights(self.net, torch.Generator().manual_seed(seed),
                            self.device)

    def q_values(self, params: Weights, obs: torch.Tensor) -> torch.Tensor:
        return functional_call(self.net, params, (obs,))

    def forward_inference(self, weights, obs: np.ndarray,
                          generator: torch.Generator):
        """Epsilon-greedy actions, the random action and the explore flag
        drawn from ``generator``; logp and value are zeros."""
        with torch.no_grad():
            q = self.q_values(weights["params"], to_tensor(obs, self.device))
            greedy = torch.argmax(q, dim=-1)
            rand = torch.randint(0, self.num_actions, greedy.shape,
                                 generator=generator, device=self.device)
            explore = torch.rand(greedy.shape, generator=generator,
                                 device=self.device) < weights.get(
                                     "epsilon", 0.0)
            action = torch.where(explore, rand, greedy)
        zeros = np.zeros(greedy.shape, np.float32)
        return action.int().cpu().numpy(), zeros, zeros

    def __getstate__(self) -> Dict[str, Any]:
        return {"obs_dim": self.obs_dim, "num_actions": self.num_actions,
                "hidden": tuple(self.net.hidden), "device": str(self.device)}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__init__(**state)


class ReplayBuffer:
    """Uniform circular replay (reference:
    rllib/utils/replay_buffers/replay_buffer.py, trimmed to the DQN need;
    numpy, a copy of the reference's)."""

    def __init__(self, capacity: int, obs_dim: int):
        self.capacity = capacity
        self.obs = np.empty((capacity, obs_dim), np.float32)
        self.next_obs = np.empty((capacity, obs_dim), np.float32)
        self.actions = np.empty((capacity,), np.int32)
        self.rewards = np.empty((capacity,), np.float32)
        self.dones = np.empty((capacity,), np.float32)
        self.size = 0
        self._idx = 0

    def add_batch(self, obs, actions, rewards, next_obs, dones) -> None:
        for i in range(obs.shape[0]):
            j = self._idx
            self.obs[j] = obs[i]
            self.next_obs[j] = next_obs[i]
            self.actions[j] = actions[i]
            self.rewards[j] = rewards[i]
            self.dones[j] = dones[i]
            self._idx = (j + 1) % self.capacity
            self.size = min(self.size + 1, self.capacity)

    def sample(self, n: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        idx = rng.integers(0, self.size, size=n)
        return {
            "obs": self.obs[idx],
            "actions": self.actions[idx],
            "rewards": self.rewards[idx],
            "next_obs": self.next_obs[idx],
            "dones": self.dones[idx],
        }


@dataclasses.dataclass
class DQNLearnerConfig:
    lr: float = 1e-3
    gamma: float = 0.99
    batch_size: int = 128
    sgd_steps_per_iter: int = 32
    target_update_period: int = 256  # in sgd steps
    double_dqn: bool = True
    max_grad_norm: float = 10.0


class DQNLearner:
    """Owns online + target params; one TD step a minibatch."""

    def __init__(self, module: DQNModule, config: DQNLearnerConfig,
                 seed: int = 0):
        self.module = module
        self.cfg = config
        self.params = leaf_params(module.init_params(seed))
        self.target_params = clone_weights(self.params)
        self.opt = ClippedAdam(self.params, config.lr, config.max_grad_norm)
        self._steps = 0

    def loss(self, params: Weights, target_params: Weights,
             mb: Dict[str, torch.Tensor]) -> torch.Tensor:
        q = self.module.q_values(params, mb["obs"])
        q_sel = q.gather(1, mb["actions"][:, None].long())[:, 0]
        with torch.no_grad():
            q_next_t = self.module.q_values(target_params, mb["next_obs"])
            if self.cfg.double_dqn:
                best = torch.argmax(
                    self.module.q_values(params, mb["next_obs"]), dim=-1)
                q_next = q_next_t.gather(1, best[:, None])[:, 0]
            else:
                q_next = q_next_t.max(dim=-1).values
            target = mb["rewards"] + self.cfg.gamma * (1.0 - mb["dones"]) \
                * q_next
        # optax.huber_loss with delta 1
        return F.huber_loss(q_sel, target, delta=1.0)

    def update(self, minibatches: List[Dict[str, np.ndarray]]
               ) -> Dict[str, Any]:
        dev = self.module.device
        losses = []
        for mb in minibatches:
            mb = {k: to_tensor(v, dev, v.dtype) for k, v in mb.items()}
            loss = self.loss(self.params, self.target_params, mb)
            self.opt.step(list(torch.autograd.grad(
                loss, list(self.params.values()))))
            losses.append(loss.detach())
            self._steps += 1
            if self._steps % self.cfg.target_update_period == 0:
                self.target_params = clone_weights(self.params)
        return {"loss": float(torch.stack(losses).mean()),
                "sgd_steps": len(losses)}

    def get_weights(self) -> Weights:
        return {k: p.detach() for k, p in self.params.items()}


class DQNConfig:
    """Builder-style config (reference: DQNConfig fluent API)."""

    def __init__(self):
        self._env_fn: Optional[Callable] = None
        self.num_env_runners = 2
        self.num_envs_per_runner = 4
        self.rollout_length = 32
        self.hidden = (64, 64)
        self.seed = 0
        self.buffer_capacity = 50_000
        self.learn_start = 500  # transitions before SGD begins
        self.epsilon = (1.0, 0.05)  # (initial, final)
        self.epsilon_anneal_steps = 5_000  # env steps
        self.learner = DQNLearnerConfig()

    def environment(self, env: Any = None, *,
                    env_fn: Optional[Callable] = None) -> "DQNConfig":
        self._env_fn = env_factory(env, env_fn)
        return self

    def env_runners(self, *, num_env_runners: int = 2,
                    num_envs_per_env_runner: int = 4,
                    rollout_fragment_length: int = 32) -> "DQNConfig":
        self.num_env_runners = num_env_runners
        self.num_envs_per_runner = num_envs_per_env_runner
        self.rollout_length = rollout_fragment_length
        return self

    def training(self, **overrides) -> "DQNConfig":
        for k, v in overrides.items():
            if hasattr(self.learner, k):
                setattr(self.learner, k, v)
            elif k in ("buffer_capacity", "learn_start",
                       "epsilon_anneal_steps"):
                setattr(self, k, int(v))
            elif k == "epsilon":
                self.epsilon = tuple(v)
            elif k == "model_hidden":
                self.hidden = tuple(v)
            else:
                raise ValueError(f"unknown training option {k!r}")
        return self

    def debugging(self, *, seed: int = 0) -> "DQNConfig":
        self.seed = seed
        return self

    def build(self, device=None) -> "DQN":
        return DQN(self, device=device)


class DQN:
    """training_step: sample with epsilon-greedy → replay add →
    sgd_steps_per_iter TD steps → sync weights+epsilon (reference:
    dqn.py training_step)."""

    def __init__(self, config: DQNConfig, device=None):
        assert config._env_fn is not None, "call .environment(...) first"
        self.config = config
        probe = config._env_fn()
        obs_dim = int(np.prod(probe.observation_space.shape))
        num_actions = int(probe.action_space.n)
        self.obs_dim = obs_dim
        self.module = DQNModule(obs_dim, num_actions, config.hidden,
                                device=device)
        self.learner = DQNLearner(self.module, config.learner, config.seed)
        self.buffer = ReplayBuffer(config.buffer_capacity, obs_dim)
        self.env_runners = EnvRunnerGroup(
            config._env_fn, self.module,
            num_runners=config.num_env_runners,
            num_envs_per_runner=config.num_envs_per_runner,
            seed=config.seed)
        self._rng = np.random.default_rng(config.seed)
        self.env_steps = 0
        self.iteration = 0
        self._return_window: List[float] = []
        self._sync()

    def _epsilon(self) -> float:
        e0, e1 = self.config.epsilon
        frac = min(1.0, self.env_steps / max(1, self.config.epsilon_anneal_steps))
        return float(e0 + (e1 - e0) * frac)

    def _sync(self) -> None:
        self.env_runners.sync_weights(
            {"params": self.learner.get_weights(),
             "epsilon": self._epsilon()})

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        rollouts = self.env_runners.sample(cfg.rollout_length)
        for r in rollouts:
            obs, act = r["obs"], r["actions"]  # [T, N, ...]
            T = obs.shape[0]
            # Transitions: next_obs[t] = obs[t+1]; the final step per env is
            # dropped (its successor is outside the fragment). A done step's
            # "next obs" is the post-reset obs, but dones mask the bootstrap
            # so the value never enters the target.
            flat = lambda x: x[:T - 1].reshape((-1,) + x.shape[2:])
            self.buffer.add_batch(
                flat(obs).reshape(-1, self.obs_dim),
                flat(act).ravel(),
                flat(r["rewards"]).ravel(),
                obs[1:].reshape(-1, self.obs_dim),
                flat(r["dones"]).ravel())
            self.env_steps += T * obs.shape[1]
        result = {"loss": float("nan"), "sgd_steps": 0}
        if self.buffer.size >= max(cfg.learn_start, cfg.learner.batch_size):
            mbs = [self.buffer.sample(cfg.learner.batch_size, self._rng)
                   for _ in range(cfg.learner.sgd_steps_per_iter)]
            result = self.learner.update(mbs)
        self._sync()
        self._return_window.extend(self.env_runners.episode_returns())
        self._return_window = self._return_window[-100:]
        dt = time.perf_counter() - t0
        steps = cfg.rollout_length * cfg.num_envs_per_runner * \
            cfg.num_env_runners
        return {
            "loss": result["loss"],
            "sgd_steps": result["sgd_steps"],
            "epsilon": self._epsilon(),
            "env_steps_this_iter": steps,
            "env_steps_total": self.env_steps,
            "env_steps_per_s": steps / dt,
            "episode_return_mean": (float(np.mean(self._return_window))
                                    if self._return_window else float("nan")),
        }

    def train(self) -> Dict[str, Any]:
        self.iteration += 1
        out = self.training_step()
        out["training_iteration"] = self.iteration
        return out

    def get_weights(self):
        return self.learner.get_weights()

    def stop(self) -> None:
        pass
