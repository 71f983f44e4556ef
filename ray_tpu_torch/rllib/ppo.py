"""PPO algorithm. Port of ray_tpu/rllib/ppo.py (reference:
rllib/algorithms/ppo/ppo.py, training_step; config builder
rllib/algorithms/algorithm_config.py).

training_step = synchronous sample over the EnvRunnerGroup → GAE →
LearnerGroup.update → sync_weights. One device, resolved once by
``build(device=None)`` (the card unless the caller names another), holds
the learners' and the runners' weights.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup, env_factory
from ray_tpu_torch.rllib.learner import (
    LearnerGroup,
    PPOLearnerConfig,
    compute_gae,
)
from ray_tpu_torch.rllib.rl_module import RLModule


class PPOConfig:
    """Builder-style config (reference: AlgorithmConfig fluent API)."""

    def __init__(self):
        self._env_fn: Optional[Callable] = None
        self.num_env_runners = 2
        self.num_envs_per_runner = 4
        self.rollout_length = 64
        self.num_learners = 0
        self.hidden = (64, 64)
        self.seed = 0
        self.learner = PPOLearnerConfig()

    def environment(self, env: Any = None, *,
                    env_fn: Optional[Callable] = None) -> "PPOConfig":
        self._env_fn = env_factory(env, env_fn)
        return self

    def env_runners(self, *, num_env_runners: int = 2,
                    num_envs_per_env_runner: int = 4,
                    rollout_fragment_length: int = 64) -> "PPOConfig":
        self.num_env_runners = num_env_runners
        self.num_envs_per_runner = num_envs_per_env_runner
        self.rollout_length = rollout_fragment_length
        return self

    def learners(self, *, num_learners: int = 0) -> "PPOConfig":
        self.num_learners = num_learners
        return self

    def training(self, **overrides) -> "PPOConfig":
        for k, v in overrides.items():
            if hasattr(self.learner, k):
                setattr(self.learner, k, v)
            elif k == "model_hidden":
                self.hidden = tuple(v)
            else:
                raise ValueError(f"unknown training option {k!r}")
        return self

    def debugging(self, *, seed: int = 0) -> "PPOConfig":
        self.seed = seed
        return self

    def build(self, device=None) -> "PPO":
        return PPO(self, device=device)


class PPO:
    def __init__(self, config: PPOConfig, device=None):
        assert config._env_fn is not None, "call .environment(...) first"
        self.config = config
        probe = config._env_fn()
        if hasattr(probe, "obs_shape") and len(probe.obs_shape) == 3:
            # Pixel env (H, W, C): RLModule picks the conv trunk.
            obs_dim: Any = tuple(probe.obs_shape)
            num_actions = int(probe.num_actions)
        else:
            obs_dim = int(np.prod(probe.observation_space.shape))
            num_actions = int(probe.action_space.n)
        self.module = RLModule(obs_dim, num_actions, config.hidden,
                               device=device)
        self.learner_group = LearnerGroup(
            self.module, config.learner, config.num_learners, config.seed)
        self.env_runners = EnvRunnerGroup(
            config._env_fn, self.module,
            num_runners=config.num_env_runners,
            num_envs_per_runner=config.num_envs_per_runner,
            seed=config.seed)
        self.env_runners.sync_weights(self.learner_group.get_weights())
        self.iteration = 0
        self._return_window: List[float] = []

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        rollouts = self.env_runners.sample(cfg.rollout_length)
        t_sample = time.perf_counter() - t0
        batches = [compute_gae(r, cfg.learner.gamma, cfg.learner.gae_lambda)
                   for r in rollouts]
        t1 = time.perf_counter()
        result = self.learner_group.update(batches)
        t_learn = time.perf_counter() - t1
        self.env_runners.sync_weights(self.learner_group.get_weights())
        self._return_window.extend(self.env_runners.episode_returns())
        self._return_window = self._return_window[-100:]
        t_total = time.perf_counter() - t0
        steps = sum(b["obs"].shape[0] for b in batches)
        return {
            "loss": result["loss"],
            "env_steps_this_iter": steps,
            "env_steps_per_s": steps / t_total,
            "sample_time_s": t_sample,
            "learn_time_s": t_learn,
            "episode_return_mean": (float(np.mean(self._return_window))
                                    if self._return_window else float("nan")),
        }

    def train(self) -> Dict[str, Any]:
        self.iteration += 1
        out = self.training_step()
        out["training_iteration"] = self.iteration
        return out

    def get_weights(self):
        return self.learner_group.get_weights()

    def stop(self) -> None:
        pass
