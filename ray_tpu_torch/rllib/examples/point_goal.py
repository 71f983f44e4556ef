"""Copy of ray_tpu/rllib/examples/point_goal.py.

Continuous-control example env: a 2-D point chases a goal; action =
velocity in [-1,1]^2, dense negative-distance reward (SAC's smoke-test
env — learns in seconds on CPU; reference role: Pendulum-v1 in rllib's
SAC tuned examples, without the physics dependency)."""

from __future__ import annotations

import numpy as np


class _Box:
    def __init__(self, shape):
        self.shape = shape


class PointGoalEnv:
    def __init__(self, max_steps: int = 40, seed: int = 0):
        self.observation_space = _Box((4,))
        self.action_space = _Box((2,))
        self._rng = np.random.default_rng(seed)
        self.max_steps = max_steps

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.pos = self._rng.uniform(-1, 1, 2)
        self.goal = self._rng.uniform(-1, 1, 2)
        self.t = 0
        return self._obs(), {}

    def _obs(self):
        return np.concatenate([self.pos, self.goal]).astype(np.float32)

    def step(self, action):
        self.pos = np.clip(self.pos + 0.15 * np.asarray(action), -2, 2)
        self.t += 1
        dist = float(np.linalg.norm(self.pos - self.goal))
        return (self._obs(), -dist, dist < 0.1, self.t >= self.max_steps,
                {})
