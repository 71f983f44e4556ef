"""EnvRunner: steps vectorized envs with the current policy. Port of
ray_tpu/rllib/env_runner.py (reference: rllib/env/single_agent_env_runner.py
+ env_runner_group.py).

The reference's runners are actors holding CPU envs and a copy of the
params. The port starts no runtime: its EnvRunnerGroup holds its runners in
this process, each seeded as the reference seeds its actor (``seed +
1000 * i``) and holding its own copy of the learner's weights on the
module's device (``sync_weights`` copies them). Envs step on the host;
each timestep is one batched forward on the device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.rl_module import clone_weights
from ray_tpu_torch.rllib.vector import as_batch_env


def env_factory(env: Any = None, env_fn: Optional[Callable] = None):
    """The env factory of a config's ``.environment(...)``: ``env_fn``, or a
    gymnasium id (gymnasium is imported only when such a factory runs), or
    ``env`` itself."""
    if env_fn is not None:
        return env_fn
    if isinstance(env, str):
        name = env

        def make():
            import gymnasium

            return gymnasium.make(name)

        return make
    return env


class SingleAgentEnvRunner:
    """Steps a VECTORIZED env (rllib/vector.py): one batched inference +
    one batched env step per timestep. env_fn may build a single env
    (wrapped num_envs-wide in SyncVectorEnv) or a natively-batched env
    exposing step_batch — e.g. examples/pixel_gridworld.py."""

    def __init__(self, env_fn, module, num_envs: int = 4, seed: int = 0):
        self.vec = as_batch_env(env_fn, num_envs, seed)
        self.num_envs = self.vec.num_envs
        self.module = module
        self.params = None
        # the runner's draws (the reference's PRNGKey(seed))
        self._gen = torch.Generator(device=module.device).manual_seed(seed)
        self.obs = np.asarray(self.vec.reset_all())
        self._ep_returns = np.zeros(self.num_envs)
        self._done_returns: List[float] = []

    def set_weights(self, params) -> None:
        """Holds a copy of ``params`` (no storage shared with the
        learner's, which its optimizer updates in place)."""
        self.params = clone_weights(params)

    def sample(self, num_steps: int) -> Dict[str, np.ndarray]:
        """Rollout num_steps per env. Returns [T, N, ...] arrays plus
        bootstrap values/flags for GAE."""
        n = self.num_envs
        obs_buf = np.empty((num_steps, n) + self.obs.shape[1:], np.float32)
        act_buf: Optional[np.ndarray] = None  # dtype/shape from the module
        logp_buf = np.empty((num_steps, n), np.float32)
        val_buf = np.empty((num_steps, n), np.float32)
        rew_buf = np.empty((num_steps, n), np.float32)
        done_buf = np.empty((num_steps, n), np.float32)
        for t in range(num_steps):
            actions, logps, values = self.module.forward_inference(
                self.params, self.obs.astype(np.float32), self._gen)
            if act_buf is None:
                act_buf = np.empty((num_steps,) + actions.shape,
                                   actions.dtype)
            obs_buf[t] = self.obs
            act_buf[t] = actions
            logp_buf[t] = logps
            val_buf[t] = values
            nobs, rews, terms, truncs = self.vec.step_batch(actions)
            rew_buf[t] = rews
            dones = np.asarray(terms) | np.asarray(truncs)
            done_buf[t] = dones.astype(np.float32)
            self._ep_returns += rews
            for i in np.where(dones)[0]:
                self._done_returns.append(float(self._ep_returns[i]))
                self._ep_returns[i] = 0.0
            self.obs = np.asarray(nobs)
        _, _, last_vals = self.module.forward_inference(
            self.params, self.obs.astype(np.float32), self._gen)
        return {
            "obs": obs_buf, "actions": act_buf, "logp": logp_buf,
            "values": val_buf, "rewards": rew_buf, "dones": done_buf,
            "last_values": last_vals,
        }

    def episode_returns(self) -> List[float]:
        out, self._done_returns = self._done_returns, []
        return out


class EnvRunnerGroup:
    """The runners of an algorithm, in this process (reference:
    env_runner_group.py fans out over runner actors)."""

    def __init__(self, env_fn, module, *, num_runners: int = 2,
                 num_envs_per_runner: int = 4, seed: int = 0):
        self.runners = [
            SingleAgentEnvRunner(env_fn, module, num_envs_per_runner,
                                 seed + 1000 * i)
            for i in range(num_runners)
        ]

    def sync_weights(self, params) -> None:
        for r in self.runners:
            r.set_weights(params)

    def sample(self, num_steps_per_runner: int) -> List[Dict[str, Any]]:
        return [r.sample(num_steps_per_runner) for r in self.runners]

    def episode_returns(self) -> List[float]:
        return [x for r in self.runners for x in r.episode_returns()]
