"""Vectorized environments. Copy of ray_tpu/rllib/vector.py (the port
imports nothing of ray_tpu); reference: rllib/env/vector/ +
gymnasium.vector.SyncVectorEnv — batch stepping with autoreset so the env
runner makes ONE step call per timestep for all its envs).

Two shapes:
- ``SyncVectorEnv``: wraps N independent python envs behind the batch API
  (steps them in-process; the win is one call boundary + batched reset
  bookkeeping).
- natively-batched envs: any object exposing the same ``num_envs`` /
  ``reset_all`` / ``step_batch`` surface but simulating all N instances
  with array ops (see examples/pixel_gridworld.py) — the fast path.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np


class SyncVectorEnv:
    """Batch API over N single envs, with autoreset: a done env is reset
    inside step_batch and its NEXT episode's first obs is returned (the
    pre-reset terminal obs is not observable, matching gymnasium's
    autoreset semantics for on-policy bootstrapping via the dones mask)."""

    def __init__(self, env_fns: List[Callable[[], Any]], seed: int = 0):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self._seed = seed
        ref = self.envs[0]
        self.action_space = getattr(ref, "action_space", None)
        self.observation_space = getattr(ref, "observation_space", None)

    def reset_all(self) -> np.ndarray:
        return np.stack([e.reset(seed=self._seed + i)[0]
                         for i, e in enumerate(self.envs)])

    def step_batch(self, actions) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray, np.ndarray]:
        obs, rews, terms, truncs = [], [], [], []
        for i, env in enumerate(self.envs):
            a = actions[i]
            if np.ndim(a) == 0:
                a = a.item() if hasattr(a, "item") else a
            nobs, rew, term, trunc, _ = env.step(a)
            done = bool(term) or bool(trunc)
            if done:
                nobs, _ = env.reset()
            obs.append(nobs)
            rews.append(rew)
            terms.append(bool(term))
            truncs.append(bool(trunc))
        return (np.stack(obs), np.asarray(rews, np.float32),
                np.asarray(terms), np.asarray(truncs))


def as_batch_env(env_or_fn, num_envs: int, seed: int = 0):
    """Normalize to the batch surface: a factory returning a natively
    batched env (has step_batch) is used directly; otherwise N instances
    wrap in SyncVectorEnv (reusing the probe instance as env 0)."""
    probe = env_or_fn() if callable(env_or_fn) else env_or_fn
    if hasattr(probe, "step_batch"):
        return probe
    fns = [lambda: probe] + [env_or_fn for _ in range(num_envs - 1)]
    return SyncVectorEnv(fns, seed=seed)
