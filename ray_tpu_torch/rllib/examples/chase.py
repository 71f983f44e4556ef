"""Copy of ray_tpu/rllib/examples/chase.py.

Two-agent competitive gridworld: a pursuer chases an evader
(reference: the multi-agent example envs under rllib/examples/envs —
same dict-based MultiAgentEnv protocol, multi_agent_env.py).

Zero-sum-ish: the pursuer is rewarded for catching, the evader for
surviving. Both policies LEARN against a random opponent baseline: the
pursuer catches much faster than a random walker, and the evader
survives much longer than one — the assertions the learning test makes.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

# actions: 0..3 = N/S/W/E, 4 = stay
_MOVES = np.array([[0, -1], [0, 1], [-1, 0], [1, 0], [0, 0]])

PURSUER = "pursuer"
EVADER = "evader"


class ChaseEnv:
    """5x5 grid; both agents act simultaneously every step.

    obs (per agent, 6 floats): own x,y, other x,y (normalized), dx, dy.
    rewards: catch -> pursuer +1 / evader -1; per step -> pursuer -0.02
    (hurry), evader +0.05 (survive). Episode ends on catch or horizon.
    """

    agents = (PURSUER, EVADER)
    obs_dim = 6
    num_actions = 5

    def __init__(self, size: int = 5, horizon: int = 32):
        self.size = size
        self.horizon = horizon
        self._rng = np.random.default_rng(0)
        self.t = 0
        self.pos: Dict[str, np.ndarray] = {}

    def reset(self, *, seed: Optional[int] = None) -> Dict[str, Any]:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.t = 0
        # opposite corners-ish, jittered
        self.pos = {
            PURSUER: self._rng.integers(0, 2, size=2),
            EVADER: self._rng.integers(self.size - 2, self.size, size=2),
        }
        return self._obs()

    def _obs(self) -> Dict[str, np.ndarray]:
        s = float(self.size - 1)
        p, e = self.pos[PURSUER], self.pos[EVADER]
        d = (e - p) / s
        return {
            PURSUER: np.array([p[0] / s, p[1] / s, e[0] / s, e[1] / s,
                               d[0], d[1]], np.float32),
            EVADER: np.array([e[0] / s, e[1] / s, p[0] / s, p[1] / s,
                              -d[0], -d[1]], np.float32),
        }

    def step(self, actions: Dict[str, int]
             ) -> Tuple[Dict[str, Any], Dict[str, float], Dict[str, Any]]:
        self.t += 1
        for aid, act in actions.items():
            self.pos[aid] = np.clip(self.pos[aid] + _MOVES[int(act)],
                                    0, self.size - 1)
        caught = bool((self.pos[PURSUER] == self.pos[EVADER]).all())
        horizon = self.t >= self.horizon
        rewards = {
            PURSUER: (1.0 if caught else -0.02),
            EVADER: (-1.0 if caught else 0.05),
        }
        done = caught or horizon
        dones = {PURSUER: done, EVADER: done, "__all__": done}
        return self._obs(), rewards, dones


def random_baseline(n_episodes: int = 200, seed: int = 0
                    ) -> Dict[str, float]:
    """Both agents random: catch-time and per-agent reward references."""
    rng = np.random.default_rng(seed)
    env = ChaseEnv()
    totals = {PURSUER: 0.0, EVADER: 0.0}
    steps = 0
    for ep in range(n_episodes):
        env.reset(seed=seed + ep)
        done = False
        while not done:
            _, rews, dones = env.step(
                {a: int(rng.integers(0, 5)) for a in env.agents})
            for a, r in rews.items():
                totals[a] += r
            done = dones["__all__"]
            steps += 1
    return {"pursuer_mean": totals[PURSUER] / n_episodes,
            "evader_mean": totals[EVADER] / n_episodes,
            "mean_len": steps / n_episodes}
