"""Copy of ray_tpu/rllib/examples/gridworld.py.

Procedural gridworld — a harder-than-CartPole learning benchmark with
no physics deps (reference: rllib/examples/envs/classes/ custom envs).

N×N grid with procedurally-placed walls; the agent must reach the goal.
Observations are float features (agent xy, goal xy, wall proximity in the
four directions), actions {up, down, left, right}. Reward: -0.01 per step,
-0.05 bumping a wall, +1.0 at the goal. An optimal expert (BFS) is
provided for offline-RL data generation."""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

MOVES = np.array([[0, -1], [0, 1], [-1, 0], [1, 0]])  # U D L R


class _Space:
    def __init__(self, n: int):
        self.n = n


class GridWorldEnv:
    """gymnasium-style API (reset/step) without the dependency."""

    def __init__(self, size: int = 8, wall_density: float = 0.2,
                 max_steps: int = 64, seed: int = 0):
        self.size = size
        self.wall_density = wall_density
        self.max_steps = max_steps
        self._layout_rng = np.random.default_rng(seed)
        self.action_space = _Space(4)
        self.obs_dim = 8
        self._build_layout()

    def _build_layout(self) -> None:
        n = self.size
        while True:
            walls = self._layout_rng.random((n, n)) < self.wall_density
            walls[0, 0] = False
            walls[n - 1, n - 1] = False
            self.goal = (n - 1, n - 1)
            if self._bfs_dists(walls)[0, 0] >= 0:
                self.walls = walls
                return

    def _bfs_dists(self, walls: np.ndarray) -> np.ndarray:
        """Distance-to-goal for every cell (-1 unreachable)."""
        n = self.size
        dist = np.full((n, n), -1, np.int32)
        q = deque([self.goal])
        dist[self.goal] = 0
        while q:
            x, y = q.popleft()
            for dx, dy in MOVES:
                nx, ny = x + dx, y + dy
                if 0 <= nx < n and 0 <= ny < n and not walls[nx, ny] \
                        and dist[nx, ny] < 0:
                    dist[nx, ny] = dist[x, y] + 1
                    q.append((nx, ny))
        return dist

    def _obs(self) -> np.ndarray:
        n = float(self.size - 1)
        x, y = self.pos
        gx, gy = self.goal
        prox = []
        for dx, dy in MOVES:
            nx, ny = x + dx, y + dy
            blocked = (not (0 <= nx < self.size and 0 <= ny < self.size)
                       or self.walls[nx, ny])
            prox.append(1.0 if blocked else 0.0)
        return np.asarray([x / n, y / n, gx / n, gy / n] + prox, np.float32)

    def reset(self, *, seed: Optional[int] = None
              ) -> Tuple[np.ndarray, Dict[str, Any]]:
        rng = np.random.default_rng(seed)
        free = np.argwhere(~self.walls)
        free = [tuple(c) for c in free if tuple(c) != self.goal]
        self.pos = free[rng.integers(len(free))]
        self.t = 0
        return self._obs(), {}

    def step(self, action: int):
        self.t += 1
        x, y = self.pos
        dx, dy = MOVES[int(action)]
        nx, ny = x + dx, y + dy
        reward = -0.01
        if (0 <= nx < self.size and 0 <= ny < self.size
                and not self.walls[nx, ny]):
            self.pos = (nx, ny)
        else:
            reward -= 0.05
        terminated = self.pos == self.goal
        if terminated:
            reward += 1.0
        truncated = self.t >= self.max_steps
        return self._obs(), reward, terminated, truncated, {}

    # -- expert (for offline data) --------------------------------------
    def expert_action(self) -> int:
        dist = self._bfs_dists(self.walls)
        x, y = self.pos
        best_a, best_d = 0, np.inf
        for a, (dx, dy) in enumerate(MOVES):
            nx, ny = x + dx, y + dy
            if 0 <= nx < self.size and 0 <= ny < self.size \
                    and not self.walls[nx, ny] and dist[nx, ny] >= 0 \
                    and dist[nx, ny] < best_d:
                best_a, best_d = a, dist[nx, ny]
        return best_a


def expert_policy(env: GridWorldEnv):
    """Policy closure over the env's live state (expert needs the position,
    which the observation encodes but BFS needs exactly)."""

    def policy(obs: np.ndarray) -> int:
        return env.expert_action()

    return policy
