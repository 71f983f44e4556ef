"""Copy of ray_tpu/rllib/examples/pixel_gridworld.py.

Natively-batched PIXEL gridworld: B instances simulated with numpy
array ops, observations rendered as 84x84x1 images (reference: the
Atari-class pixel pipeline of rllib's tuned examples, rebuilt as a
procedural env with no ROM/ALE dependency).

The agent (bright square) must reach the goal (mid-gray square) on an
NxN grid with procedural walls; each env instance has its own layout.
Rendering upscales the NxN cell grid to 84x84 with np.kron-style
indexing, vectorized over the batch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

MOVES = np.array([[0, -1], [0, 1], [-1, 0], [1, 0]])  # U D L R

AGENT, GOAL, WALL = 1.0, 0.55, 0.25


class PixelGridWorldBatch:
    """Batch env surface (vector.py): num_envs / reset_all / step_batch."""

    def __init__(self, num_envs: int = 8, size: int = 7,
                 wall_density: float = 0.15, max_steps: int = 48,
                 res: int = 84, seed: int = 0):
        assert res % size == 0 or True  # rendering pads the remainder
        self.num_envs = num_envs
        self.size = size
        self.max_steps = max_steps
        self.res = res
        self._rng = np.random.default_rng(seed)
        self.obs_shape = (res, res, 1)
        self.num_actions = 4
        b, n = num_envs, size
        self.walls = np.zeros((b, n, n), bool)
        self.agent = np.zeros((b, 2), np.int64)
        self.goal = np.zeros((b, 2), np.int64)
        self.steps = np.zeros((b,), np.int64)
        for i in range(b):
            self._layout(i, wall_density)
        # cell -> pixel index map (precomputed once)
        cell = res // n
        idx = np.repeat(np.arange(n), cell)
        idx = np.pad(idx, (0, res - idx.size), mode="edge")
        self._pix = idx  # [res] -> grid coordinate

    def _layout(self, i: int, density: float) -> None:
        n = self.size
        while True:
            walls = self._rng.random((n, n)) < density
            free = np.argwhere(~walls)
            if len(free) < 2:
                continue
            a, g = self._rng.choice(len(free), 2, replace=False)
            if self._reachable(walls, free[a], free[g]):
                self.walls[i] = walls
                self.agent[i] = free[a]
                self.goal[i] = free[g]
                return

    @staticmethod
    def _reachable(walls, a, g) -> bool:
        from collections import deque

        n = walls.shape[0]
        seen = np.zeros_like(walls)
        q = deque([tuple(a)])
        seen[tuple(a)] = True
        while q:
            x, y = q.popleft()
            if (x, y) == tuple(g):
                return True
            for dx, dy in MOVES:
                nx, ny = x + dx, y + dy
                if (0 <= nx < n and 0 <= ny < n and not walls[nx, ny]
                        and not seen[nx, ny]):
                    seen[nx, ny] = True
                    q.append((nx, ny))
        return False

    def _render(self) -> np.ndarray:
        b, n = self.num_envs, self.size
        grid = np.where(self.walls, WALL, 0.0).astype(np.float32)
        bi = np.arange(b)
        grid[bi, self.goal[:, 0], self.goal[:, 1]] = GOAL
        grid[bi, self.agent[:, 0], self.agent[:, 1]] = AGENT
        img = grid[:, self._pix][:, :, self._pix]  # [B, res, res]
        return img[..., None]

    def reset_all(self) -> np.ndarray:
        return self._render()

    def step_batch(self, actions) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray, np.ndarray]:
        b, n = self.num_envs, self.size
        bi = np.arange(b)
        actions = np.asarray(actions).astype(np.int64).reshape(b)
        target = self.agent + MOVES[actions]
        inside = ((target >= 0) & (target < n)).all(axis=1)
        t_clip = np.clip(target, 0, n - 1)
        blocked = self.walls[bi, t_clip[:, 0], t_clip[:, 1]] | ~inside
        self.agent = np.where(blocked[:, None], self.agent, t_clip)
        self.steps += 1
        at_goal = (self.agent == self.goal).all(axis=1)
        rew = np.where(at_goal, 1.0,
                       np.where(blocked, -0.05, -0.01)).astype(np.float32)
        trunc = self.steps >= self.max_steps
        term = at_goal
        done = term | trunc
        if done.any():
            # autoreset: re-randomize agent position on the SAME layout
            # (fresh episode; layouts persist per instance)
            for i in np.where(done)[0]:
                free = np.argwhere(~self.walls[i])
                while True:
                    pick = free[self._rng.integers(len(free))]
                    if (pick != self.goal[i]).any():
                        break
                self.agent[i] = pick
                self.steps[i] = 0
        return self._render(), rew, term, trunc
