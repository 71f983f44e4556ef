"""Offline RL data plane. Port of ray_tpu/rllib/offline.py (reference:
rllib/offline/ — offline_data.py ``OfflineData`` reads experiences through
ray.data; offline_env_runner.py records them).

Episodes are flat transition tables (obs / action / reward / next_obs /
done / episode_id columns). ``record_episodes`` and the batching of
``OfflineData`` are numpy copies of the reference's. The reference also
reads and writes such tables as parquet through its Data library; that
path waits for the port of the runtime (Data), so ``OfflineData`` takes a
dataset object with ``iter_blocks()`` (each block a dict of numpy columns)
and a path raises.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np


def record_episodes(env_fn: Callable, *, n_episodes: int = 50,
                    policy: Optional[Callable] = None,
                    seed: int = 0,
                    max_steps: int = 500) -> Dict[str, np.ndarray]:
    """Roll episodes and return a flat transition block. `policy(obs) ->
    action` defaults to uniform-random (reference:
    offline_env_runner.py sampling-to-disk)."""
    env = env_fn()
    rng = np.random.default_rng(seed)
    cols: Dict[str, List[Any]] = {
        "obs": [], "action": [], "reward": [], "next_obs": [],
        "done": [], "episode_id": []}
    for ep in range(n_episodes):
        obs, _ = env.reset(seed=seed + ep)
        for _ in range(max_steps):
            if policy is not None:
                action = int(policy(np.asarray(obs)))
            else:
                action = int(rng.integers(env.action_space.n))
            nxt, rew, term, trunc, _ = env.step(action)
            cols["obs"].append(np.asarray(obs, np.float32))
            cols["action"].append(action)
            cols["reward"].append(float(rew))
            cols["next_obs"].append(np.asarray(nxt, np.float32))
            cols["done"].append(bool(term or trunc))
            cols["episode_id"].append(ep)
            obs = nxt
            if term or trunc:
                break
    return {
        "obs": np.stack(cols["obs"]),
        "action": np.asarray(cols["action"], np.int32),
        "reward": np.asarray(cols["reward"], np.float32),
        "next_obs": np.stack(cols["next_obs"]),
        "done": np.asarray(cols["done"], np.bool_),
        "episode_id": np.asarray(cols["episode_id"], np.int32),
    }


class OfflineData:
    """Reader half (reference: rllib/offline/offline_data.py): wraps a
    dataset of transition blocks and serves shuffled train batches."""

    def __init__(self, dataset_or_path: Any):
        if isinstance(dataset_or_path, str):
            raise NotImplementedError(
                "reading offline data from a path (parquet through the "
                "Data library) waits for the port of the runtime's Data "
                "library; pass a dataset object with iter_blocks()")
        self.dataset = dataset_or_path
        self._cache: Optional[Dict[str, np.ndarray]] = None

    def _table(self) -> Dict[str, np.ndarray]:
        if self._cache is None:
            blocks = list(self.dataset.iter_blocks())
            if not blocks:
                raise ValueError(
                    "offline dataset is empty (no transition blocks)")
            out: Dict[str, np.ndarray] = {}
            for key in blocks[0]:
                vals = [b[key] for b in blocks]
                # list columns (object arrays of rows) stack to f32
                arrs = [np.stack([np.asarray(r, np.float32) for r in v])
                        if getattr(v, "dtype", None) == object
                        else np.asarray(v) for v in vals]
                out[key] = np.concatenate(arrs, axis=0)
            self._cache = out
        return self._cache

    def num_transitions(self) -> int:
        return len(self._table()["action"])

    def iter_train_batches(self, *, batch_size: int, num_epochs: int = 1,
                           seed: int = 0
                           ) -> Iterator[Dict[str, np.ndarray]]:
        """``num_epochs`` passes, each over one permutation drawn from
        ``np.random.default_rng(seed)``; the last partial batch of a pass
        is dropped."""
        table = self._table()
        n = self.num_transitions()
        rng = np.random.default_rng(seed)
        for _ in range(num_epochs):
            perm = rng.permutation(n)
            for i in range(0, n - batch_size + 1, batch_size):
                idx = perm[i:i + batch_size]
                yield {k: v[idx] for k, v in table.items()}


def evaluate_actions(compute_actions: Callable[[np.ndarray], np.ndarray],
                     env_fn: Callable, *, n_episodes: int, max_steps: int,
                     seed: int) -> Dict[str, Any]:
    """BC's and CQL's ``evaluate``: ``n_episodes`` episodes of
    ``compute_actions`` (one observation a call) from env seeds ``seed +
    ep``, each cut at ``max_steps``; the mean undiscounted return."""
    env = env_fn()
    returns = []
    for ep in range(n_episodes):
        obs, _ = env.reset(seed=seed + ep)
        total = 0.0
        for _ in range(max_steps):
            a = int(compute_actions(np.asarray(obs))[0])
            obs, rew, term, trunc, _ = env.step(a)
            total += float(rew)
            if term or trunc:
                break
        returns.append(total)
    return {"episode_return_mean": float(np.mean(returns)),
            "episodes": n_episodes}
