"""CQL — Conservative Q-Learning for discrete actions. Port of
ray_tpu/rllib/cql.py (reference: rllib/algorithms/cql/cql.py; Kumar et al.
2020).

Offline Q-learning diverges because the bootstrap maximizes over actions
the dataset never took; CQL adds a conservative penalty
logsumexp(Q(s,·)) − Q(s, a_data) that pushes unseen-action Q-values down.
Discrete CQL(H) over a Q MLP (dqn.py's ``QNet``, the reference's ``_QNet``
with the same layer names), one update a batch run eagerly on the device,
data through the same OfflineData as BC. The target network is a copy of
the online weights taken every ``target_update_every`` updates, counted
across ``train()`` calls; Adam updates the online weights in place, so the
copy is a clone.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from ray_tpu_torch.rllib.bc import check_offline_config, offline_data
from ray_tpu_torch.rllib.dqn import QNet
from ray_tpu_torch.rllib.learner import leaf_params
from ray_tpu_torch.rllib.offline import evaluate_actions
from ray_tpu_torch.rllib.rl_module import (
    Weights,
    clone_weights,
    init_weights,
    to_tensor,
)
from ray_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class CQLLearnerConfig:
    lr: float = 3e-4
    batch_size: int = 256
    gamma: float = 0.99
    cql_alpha: float = 1.0       # weight of the conservative penalty
    target_update_every: int = 100


class CQLConfig:
    def __init__(self):
        self._obs_dim: Optional[int] = None
        self._num_actions: Optional[int] = None
        self._input_path: Optional[str] = None
        self._dataset: Any = None
        self.hidden = (64, 64)
        self.seed = 0
        self.learner = CQLLearnerConfig()

    def environment(self, *, obs_dim: int, num_actions: int) -> "CQLConfig":
        self._obs_dim = obs_dim
        self._num_actions = num_actions
        return self

    def offline_data(self, input_path: Optional[str] = None, *,
                     dataset: Any = None) -> "CQLConfig":
        self._input_path = input_path
        self._dataset = dataset
        return self

    def training(self, *, lr: Optional[float] = None,
                 train_batch_size: Optional[int] = None,
                 cql_alpha: Optional[float] = None,
                 gamma: Optional[float] = None) -> "CQLConfig":
        if lr is not None:
            self.learner.lr = lr
        if train_batch_size is not None:
            self.learner.batch_size = train_batch_size
        if cql_alpha is not None:
            self.learner.cql_alpha = cql_alpha
        if gamma is not None:
            self.learner.gamma = gamma
        return self

    def build(self, device=None) -> "CQL":
        """CQL on ``device`` (the card unless named)."""
        check_offline_config(self)
        return CQL(self, device=device)


class CQL:
    def __init__(self, config: CQLConfig, device=None):
        self.config = config
        cfg = config.learner
        self.device = resolve_device(device)
        with torch.device("meta"):
            self.net = QNet(config._obs_dim, config._num_actions,
                            tuple(config.hidden))
        self.params = leaf_params(init_weights(
            self.net, torch.Generator().manual_seed(config.seed),
            self.device))
        self.target_params = clone_weights(self.params)
        self.data = offline_data(config)
        self.opt = torch.optim.Adam(list(self.params.values()), lr=cfg.lr,
                                    betas=(0.9, 0.999), eps=1e-8)
        # fixed at build, as the reference's jitted update closes over them
        self._gamma, self._alpha = cfg.gamma, cfg.cql_alpha
        self._steps = 0
        self._epoch = 0

    def q_values(self, params: Weights, obs: torch.Tensor) -> torch.Tensor:
        return functional_call(self.net, params, (obs,))

    def loss(self, params: Weights, target_params: Weights,
             batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        q = self.q_values(params, batch["obs"])                 # [B, A]
        q_data = q.gather(1, batch["action"][:, None])[:, 0]
        with torch.no_grad():
            q_next = self.q_values(target_params, batch["next_obs"])
            target = batch["reward"] + self._gamma * (
                1.0 - batch["done"]) * q_next.max(dim=-1).values
        bellman = (q_data - target).square()
        # CQL(H): push down logsumexp Q, push up the logged action's Q.
        conservative = torch.logsumexp(q, dim=-1) - q_data
        return (0.5 * bellman + self._alpha * conservative).mean()

    def train(self) -> Dict[str, Any]:
        cfg = self.config.learner
        dev = self.device
        losses = []
        for batch in self.data.iter_train_batches(
                batch_size=cfg.batch_size, num_epochs=1,
                seed=self.config.seed + self._epoch):
            tb = {"obs": to_tensor(batch["obs"], dev),
                  "action": to_tensor(batch["action"], dev, np.int64),
                  "reward": to_tensor(batch["reward"], dev),
                  "next_obs": to_tensor(batch["next_obs"], dev),
                  "done": to_tensor(batch["done"], dev)}
            loss = self.loss(self.params, self.target_params, tb)
            self.opt.zero_grad(set_to_none=True)
            loss.backward()
            self.opt.step()
            losses.append(loss.detach())
            self._steps += 1
            if self._steps % cfg.target_update_every == 0:
                self.target_params = clone_weights(self.params)
        self._epoch += 1
        return {"training_iteration": self._epoch,
                "loss": (float(torch.stack(losses).double().mean())
                         if losses else None),
                "num_batches": len(losses)}

    def compute_actions(self, obs: np.ndarray) -> np.ndarray:
        """The greedy action a row (int32)."""
        with torch.no_grad():
            q = self.q_values(self.params,
                              to_tensor(np.atleast_2d(obs), self.device))
        return q.argmax(dim=-1).int().cpu().numpy()

    def evaluate(self, env_fn: Callable, *, n_episodes: int = 10,
                 max_steps: int = 500, seed: int = 1000) -> Dict[str, Any]:
        return evaluate_actions(self.compute_actions, env_fn,
                                n_episodes=n_episodes, max_steps=max_steps,
                                seed=seed)

    def get_weights(self) -> Weights:
        return {k: p.detach() for k, p in self.params.items()}
