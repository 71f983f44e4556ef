"""Behavior Cloning. Port of ray_tpu/rllib/bc.py (reference:
rllib/algorithms/bc/bc.py — BC trains the policy head with negative
log-likelihood over logged actions, reading batches through the offline
data plane).

One update a batch, run eagerly on the module's device: the mean NLL of
the RLModule's policy logits at the logged actions, stepped by
``torch.optim.Adam`` at optax's defaults (betas 0.9/0.999, eps 1e-8). The
value head takes no part in the loss; its gradients stay None and Adam
leaves it as it is, as optax does with its zero gradients.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.learner import leaf_params
from ray_tpu_torch.rllib.offline import OfflineData, evaluate_actions
from ray_tpu_torch.rllib.rl_module import RLModule, Weights, to_tensor


@dataclasses.dataclass
class BCLearnerConfig:
    lr: float = 1e-3
    batch_size: int = 256
    num_epochs: int = 4


class BCConfig:
    """Builder-style config (reference: bc.py BCConfig)."""

    def __init__(self):
        self._obs_dim: Optional[int] = None
        self._num_actions: Optional[int] = None
        self._input_path: Optional[str] = None
        self._dataset: Any = None
        self.hidden = (64, 64)
        self.seed = 0
        self.learner = BCLearnerConfig()

    def environment(self, *, obs_dim: int, num_actions: int) -> "BCConfig":
        self._obs_dim = obs_dim
        self._num_actions = num_actions
        return self

    def offline_data(self, input_path: Optional[str] = None, *,
                     dataset: Any = None) -> "BCConfig":
        self._input_path = input_path
        self._dataset = dataset
        return self

    def training(self, *, lr: Optional[float] = None,
                 train_batch_size: Optional[int] = None,
                 num_epochs: Optional[int] = None) -> "BCConfig":
        if lr is not None:
            self.learner.lr = lr
        if train_batch_size is not None:
            self.learner.batch_size = train_batch_size
        if num_epochs is not None:
            self.learner.num_epochs = num_epochs
        return self

    def build(self, device=None) -> "BC":
        """BC on ``device`` (the card unless named)."""
        check_offline_config(self)
        return BC(self, device=device)


def check_offline_config(config) -> None:
    """Raises unless ``.environment()`` and ``.offline_data()`` were
    called (BCConfig and CQLConfig)."""
    if not (config._obs_dim and config._num_actions):
        raise ValueError("call .environment(obs_dim=, num_actions=)")
    if not (config._input_path or config._dataset is not None):
        raise ValueError("call .offline_data()")


def offline_data(config) -> OfflineData:
    return OfflineData(config._dataset if config._dataset is not None
                       else config._input_path)


class BC:
    def __init__(self, config: BCConfig, device=None):
        self.config = config
        self.module = RLModule(config._obs_dim, config._num_actions,
                               config.hidden, device=device)
        self.params = leaf_params(self.module.init_params(config.seed))
        self.data = offline_data(config)
        self.opt = torch.optim.Adam(list(self.params.values()),
                                    lr=config.learner.lr, betas=(0.9, 0.999),
                                    eps=1e-8)
        self._epoch = 0

    def loss(self, params: Weights, obs: torch.Tensor,
             actions: torch.Tensor) -> torch.Tensor:
        logits, _ = self.module.forward_train(params, obs)
        logp = F.log_softmax(logits, dim=-1)
        return -logp.gather(1, actions[:, None])[:, 0].mean()

    def train(self) -> Dict[str, Any]:
        """One pass over the offline dataset, shuffled by ``seed + epoch``
        (reference: Algorithm.train() iteration contract)."""
        cfg = self.config.learner
        dev = self.module.device
        losses = []
        for batch in self.data.iter_train_batches(
                batch_size=cfg.batch_size, num_epochs=1,
                seed=self.config.seed + self._epoch):
            loss = self.loss(self.params, to_tensor(batch["obs"], dev),
                             to_tensor(batch["action"], dev, np.int64))
            self.opt.zero_grad(set_to_none=True)
            loss.backward()
            self.opt.step()
            losses.append(loss.detach())
        self._epoch += 1
        return {"training_iteration": self._epoch,
                "loss": (float(torch.stack(losses).double().mean())
                         if losses else None),
                "num_batches": len(losses)}

    def compute_actions(self, obs: np.ndarray) -> np.ndarray:
        """The argmax action a row (int32)."""
        with torch.no_grad():
            logits, _ = self.module.forward_train(
                self.params, to_tensor(np.atleast_2d(obs),
                                       self.module.device))
        return logits.argmax(dim=-1).int().cpu().numpy()

    def evaluate(self, env_fn: Callable, *, n_episodes: int = 10,
                 max_steps: int = 500, seed: int = 1000) -> Dict[str, Any]:
        return evaluate_actions(self.compute_actions, env_fn,
                                n_episodes=n_episodes, max_steps=max_steps,
                                seed=seed)

    def get_weights(self) -> Weights:
        return {k: p.detach() for k, p in self.params.items()}
