"""PPO Learner + LearnerGroup. Port of ray_tpu/rllib/learner.py (reference:
rllib/core/learner/learner.py, learner_group.py).

The reference jits one update (minibatch SGD over permuted minibatches);
here the same update runs eagerly on the module's device. The optimizer is
``torch.optim.Adam`` behind optax's global-norm clip (``ClippedAdam``).

The reference's LearnerGroup with ``num_learners > 0`` starts learner
actors; the port starts no runtime, so its group holds its learners in this
process, with the reference's seeds (``seed + i``), shards and weight
averaging. The runtime's port makes them actors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.rl_module import RLModule, Weights, to_tensor


@dataclasses.dataclass
class PPOLearnerConfig:
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip: float = 0.2
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    num_epochs: int = 4
    minibatch_size: int = 128
    max_grad_norm: float = 0.5


def compute_gae(batch: Dict[str, np.ndarray], gamma: float,
                lam: float) -> Dict[str, np.ndarray]:
    """Generalized advantage estimation over [T, N] rollouts → flat (numpy;
    a copy of the reference's)."""
    rew, val, done = batch["rewards"], batch["values"], batch["dones"]
    T, N = rew.shape
    adv = np.zeros((T, N), np.float32)
    last_adv = np.zeros(N, np.float32)
    next_val = batch["last_values"]
    for t in range(T - 1, -1, -1):
        nonterm = 1.0 - done[t]
        delta = rew[t] + gamma * next_val * nonterm - val[t]
        last_adv = delta + gamma * lam * nonterm * last_adv
        adv[t] = last_adv
        next_val = val[t]
    ret = adv + val
    flat = lambda x: x.reshape((-1,) + x.shape[2:])
    return {
        "obs": flat(batch["obs"]).astype(np.float32),
        "actions": flat(batch["actions"]),
        "logp": flat(batch["logp"]),
        "advantages": flat(adv),
        "returns": flat(ret),
    }


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float
                         ) -> None:
    """optax.clip_by_global_norm in place: every gradient scaled as
    ``g / norm * max_norm`` when the global norm reaches max_norm, else
    left as it is (torch's clip_grad_norm_ adds 1e-6 to the norm and
    always scales). No host sync."""
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


class ClippedAdam:
    """optax.chain(clip_by_global_norm(max_norm), adam(lr)) over a dict of
    leaf tensors: the clip, then torch.optim.Adam (optax's defaults: betas
    0.9/0.999, eps 1e-8 outside the square root)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 max_norm: float):
        self.params = list(params.values())
        self.max_norm = max_norm
        self.opt = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999),
                                    eps=1e-8)

    def step(self, grads: List[torch.Tensor]) -> None:
        """One update from ``grads`` (clipped in place), in params' order."""
        clip_by_global_norm_(grads, self.max_norm)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.opt.step()


def leaf_params(weights: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Trainable copies of a weights dict."""
    return {k: torch.as_tensor(v).detach().clone().requires_grad_()
            for k, v in weights.items()}


def set_params_(params: Dict[str, torch.Tensor], weights) -> None:
    """Copies ``weights`` (tensors or numpy arrays, e.g. converted from the
    reference) into ``params`` in place."""
    with torch.no_grad():
        for k, p in params.items():
            w = weights[k]
            p.copy_(w if isinstance(w, torch.Tensor)
                    else torch.from_numpy(np.array(w)))


class PPOLearner:
    """One learner: owns params + optimizer state, runs the update."""

    def __init__(self, module: RLModule, config: PPOLearnerConfig,
                 seed: int = 0):
        self.module = module
        self.cfg = config
        self.params = leaf_params(module.init_params(seed))
        self.opt = ClippedAdam(self.params, config.lr, config.max_grad_norm)
        # the minibatch permutations (the reference's PRNGKey(seed + 1))
        self._gen = torch.Generator().manual_seed(seed + 1)

    def loss(self, params: Weights, mb: Dict[str, torch.Tensor]):
        """(total, (pg, vf, entropy)) of ``params`` on a minibatch."""
        cfg = self.cfg
        logits, values = self.module.forward_train(params, mb["obs"])
        logp_all = F.log_softmax(logits, dim=-1)
        logp = logp_all.gather(1, mb["actions"][:, None].long())[:, 0]
        ratio = torch.exp(logp - mb["logp"])
        adv = mb["advantages"]
        # population std (ddof 0), as jnp.std
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        pg = -torch.minimum(
            ratio * adv, torch.clamp(ratio, 1 - cfg.clip, 1 + cfg.clip) * adv
        ).mean()
        vf = torch.mean((values - mb["returns"]) ** 2)
        ent = -torch.mean(torch.sum(F.softmax(logits, dim=-1) * logp_all,
                                    dim=-1))
        return pg + cfg.vf_coeff * vf - cfg.entropy_coeff * ent, (pg, vf, ent)

    def get_weights(self) -> Weights:
        return {k: p.detach() for k, p in self.params.items()}

    def set_weights(self, params) -> None:
        set_params_(self.params, params)

    def update(self, batches: List[Dict[str, np.ndarray]]) -> Dict[str, Any]:
        merged = {k: np.concatenate([b[k] for b in batches])
                  for k in batches[0]}
        dev = self.module.device
        batch = {k: to_tensor(v, dev, v.dtype) for k, v in merged.items()}
        n = merged["obs"].shape[0]
        mb_size = min(self.cfg.minibatch_size, n)
        mbs = max(1, n // mb_size)
        names = list(self.params)
        losses = []
        for _ in range(self.cfg.num_epochs):
            perm = torch.randperm(n, generator=self._gen)
            idxs = perm[: mbs * mb_size].view(mbs, mb_size).to(dev)
            for idx in idxs:
                mb = {k: v[idx] for k, v in batch.items()}
                loss, _ = self.loss(self.params, mb)
                grads = torch.autograd.grad(
                    loss, [self.params[k] for k in names])
                self.opt.step(grads)
                losses.append(loss.detach())
        return {"loss": float(torch.stack(losses).mean()), "batch_size": n}


class LearnerGroup:
    """Group of learners (reference: learner_group.py). With
    ``num_learners > 0`` it holds that many, seeded ``seed + i``; each
    update shards the sample batches over them (``batches[i::n]``) and
    averages their weights after."""

    def __init__(self, module: RLModule, config: PPOLearnerConfig,
                 num_learners: int = 0, seed: int = 0):
        self.learners = [PPOLearner(module, config, seed + i)
                         for i in range(max(num_learners, 1))]

    def update(self, batches: List[Dict[str, np.ndarray]]) -> Dict[str, Any]:
        n = len(self.learners)
        if n == 1:
            return self.learners[0].update(batches)
        shards = [batches[i::n] or batches[:1] for i in range(n)]
        results = [lr.update(s) for lr, s in zip(self.learners, shards)]
        weights = [lr.get_weights() for lr in self.learners]
        avg = {k: sum(w[k] for w in weights) / n for k in weights[0]}
        for lr in self.learners:
            lr.set_weights(avg)
        return {"loss": float(np.mean([r["loss"] for r in results])),
                "batch_size": sum(r["batch_size"] for r in results)}

    def get_weights(self) -> Weights:
        return self.learners[0].get_weights()
