"""APPO — asynchronous PPO. Port of ray_tpu/rllib/appo.py (reference:
rllib/algorithms/appo/ — IMPALA's actor-learner architecture with PPO's
clipped surrogate on top of V-trace advantages, plus a slow "target" policy
whose KL anchors the updates while rollouts arrive with policy lag).

The learner's target weights are a real copy of its weights, refreshed
every ``target_update_freq`` updates. The loop is IMPALA's (in this
process, in turns: impala.py), with the APPO learner swapped in.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.impala import (
    IMPALA,
    IMPALAConfig,
    IMPALALearner,
    IMPALALearnerConfig,
    vtrace_terms,
)
from ray_tpu_torch.rllib.rl_module import RLModule, Weights, clone_weights


@dataclasses.dataclass
class APPOLearnerConfig(IMPALALearnerConfig):
    clip_param: float = 0.2  # PPO surrogate clip (reference appo defaults)
    kl_coeff: float = 0.2  # KL(target || current) penalty weight
    target_update_freq: int = 8  # learner updates between target refreshes


class APPOLearner(IMPALALearner):
    """V-trace + clipped-surrogate update with a target policy."""

    def __init__(self, module: RLModule, config: APPOLearnerConfig,
                 seed: int = 0):
        super().__init__(module, config, seed)
        self.target_params = clone_weights(self.params)
        self._updates_since_target = 0

    def loss(self, params: Weights, batch: Dict[str, torch.Tensor]):
        cfg = self.cfg
        v = vtrace_terms(self.module, cfg, params, batch)
        # PPO clipped surrogate on the ratio to the BEHAVIOR policy, which
        # may be several updates stale (reference:
        # appo_torch_learner.compute_loss_for_module).
        rhos, adv = v["rhos"], v["pg_adv"]
        surr = torch.minimum(
            rhos * adv,
            torch.clamp(rhos, 1.0 - cfg.clip_param, 1.0 + cfg.clip_param)
            * adv)
        pg_loss = -torch.mean(surr)
        # KL(target || current) over the rollout states anchors fast
        # updates to the slow policy.
        logp_all = v["logp_all"]
        with torch.no_grad():
            tlogits, _ = self.module.forward_train(self.target_params,
                                                   v["obs"])
            tlogp_all = F.log_softmax(tlogits.reshape(logp_all.shape),
                                      dim=-1)
        kl = torch.mean(torch.sum(torch.exp(tlogp_all)
                                  * (tlogp_all - logp_all), dim=-1))
        loss = (pg_loss + cfg.vf_coeff * v["vf_loss"]
                - cfg.entropy_coeff * v["entropy"] + cfg.kl_coeff * kl)
        return loss, (pg_loss, v["vf_loss"], kl)

    def update(self, rollout: Dict[str, np.ndarray]) -> Dict[str, Any]:
        loss, aux = self._step(rollout)
        self._updates_since_target += 1
        if self._updates_since_target >= self.cfg.target_update_freq:
            self._updates_since_target = 0
            self.target_params = clone_weights(self.params)
        pg, vf, kl = (float(x.detach()) for x in aux)
        return {"loss": float(loss.detach()), "pg_loss": pg, "vf_loss": vf,
                "kl": kl}


class APPOConfig(IMPALAConfig):
    def __init__(self):
        super().__init__()
        self.learner = APPOLearnerConfig()

    def build(self, device=None) -> "APPO":
        return APPO(self, device=device)


class APPO(IMPALA):
    """IMPALA's loop with the APPO learner (reference: appo.py subclasses
    IMPALA the same way)."""

    LEARNER_CLS = APPOLearner
