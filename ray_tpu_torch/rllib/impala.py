"""IMPALA. Port of ray_tpu/rllib/impala.py (reference:
rllib/algorithms/impala/ — env runners feeding a central learner, with
V-trace correcting the policy lag between the behavior weights that sampled
a trajectory and the learner weights that consume it).

The reference keeps every runner actor in flight and consumes whichever
rollout finishes first (``ray_tpu.wait``). The port starts no runtime, so
its runners live in this process and take turns, a stand-in for that actor
loop: at build every runner gets the initial weights and samples one
rollout; each ``training_step`` consumes ONE stored rollout, the one of the
runner relaunched longest ago, then gives that runner alone fresh weights
and lets it sample its next rollout. A consumed rollout was sampled with
the weights its runner got at its relaunch, so the policy lag is
``num_env_runners - 1`` updates, and V-trace corrects it as it corrects the
reference's. The runtime's port brings back the actor loop.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.env_runner import SingleAgentEnvRunner, env_factory
from ray_tpu_torch.rllib.learner import ClippedAdam, leaf_params
from ray_tpu_torch.rllib.rl_module import RLModule, Weights, to_tensor


@dataclasses.dataclass
class IMPALALearnerConfig:
    lr: float = 5e-4
    gamma: float = 0.99
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    rho_clip: float = 1.0  # V-trace rho-bar
    c_clip: float = 1.0  # V-trace c-bar
    max_grad_norm: float = 40.0


def vtrace_targets(values, next_value, rewards, dones, rhos, *,
                   gamma: float, rho_clip: float = 1.0, c_clip: float = 1.0):
    """V-trace targets vs and policy-gradient advantages over [T, N]
    trajectories (reference: IMPALA paper eq. 1). The reference's reverse
    ``lax.scan`` is a reverse loop over T."""
    rho_bar = torch.clamp(rhos, max=rho_clip)
    c_bar = torch.clamp(rhos, max=c_clip)
    nonterm = 1.0 - dones
    # values_{t+1}: shift; bootstrap with next_value at the end.
    values_tp1 = torch.cat([values[1:], next_value[None]], dim=0)
    deltas = rho_bar * (rewards + gamma * nonterm * values_tp1 - values)
    acc = torch.zeros_like(next_value)
    accs = [acc] * values.shape[0]
    for t in range(values.shape[0] - 1, -1, -1):
        acc = deltas[t] + gamma * nonterm[t] * c_bar[t] * acc
        accs[t] = acc
    vs = values + torch.stack(accs)
    vs_tp1 = torch.cat([vs[1:], next_value[None]], dim=0)
    # Policy-gradient advantage uses the V-trace targets.
    pg_adv = rho_bar * (rewards + gamma * nonterm * vs_tp1 - values)
    return vs, pg_adv


def rollout_batch(rollout: Dict[str, np.ndarray], device
                  ) -> Dict[str, torch.Tensor]:
    """A runner's [T, N] rollout as the learners' batch on ``device``."""
    return {
        "obs": to_tensor(rollout["obs"], device),
        "actions": to_tensor(rollout["actions"], device, np.int64),
        "behavior_logp": to_tensor(rollout["logp"], device),
        "rewards": to_tensor(rollout["rewards"], device),
        "dones": to_tensor(rollout["dones"], device),
        "next_value": to_tensor(rollout["last_values"], device),
    }


def vtrace_terms(module: RLModule, cfg, params: Weights,
                 batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """What IMPALA's and APPO's losses share: the forward over the rollout's
    [T * N] states, the behavior ratios, V-trace's targets (no gradient
    through them), the value loss and the entropy."""
    T, N = batch["actions"].shape
    obs = batch["obs"].reshape((T * N,) + batch["obs"].shape[2:])
    logits, values = module.forward_train(params, obs)
    logits = logits.reshape(T, N, -1)
    values = values.reshape(T, N)
    logp_all = F.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, batch["actions"][..., None])[..., 0]
    rhos = torch.exp(logp - batch["behavior_logp"])
    vs, pg_adv = vtrace_targets(
        values.detach(), batch["next_value"], batch["rewards"],
        batch["dones"], rhos.detach(), gamma=cfg.gamma,
        rho_clip=cfg.rho_clip, c_clip=cfg.c_clip)
    return {
        "obs": obs, "logp_all": logp_all, "logp": logp, "rhos": rhos,
        "pg_adv": pg_adv,
        "vf_loss": torch.mean((values - vs) ** 2),
        "entropy": -torch.mean(torch.sum(F.softmax(logits, dim=-1)
                                         * logp_all, dim=-1)),
    }


class IMPALALearner:
    """V-trace actor-critic update over [T, N] trajectories."""

    def __init__(self, module: RLModule, config: IMPALALearnerConfig,
                 seed: int = 0):
        self.module = module
        self.cfg = config
        self.params = leaf_params(module.init_params(seed))
        self.opt = ClippedAdam(self.params, config.lr, config.max_grad_norm)

    def loss(self, params: Weights, batch: Dict[str, torch.Tensor]):
        cfg = self.cfg
        v = vtrace_terms(self.module, cfg, params, batch)
        pg_loss = -torch.mean(v["logp"] * v["pg_adv"])
        return (pg_loss + cfg.vf_coeff * v["vf_loss"]
                - cfg.entropy_coeff * v["entropy"]), ()

    def _step(self, rollout: Dict[str, np.ndarray]):
        """One optimizer step on a rollout: (loss, aux) of the loss."""
        loss, aux = self.loss(self.params,
                              rollout_batch(rollout, self.module.device))
        self.opt.step(list(torch.autograd.grad(loss,
                                               list(self.params.values()))))
        return loss, aux

    def update(self, rollout: Dict[str, np.ndarray]) -> Dict[str, Any]:
        loss, _ = self._step(rollout)
        return {"loss": float(loss.detach())}

    def get_weights(self) -> Weights:
        return {k: p.detach() for k, p in self.params.items()}


class IMPALAConfig:
    def __init__(self):
        self._env_fn: Optional[Callable] = None
        self.num_env_runners = 2
        self.num_envs_per_runner = 4
        self.rollout_length = 32
        self.hidden = (64, 64)
        self.seed = 0
        self.learner = IMPALALearnerConfig()

    def environment(self, env: Any = None, *,
                    env_fn: Optional[Callable] = None) -> "IMPALAConfig":
        self._env_fn = env_factory(env, env_fn)
        return self

    def env_runners(self, *, num_env_runners: int = 2,
                    num_envs_per_env_runner: int = 4,
                    rollout_fragment_length: int = 32) -> "IMPALAConfig":
        self.num_env_runners = num_env_runners
        self.num_envs_per_runner = num_envs_per_env_runner
        self.rollout_length = rollout_fragment_length
        return self

    def training(self, **overrides) -> "IMPALAConfig":
        for k, v in overrides.items():
            if hasattr(self.learner, k):
                setattr(self.learner, k, v)
            elif k == "model_hidden":
                self.hidden = tuple(v)
            else:
                raise ValueError(f"unknown training option {k!r}")
        return self

    def debugging(self, *, seed: int = 0) -> "IMPALAConfig":
        self.seed = seed
        return self

    def build(self, device=None) -> "IMPALA":
        return IMPALA(self, device=device)


class IMPALA:
    """The actor-learner loop, in turns (module docstring): each
    training_step consumes the oldest stored rollout, V-trace corrects its
    policy lag, and only its runner gets fresh weights and samples again."""

    LEARNER_CLS = IMPALALearner  # subclasses (APPO) swap the learner

    def __init__(self, config: IMPALAConfig, device=None):
        assert config._env_fn is not None, "call .environment(...) first"
        self.config = config
        probe = config._env_fn()
        obs_dim = int(np.prod(probe.observation_space.shape))
        num_actions = int(probe.action_space.n)
        self.module = RLModule(obs_dim, num_actions, config.hidden,
                               device=device)
        self.learner = self.LEARNER_CLS(self.module, config.learner,
                                        config.seed)
        self.runners = [
            SingleAgentEnvRunner(config._env_fn, self.module,
                                 config.num_envs_per_runner,
                                 config.seed + 1000 * i)
            for i in range(config.num_env_runners)
        ]
        weights = self.learner.get_weights()
        for r in self.runners:
            r.set_weights(weights)
        # (runner, its rollout), the runner relaunched longest ago first
        self._inflight = collections.deque(
            (r, r.sample(config.rollout_length)) for r in self.runners)
        self.iteration = 0
        self._return_window: List[float] = []

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        runner, rollout = self._inflight.popleft()
        loss = self.learner.update(rollout)["loss"]
        steps = rollout["actions"].size
        # Fresh weights only for the runner being relaunched — the others
        # keep their (lagged) weights; V-trace absorbs the difference.
        runner.set_weights(self.learner.get_weights())
        self._inflight.append((runner, runner.sample(cfg.rollout_length)))
        self._return_window.extend(
            x for r in self.runners for x in r.episode_returns())
        self._return_window = self._return_window[-100:]
        dt = time.perf_counter() - t0
        return {
            "loss": loss,
            "rollouts_consumed": 1,
            "env_steps_this_iter": steps,
            "env_steps_per_s": steps / dt if dt > 0 else 0.0,
            "episode_return_mean": (float(np.mean(self._return_window))
                                    if self._return_window else float("nan")),
        }

    def train(self) -> Dict[str, Any]:
        self.iteration += 1
        out = self.training_step()
        out["training_iteration"] = self.iteration
        return out

    def get_weights(self):
        return self.learner.get_weights()

    def stop(self) -> None:
        pass
