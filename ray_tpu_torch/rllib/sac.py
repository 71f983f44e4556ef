"""SAC — continuous-control soft actor-critic. Port of ray_tpu/rllib/sac.py
(reference: rllib/algorithms/sac/; off-policy replay like dqn.py).

Module: tanh-squashed Gaussian policy + twin Q networks + learned entropy
temperature (alpha) against a target entropy of -|A|. One step trains the
critics, then the policy, then alpha, then Polyak-averages the target
critics, as the reference's jitted step does.

The step is a function of explicit noise (``SACLearner.step(mb, eps_q,
eps_pi)``): the two standard-normal draws of the policy's mean shape that
the reference takes from its key splits. ``update`` draws them from the
learner's generator; a test can pass the reference's own draws instead.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup
from ray_tpu_torch.rllib.learner import ClippedAdam, leaf_params
from ray_tpu_torch.rllib.rl_module import (
    Weights,
    clone_weights,
    dense_stack,
    init_weights,
    to_tensor,
)
from ray_tpu_torch.utils.device import resolve_device


class GaussianPolicy(nn.Module):
    def __init__(self, obs_dim: int, act_dim: int,
                 hidden: Sequence[int] = (64, 64)):
        super().__init__()
        self.hidden = tuple(hidden)
        n = len(self.hidden)
        widths = (obs_dim,) + self.hidden
        dense_stack(self, widths)
        self.add_module(f"Dense_{n}", nn.Linear(widths[-1], act_dim))
        self.add_module(f"Dense_{n + 1}", nn.Linear(widths[-1], act_dim))

    def forward(self, obs):
        x = obs
        n = len(self.hidden)
        for i in range(n):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
        mean = getattr(self, f"Dense_{n}")(x)
        # Tight upper clip: with tanh squashing, std beyond ~1.6 mostly
        # saturates the action to +-1, collapsing exploration to the
        # corners and starving the critics of interior-action data.
        log_std = torch.clamp(getattr(self, f"Dense_{n + 1}")(x), -5.0, 0.5)
        return mean, log_std


class TwinQ(nn.Module):
    def __init__(self, obs_dim: int, act_dim: int,
                 hidden: Sequence[int] = (64, 64)):
        super().__init__()
        self.hidden = tuple(hidden)
        widths = (obs_dim + act_dim,) + self.hidden
        for name in ("q1", "q2"):
            for i in range(len(self.hidden)):
                self.add_module(f"{name}_d{i}",
                                nn.Linear(widths[i], widths[i + 1]))
            self.add_module(f"{name}_out", nn.Linear(widths[-1], 1))

    def forward(self, obs, act):
        def q(name):
            x = torch.cat([obs, act], dim=-1)
            for i in range(len(self.hidden)):
                x = torch.relu(getattr(self, f"{name}_d{i}")(x))
            return getattr(self, f"{name}_out")(x)[..., 0]

        return q("q1"), q("q2")


def _tanh_gaussian_logp(pre, mean, log_std):
    var = torch.exp(2 * log_std)
    base = -0.5 * ((pre - mean) ** 2 / var + 2 * log_std
                   + math.log(2 * math.pi))
    # Epsilon-bounded tanh change of variables (the standard SAC form):
    # the exact 2(log2 - x - softplus(-2x)) correction is unbounded in
    # |x|, which makes "drive the pre-activation to +-inf" a degenerate
    # direction that farms -alpha*logp linearly and inflates the soft-Q
    # targets; the epsilon floor caps that profit at ~13.8 nats/dim.
    corr = torch.log(1.0 - torch.tanh(pre) ** 2 + 1e-6)
    return (base + corr).sum(dim=-1)


class SACModule:
    """Runner-compatible module: forward_inference returns (action, logp,
    value≡0) so SingleAgentEnvRunner's buffers work unchanged; actions are
    float vectors in [-1, 1]^act_dim (scale in the env wrapper). Its
    weights are the policy's (``Dense_i``); ``init_params`` gives
    ``{"policy": ..., "q": ...}``, as the reference's tree."""

    def __init__(self, obs_dim: int, act_dim: int,
                 hidden: Tuple[int, ...] = (64, 64), device=None):
        self.obs_dim = obs_dim
        self.act_dim = act_dim
        self.hidden = tuple(hidden)
        self.device = resolve_device(device)
        with torch.device("meta"):
            self.policy = GaussianPolicy(obs_dim, act_dim, self.hidden)
            self.qnet = TwinQ(obs_dim, act_dim, self.hidden)

    def init_params(self, seed: int) -> Dict[str, Weights]:
        gen = torch.Generator().manual_seed(seed)
        return {"policy": init_weights(self.policy, gen, self.device),
                "q": init_weights(self.qnet, gen, self.device)}

    def policy_dist(self, params: Weights, obs: torch.Tensor):
        """(mean, log_std) of the policy ``params`` at ``obs``."""
        return functional_call(self.policy, params, (obs,))

    def q_values(self, params: Weights, obs, act):
        return functional_call(self.qnet, params, (obs, act))

    def forward_inference(self, weights: Weights, obs: np.ndarray,
                          generator: torch.Generator):
        with torch.no_grad():
            mean, log_std = self.policy_dist(weights,
                                             to_tensor(obs, self.device))
            eps = torch.randn(mean.shape, generator=generator,
                              device=self.device)
            pre = mean + torch.exp(log_std) * eps
            act = torch.tanh(pre)
            logp = _tanh_gaussian_logp(pre, mean, log_std)
        return (act.cpu().numpy(), logp.cpu().numpy(),
                np.zeros((obs.shape[0],), np.float32))

    def __getstate__(self):
        return {"obs_dim": self.obs_dim, "act_dim": self.act_dim,
                "hidden": self.hidden, "device": str(self.device)}

    def __setstate__(self, state):
        self.__init__(**state)


@dataclasses.dataclass
class SACLearnerConfig:
    lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.01  # Polyak rate for target critics
    batch_size: int = 128
    sgd_steps_per_iter: int = 32
    init_alpha: float = 0.02


class SACLearner:
    """Trains policy + critics + alpha and Polyak-updates the target
    critics, all on the module's device (the host sees scalars)."""

    def __init__(self, module: SACModule, config: SACLearnerConfig,
                 seed: int = 0):
        self.module = module
        self.cfg = config
        params = module.init_params(seed)
        self.state = {
            "policy": leaf_params(params["policy"]),
            "q": leaf_params(params["q"]),
            "q_target": clone_weights(params["q"]),
            "log_alpha": torch.tensor(
                np.log(config.init_alpha), dtype=torch.float32,
                device=module.device, requires_grad=True),
        }
        self.opt = {
            "policy": ClippedAdam(self.state["policy"], config.lr, 10.0),
            "q": ClippedAdam(self.state["q"], config.lr, 10.0),
            "alpha": ClippedAdam({"log_alpha": self.state["log_alpha"]},
                                 config.lr, 10.0),
        }
        self.target_entropy = -float(module.act_dim)
        # the step's noise (the reference's PRNGKey(seed + 1))
        self._gen = torch.Generator(device=module.device).manual_seed(
            seed + 1)

    def _sample(self, pp: Weights, obs, eps):
        mean, log_std = self.module.policy_dist(pp, obs)
        pre = mean + torch.exp(log_std) * eps
        return torch.tanh(pre), _tanh_gaussian_logp(pre, mean, log_std)

    def q_loss(self, qp: Weights, mb, eps) -> torch.Tensor:
        s = self.state
        with torch.no_grad():
            nact, nlogp = self._sample(s["policy"], mb["next_obs"], eps)
            tq1, tq2 = self.module.q_values(s["q_target"], mb["next_obs"],
                                            nact)
            alpha = torch.exp(s["log_alpha"])
            soft_q = torch.minimum(tq1, tq2) - alpha * nlogp
            target = mb["rewards"] + self.cfg.gamma * (1 - mb["dones"]) \
                * soft_q
        q1, q2 = self.module.q_values(qp, mb["obs"], mb["actions"])
        return ((q1 - target) ** 2 + (q2 - target) ** 2).mean()

    def pi_loss(self, pp: Weights, mb, eps):
        act, logp = self._sample(pp, mb["obs"], eps)
        q1, q2 = self.module.q_values(self.state["q"], mb["obs"], act)
        alpha = torch.exp(self.state["log_alpha"]).detach()
        return (alpha * logp - torch.minimum(q1, q2)).mean(), logp

    def alpha_loss(self, log_alpha, logp) -> torch.Tensor:
        return (-torch.exp(log_alpha)
                * (logp + self.target_entropy).detach()).mean()

    def step(self, mb: Dict[str, torch.Tensor], eps_q: torch.Tensor,
             eps_pi: torch.Tensor):
        """One SAC step on a minibatch with the given noise: (q loss, policy
        loss, alpha loss)."""
        s, opt = self.state, self.opt
        ql = self.q_loss(s["q"], mb, eps_q)
        opt["q"].step(list(torch.autograd.grad(ql, list(s["q"].values()))))
        pl, logp = self.pi_loss(s["policy"], mb, eps_pi)
        opt["policy"].step(list(torch.autograd.grad(
            pl, list(s["policy"].values()))))
        al = self.alpha_loss(s["log_alpha"], logp)
        opt["alpha"].step(list(torch.autograd.grad(al, [s["log_alpha"]])))
        tau = self.cfg.tau
        with torch.no_grad():
            for k, t in s["q_target"].items():
                t.copy_(t * (1 - tau) + s["q"][k] * tau)
        return ql.detach(), pl.detach(), al.detach()

    def update(self, minibatches: List[Dict[str, np.ndarray]]
               ) -> Dict[str, Any]:
        dev = self.module.device
        qls, pls = [], []
        for mb in minibatches:
            mb = {k: to_tensor(v, dev) for k, v in mb.items()}
            shape = (mb["obs"].shape[0], self.module.act_dim)
            eps_q = torch.randn(shape, generator=self._gen, device=dev)
            eps_pi = torch.randn(shape, generator=self._gen, device=dev)
            ql, pl, _ = self.step(mb, eps_q, eps_pi)
            qls.append(ql)
            pls.append(pl)
        return {"q_loss": float(torch.stack(qls).mean()),
                "pi_loss": float(torch.stack(pls).mean()),
                "alpha": float(torch.exp(self.state["log_alpha"].detach())),
                "sgd_steps": len(qls)}

    def get_policy_weights(self) -> Weights:
        return {k: p.detach() for k, p in self.state["policy"].items()}


class _SACReplay:
    def __init__(self, capacity: int, obs_dim: int, act_dim: int):
        self.capacity = capacity
        self.obs = np.empty((capacity, obs_dim), np.float32)
        self.next_obs = np.empty((capacity, obs_dim), np.float32)
        self.actions = np.empty((capacity, act_dim), np.float32)
        self.rewards = np.empty((capacity,), np.float32)
        self.dones = np.empty((capacity,), np.float32)
        self.size = 0
        self._idx = 0

    def add(self, obs, actions, rewards, next_obs, dones) -> None:
        for i in range(obs.shape[0]):
            j = self._idx
            self.obs[j] = obs[i]
            self.next_obs[j] = next_obs[i]
            self.actions[j] = actions[i]
            self.rewards[j] = rewards[i]
            self.dones[j] = dones[i]
            self._idx = (j + 1) % self.capacity
            self.size = min(self.size + 1, self.capacity)

    def sample(self, n: int, rng) -> Dict[str, np.ndarray]:
        idx = rng.integers(0, self.size, size=n)
        return {"obs": self.obs[idx], "actions": self.actions[idx],
                "rewards": self.rewards[idx],
                "next_obs": self.next_obs[idx], "dones": self.dones[idx]}


class SACConfig:
    def __init__(self):
        self._env_fn: Optional[Callable] = None
        self.num_env_runners = 1
        self.num_envs_per_runner = 4
        self.rollout_length = 32
        self.hidden = (64, 64)
        self.seed = 0
        self.buffer_capacity = 100_000
        self.learn_start = 500
        self.learner = SACLearnerConfig()

    def environment(self, env_fn: Callable) -> "SACConfig":
        self._env_fn = env_fn
        return self

    def env_runners(self, *, num_env_runners: int = 1,
                    num_envs_per_env_runner: int = 4,
                    rollout_fragment_length: int = 32) -> "SACConfig":
        self.num_env_runners = num_env_runners
        self.num_envs_per_runner = num_envs_per_env_runner
        self.rollout_length = rollout_fragment_length
        return self

    def training(self, **overrides) -> "SACConfig":
        for k, v in overrides.items():
            if hasattr(self.learner, k):
                setattr(self.learner, k, v)
            elif k in ("buffer_capacity", "learn_start"):
                setattr(self, k, int(v))
            elif k == "model_hidden":
                self.hidden = tuple(v)
            else:
                raise ValueError(f"unknown training option {k!r}")
        return self

    def debugging(self, *, seed: int = 0) -> "SACConfig":
        self.seed = seed
        return self

    def build(self, device=None) -> "SAC":
        return SAC(self, device=device)


class SAC:
    """training_step: sample (stochastic policy) → replay add → SAC updates
    → sync policy weights (reference: sac.py training_step)."""

    def __init__(self, config: SACConfig, device=None):
        assert config._env_fn is not None, "call .environment(...) first"
        self.config = config
        probe = config._env_fn()
        obs_dim = int(np.prod(probe.observation_space.shape))
        act_dim = int(np.prod(probe.action_space.shape))
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.module = SACModule(obs_dim, act_dim, config.hidden,
                                device=device)
        self.learner = SACLearner(self.module, config.learner, config.seed)
        self.buffer = _SACReplay(config.buffer_capacity, obs_dim, act_dim)
        self.env_runners = EnvRunnerGroup(
            config._env_fn, self.module,
            num_runners=config.num_env_runners,
            num_envs_per_runner=config.num_envs_per_runner,
            seed=config.seed)
        self._rng = np.random.default_rng(config.seed)
        self.env_steps = 0
        self.iteration = 0
        self._return_window: List[float] = []
        self._sync()

    def _sync(self) -> None:
        self.env_runners.sync_weights(self.learner.get_policy_weights())

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        rollouts = self.env_runners.sample(cfg.rollout_length)
        for r in rollouts:
            obs, act = r["obs"], r["actions"]
            T = obs.shape[0]
            flat = lambda x: x[:T - 1].reshape((-1,) + x.shape[2:])
            self.buffer.add(
                flat(obs).reshape(-1, self.obs_dim),
                flat(act).reshape(-1, self.act_dim),
                flat(r["rewards"]).ravel(),
                obs[1:].reshape(-1, self.obs_dim),
                flat(r["dones"]).ravel())
            self.env_steps += T * obs.shape[1]
        result: Dict[str, Any] = {"q_loss": float("nan"),
                                  "pi_loss": float("nan"), "sgd_steps": 0}
        if self.buffer.size >= max(cfg.learn_start, cfg.learner.batch_size):
            mbs = [self.buffer.sample(cfg.learner.batch_size, self._rng)
                   for _ in range(cfg.learner.sgd_steps_per_iter)]
            result = self.learner.update(mbs)
        self._sync()
        self._return_window.extend(self.env_runners.episode_returns())
        self._return_window = self._return_window[-100:]
        dt = time.perf_counter() - t0
        steps = (cfg.rollout_length * cfg.num_envs_per_runner
                 * cfg.num_env_runners)
        return {
            **result,
            "env_steps_total": self.env_steps,
            "env_steps_per_s": steps / dt,
            "episode_return_mean": (float(np.mean(self._return_window))
                                    if self._return_window
                                    else float("nan")),
        }

    def train(self) -> Dict[str, Any]:
        self.iteration += 1
        out = self.training_step()
        out["training_iteration"] = self.iteration
        return out

    def get_weights(self):
        return self.learner.get_policy_weights()

    def stop(self) -> None:
        pass
