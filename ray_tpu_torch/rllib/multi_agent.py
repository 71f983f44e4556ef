"""Multi-agent RL: MultiRLModule + per-agent episodes + connectors. Port of
ray_tpu/rllib/multi_agent.py (reference:
rllib/core/rl_module/multi_rl_module.py:49, rllib/env/multi_agent_env.py,
rllib/connectors/).

Each policy (module_id) is an independent RLModule on one device. The
env->module connector gathers per-agent observations across env instances
into one batched forward per module a timestep, then scatters actions back
per agent. Agent -> policy wiring is a ``policy_mapping_fn(agent_id) ->
module_id``, so many agents can share one policy or each own one.

The reference's env runners are actors of its runtime; the port's live in
this process, seeded as the reference seeds its actors (``seed + 1000 *
i``), as PR 14's single-agent runners do. Entry points run on the card
unless ``build(device=...)`` names another device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.rllib.learner import (
    PPOLearner,
    PPOLearnerConfig,
    compute_gae,
)
from ray_tpu_torch.rllib.rl_module import (
    RLModule,
    Weights,
    clone_weights,
    init_weights,
)
from ray_tpu_torch.utils.device import resolve_device


class MultiRLModule:
    """Dict-of-modules container (reference: multi_rl_module.py:49): a
    plain mapping of independent RLModules, all on one device."""

    def __init__(self, modules: Dict[str, RLModule]):
        self._modules = dict(modules)
        devices = {m.device for m in self._modules.values()}
        if len(devices) > 1:
            raise ValueError(f"modules on several devices: {devices}")
        self.device = devices.pop() if devices else None

    def __getitem__(self, module_id: str) -> RLModule:
        return self._modules[module_id]

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def init_params(self, seed: int = 0) -> Dict[str, Weights]:
        """Each module's weights, drawn in turn from one generator seeded
        ``seed`` over the sorted module ids (the reference splits
        ``PRNGKey(seed)`` over them), so no two modules share a draw."""
        gen = torch.Generator().manual_seed(seed)
        return {mid: init_weights(m.net, gen, m.device)
                for mid, m in sorted(self._modules.items())}


# ---------------------------------------------------------------------------
# Connectors (reference: rllib/connectors/connector_v2.py). numpy only.
# ---------------------------------------------------------------------------
class AgentToModuleConnector:
    """Groups per-agent observations by module id into batched arrays.

    Input: list of (env_idx, agent_id, obs); output: {module_id:
    (indices, obs_batch)} where indices recover the original order."""

    def __init__(self, policy_mapping_fn: Callable[[str], str]):
        self.policy_mapping_fn = policy_mapping_fn

    def __call__(self, rows: List[Tuple[int, str, np.ndarray]]
                 ) -> Dict[str, Tuple[List[int], np.ndarray]]:
        grouped: Dict[str, Tuple[List[int], List[np.ndarray]]] = {}
        for i, (_, agent_id, obs) in enumerate(rows):
            mid = self.policy_mapping_fn(agent_id)
            idxs, obs_list = grouped.setdefault(mid, ([], []))
            idxs.append(i)
            obs_list.append(obs)
        return {mid: (idxs, np.stack(obs_list).astype(np.float32))
                for mid, (idxs, obs_list) in grouped.items()}


class ModuleToAgentConnector:
    """Scatters batched module outputs back to per-agent slots."""

    def __call__(self, n_rows: int,
                 outputs: Dict[str, Tuple[List[int], Any, Any, Any]]
                 ) -> List[Tuple[int, float, float]]:
        flat: List[Any] = [None] * n_rows
        for idxs, actions, logps, values in outputs.values():
            for j, i in enumerate(idxs):
                flat[i] = (int(actions[j]), float(logps[j]),
                           float(values[j]))
        return flat


# ---------------------------------------------------------------------------
# Per-agent episodes
# ---------------------------------------------------------------------------
class MultiAgentEpisode:
    """Per-agent trajectory accumulator for ONE env episode (reference:
    rllib/env/multi_agent_episode.py). Agents may act on different steps
    (turn-based envs); each agent's own trajectory stays contiguous."""

    def __init__(self):
        self.steps: Dict[str, Dict[str, List[Any]]] = {}
        self.total_rewards: Dict[str, float] = {}

    def add(self, agent_id: str, obs, action, logp, value, reward,
            done) -> None:
        tr = self.steps.setdefault(agent_id, {
            "obs": [], "actions": [], "logp": [], "values": [],
            "rewards": [], "dones": []})
        tr["obs"].append(obs)
        tr["actions"].append(action)
        tr["logp"].append(logp)
        tr["values"].append(value)
        tr["rewards"].append(reward)
        tr["dones"].append(done)
        self.total_rewards[agent_id] = \
            self.total_rewards.get(agent_id, 0.0) + reward

    def trajectories(self) -> Dict[str, Dict[str, np.ndarray]]:
        out = {}
        for agent_id, tr in self.steps.items():
            out[agent_id] = {
                "obs": np.stack(tr["obs"]).astype(np.float32),
                "actions": np.asarray(tr["actions"]),
                "logp": np.asarray(tr["logp"], np.float32),
                "values": np.asarray(tr["values"], np.float32),
                "rewards": np.asarray(tr["rewards"], np.float32),
                "dones": np.asarray(tr["dones"], np.float32),
            }
        return out


class MultiAgentEnvRunner:
    """Steps N multi-agent env instances with one batched forward per
    module per timestep (the connector pair does the gather/scatter).

    Env protocol (reference: multi_agent_env.py): reset() ->
    {agent: obs}; step({agent: action}) -> (obs_d, rew_d, done_d) where
    done_d["__all__"] ends the episode. Only agents present in the obs
    dict act on a step (turn-based envs supported). Actions are drawn from
    a generator on the module's device seeded ``seed`` (the reference's
    ``PRNGKey(seed)``)."""

    def __init__(self, env_fn, module: MultiRLModule,
                 policy_mapping_fn, num_envs: int = 4, seed: int = 0):
        self.envs = [env_fn() for _ in range(num_envs)]
        self.module = module
        self.gather = AgentToModuleConnector(policy_mapping_fn)
        self.scatter = ModuleToAgentConnector()
        self.policy_mapping_fn = policy_mapping_fn
        self.params: Optional[Dict[str, Weights]] = None
        self._gen = torch.Generator(device=module.device).manual_seed(seed)
        self.obs: List[Dict[str, Any]] = [env.reset(seed=seed + i)
                                          for i, env in enumerate(self.envs)]
        self.episodes = [MultiAgentEpisode() for _ in self.envs]
        self._finished: List[MultiAgentEpisode] = []
        self._done_returns: List[Dict[str, float]] = []

    def set_weights(self, params: Dict[str, Weights]) -> None:
        """Holds a copy of ``params`` (no storage shared with the
        learners', which their optimizers update in place)."""
        self.params = clone_weights(params)

    def _value(self, aid: str, obs) -> np.ndarray:
        """The bootstrap value of one agent's observation, [1]."""
        mid = self.policy_mapping_fn(aid)
        _, _, v = self.module[mid].forward_inference(
            self.params[mid], np.asarray(obs, np.float32)[None], self._gen)
        return np.asarray(v, np.float32)

    def sample(self, num_steps: int) -> Dict[str, List[Dict[str, Any]]]:
        """num_steps env steps across all instances. Returns module_id ->
        list of per-agent trajectory dicts (with bootstrap last_values).

        Trajectories are cut at the end of every call, as the reference
        cuts them: an agent still acting is bootstrapped with its value,
        and its episode's reward so far is dropped from the episode
        returns (``episode_rewards`` counts only the part after the last
        cut)."""
        for _ in range(num_steps):
            rows = [(e, aid, np.asarray(obs, np.float32))
                    for e, od in enumerate(self.obs)
                    for aid, obs in od.items()]
            if not rows:
                break
            outputs = {}
            for mid, (idxs, obs_batch) in self.gather(rows).items():
                a, lp, v = self.module[mid].forward_inference(
                    self.params[mid], obs_batch, self._gen)
                outputs[mid] = (idxs, a, lp, v)
            flat = self.scatter(len(rows), outputs)
            acts: List[Dict[str, int]] = [{} for _ in self.envs]
            meta: List[Dict[str, Tuple[float, float]]] = [
                {} for _ in self.envs]
            for (e, aid, _), (action, logp, value) in zip(rows, flat):
                acts[e][aid] = action
                meta[e][aid] = (logp, value)
            for e, env in enumerate(self.envs):
                if not acts[e]:
                    continue
                nobs, rews, dones = env.step(acts[e])
                ep = self.episodes[e]
                for aid in acts[e]:
                    logp, value = meta[e][aid]
                    ep.add(aid, self.obs[e][aid], acts[e][aid], logp,
                           value, float(rews.get(aid, 0.0)),
                           float(dones.get(aid, dones.get("__all__",
                                                          False))))
                if dones.get("__all__"):
                    self._done_returns.append(dict(ep.total_rewards))
                    self._finished.append(ep)
                    self.episodes[e] = MultiAgentEpisode()
                    # no seed: the env's generator carries on
                    self.obs[e] = env.reset()
                else:
                    self.obs[e] = nobs
        out: Dict[str, List[Dict[str, Any]]] = {mid: []
                                                for mid in self.module.keys()}
        for ep in self._finished:
            for aid, tr in ep.trajectories().items():
                tr["last_values"] = np.zeros((1,), np.float32)
                out[self.policy_mapping_fn(aid)].append(tr)
        self._finished = []
        for e, ep in enumerate(self.episodes):
            trs = ep.trajectories()
            if not trs:
                continue
            for aid, tr in trs.items():
                tr["last_values"] = (self._value(aid, self.obs[e][aid])
                                     if aid in self.obs[e]
                                     else np.zeros((1,), np.float32))
                out[self.policy_mapping_fn(aid)].append(tr)
            self.episodes[e] = MultiAgentEpisode()
        return out

    def episode_rewards(self) -> List[Dict[str, float]]:
        out, self._done_returns = self._done_returns, []
        return out


def agent_gae(tr: Dict[str, np.ndarray], gamma: float,
              lam: float) -> Dict[str, np.ndarray]:
    """GAE over one agent's trajectory through compute_gae's [T, N] path
    with N = 1 (the reference's training_step, multi_agent.py:318-331)."""
    b2 = {k: (v[:, None] if k != "last_values" and v.ndim == 1 else v)
          for k, v in tr.items()}
    if b2["obs"].ndim == 2:
        b2["obs"] = tr["obs"][:, None, :]
    return compute_gae(b2, gamma, lam)


# ---------------------------------------------------------------------------
# Multi-agent PPO
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class MultiAgentPPOConfig:
    policies: Dict[str, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)  # module_id -> (obs_dim, num_actions)
    policy_mapping_fn: Optional[Callable[[str], str]] = None
    hidden: Sequence[int] = (64, 64)
    learner: PPOLearnerConfig = dataclasses.field(
        default_factory=PPOLearnerConfig)
    num_env_runners: int = 2
    num_envs_per_runner: int = 2
    rollout_length: int = 64
    seed: int = 0
    _env_fn: Optional[Callable[[], Any]] = None

    def environment(self, env_fn) -> "MultiAgentPPOConfig":
        self._env_fn = env_fn
        return self

    def multi_agent(self, *, policies, policy_mapping_fn
                    ) -> "MultiAgentPPOConfig":
        self.policies = dict(policies)
        self.policy_mapping_fn = policy_mapping_fn
        return self

    def build(self, device=None) -> "MultiAgentPPO":
        return MultiAgentPPO(self, device=device)


class MultiAgentPPO:
    """PPO over a MultiRLModule: one PPOLearner per policy (seeded
    ``seed + i`` over the sorted ids), a shared fleet of env runners, GAE
    on each agent's trajectory before the per-module minibatch update
    (reference: the multi-agent PPO stack under rllib/algorithms/ppo +
    MultiRLModule)."""

    def __init__(self, config: MultiAgentPPOConfig, device=None):
        if config._env_fn is None:
            raise ValueError("call .environment(...) first")
        if not config.policies:
            raise ValueError("call .multi_agent(...) first")
        self.config = config
        device = resolve_device(device)
        self.module = MultiRLModule({
            mid: RLModule(obs_dim, num_actions, config.hidden, device=device)
            for mid, (obs_dim, num_actions) in config.policies.items()})
        self.learners = {
            mid: PPOLearner(self.module[mid], config.learner,
                            seed=config.seed + i)
            for i, mid in enumerate(sorted(config.policies))}
        self.runners = [
            MultiAgentEnvRunner(config._env_fn, self.module,
                                config.policy_mapping_fn,
                                config.num_envs_per_runner,
                                config.seed + 1000 * i)
            for i in range(config.num_env_runners)]
        self._sync_weights()
        self.iteration = 0
        self._reward_window: List[Dict[str, float]] = []

    def _sync_weights(self) -> None:
        params = self.get_weights()
        for r in self.runners:
            r.set_weights(params)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        samples = [r.sample(cfg.rollout_length) for r in self.runners]
        t_sample = time.perf_counter() - t0
        t1 = time.perf_counter()
        losses: Dict[str, float] = {}
        steps = 0
        for mid, learner in self.learners.items():
            batches = [agent_gae(tr, cfg.learner.gamma,
                                 cfg.learner.gae_lambda)
                       for per_runner in samples
                       for tr in per_runner.get(mid, [])]
            if not batches:
                continue
            merged = {k: np.concatenate([b[k] for b in batches])
                      for k in batches[0]}
            steps += merged["obs"].shape[0]
            losses[mid] = learner.update([merged])["loss"]
        t_learn = time.perf_counter() - t1
        self._sync_weights()
        for r in self.runners:
            self._reward_window.extend(r.episode_rewards())
        self._reward_window = self._reward_window[-100:]
        mean_rewards = {}
        for mid in self.learners:
            vals = [ep[aid] for ep in self._reward_window for aid in ep
                    if cfg.policy_mapping_fn(aid) == mid]
            mean_rewards[mid] = (float(np.mean(vals)) if vals
                                 else float("nan"))
        t_total = time.perf_counter() - t0
        return {
            "losses": losses,
            "env_steps_this_iter": steps,
            "env_steps_per_s": steps / t_total,
            "sample_time_s": t_sample,
            "learn_time_s": t_learn,
            "episode_reward_mean": mean_rewards,
            "time_s": t_total,
        }

    def train(self) -> Dict[str, Any]:
        self.iteration += 1
        out = self.training_step()
        out["training_iteration"] = self.iteration
        return out

    def get_weights(self) -> Dict[str, Weights]:
        return {mid: ln.get_weights() for mid, ln in self.learners.items()}

    def stop(self) -> None:
        pass
