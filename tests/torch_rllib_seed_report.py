"""Learning checks over seeds, the port against the reference, on the CPU
(not a pytest file).

    JAX_PLATFORMS=cpu python tests/torch_rllib_seed_report.py 0 1 2 3
    JAX_PLATFORMS=cpu python tests/torch_rllib_seed_report.py chase 0 1 2 3

Runs the reference's pixel learning config
(tests/test_rllib_sac_pixels.py:66-92: 8 envs of the 84x84 gridworld,
rollout 24, lr 1e-3, 4 epochs, minibatch 64, 12 iterations) once per seed
through ray_tpu_torch's PPO (``build(device="cpu")``) and through the
reference's own runner and learner classes called in this process (its
PPO.training_step without the runtime: sample, GAE, update, sync), and
prints each run's window-mean returns and whether late > early + 0.1, the
test's assertion. The two draw from different generators (torch cannot
reproduce JAX's PRNG), so a seed is a different draw in each: compare how
often each clears the check, not seed by seed.

``chase`` runs the multi-agent learning test instead
(tests/test_rllib_multi_agent.py:79-115: two PPO policies on ChaseEnv,
hidden (32, 32), lr 1e-3, entropy 0.003, minibatch 256, 2 runners x 4
envs, rollout 64, 35 iterations, the config's seed the given one; then
each trained policy against a random opponent over 100 episodes must beat
random_baseline(150) by more than 0.3) through ray_tpu_torch's
MultiAgentPPO (``build(device="cpu")``, evaluated by chip_smoke.py's
``chase_vs_random``) and through the reference's MultiAgentPPO with its
runners called in this process instead of as actors (its training_step as
it is; evaluated by the test's ``_eval_vs_random``).
"""

import sys

import numpy as np


def reference_run(seed, env_fn, cfg_kw):
    from ray_tpu.rllib.env_runner import SingleAgentEnvRunner
    from ray_tpu.rllib.learner import PPOLearner, PPOLearnerConfig, compute_gae
    from ray_tpu.rllib.rl_module import RLModule

    cfg = PPOLearnerConfig(**cfg_kw)
    module = RLModule((84, 84, 1), 4, (64, 64))
    learner = PPOLearner(module, cfg, seed)
    runner = SingleAgentEnvRunner(env_fn, module, 8, seed)
    runner.set_weights(learner.get_weights())
    window, returns = [], []
    for _ in range(12):
        rollout = runner.sample(24)
        learner.update([compute_gae(rollout, cfg.gamma, cfg.gae_lambda)])
        runner.set_weights(learner.get_weights())
        window = (window + runner.episode_returns())[-100:]
        if window:
            returns.append(float(np.mean(window)))
    return returns


def port_run(seed, env_fn, cfg_kw):
    from ray_tpu_torch.rllib import PPOConfig

    algo = (PPOConfig().environment(env_fn=env_fn)
            .env_runners(num_env_runners=1, num_envs_per_env_runner=8,
                         rollout_fragment_length=24)
            .training(**cfg_kw).debugging(seed=seed).build(device="cpu"))
    returns = []
    for _ in range(12):
        r = algo.train()["episode_return_mean"]
        if not np.isnan(r):
            returns.append(r)
    return returns


def main(seeds):
    from ray_tpu_torch.rllib.examples.pixel_gridworld import (
        PixelGridWorldBatch,
    )

    def env_fn():
        return PixelGridWorldBatch(num_envs=8, size=5, wall_density=0.1,
                                   max_steps=24, res=84, seed=11)

    cfg_kw = dict(lr=1e-3, num_epochs=4, minibatch_size=64,
                  entropy_coeff=0.01)
    passed = {"port": 0, "reference": 0}
    for seed in seeds:
        for name, run in (("port", port_run), ("reference", reference_run)):
            returns = run(seed, env_fn, cfg_kw)
            early, late = np.mean(returns[:3]), np.mean(returns[-3:])
            ok = bool(late > early + 0.1)
            passed[name] += ok
            print(f"{name:9s} seed {seed}: early {early:+.3f} late "
                  f"{late:+.3f} {'pass' if ok else 'FAIL'}  "
                  f"{np.round(returns, 3).tolist()}", flush=True)
    print({k: f"{v} of {len(seeds)}" for k, v in passed.items()})


CHASE_MARGIN = 0.3


def chase_config(mod, learner_mod, seed):
    from ray_tpu_torch.rllib.examples.chase import EVADER, PURSUER, ChaseEnv

    return (mod.MultiAgentPPOConfig(
                hidden=(32, 32),
                learner=learner_mod.PPOLearnerConfig(
                    lr=1e-3, entropy_coeff=0.003, minibatch_size=256),
                num_env_runners=2, num_envs_per_runner=4,
                rollout_length=64, seed=seed)
            .environment(ChaseEnv)
            .multi_agent(policies={PURSUER: (6, 5), EVADER: (6, 5)},
                         policy_mapping_fn=lambda aid: aid))


class InProcess:
    """A runner called in this process where the reference calls an actor:
    ``runner.method.remote(*args)`` runs the method."""

    def __init__(self, obj):
        self._obj = obj

    def __getattr__(self, name):
        from types import SimpleNamespace

        return SimpleNamespace(remote=getattr(self._obj, name))


def chase_reference_run(seed):
    import ray_tpu
    from ray_tpu.rllib import learner as jlearn
    from ray_tpu.rllib import multi_agent as jma
    from ray_tpu.rllib.rl_module import RLModule
    from test_rllib_multi_agent import _eval_vs_random

    cfg = chase_config(jma, jlearn, seed)
    ray_tpu.get = lambda refs, timeout=None: refs
    algo = object.__new__(jma.MultiAgentPPO)
    algo.config = cfg
    algo.module = jma.MultiRLModule({mid: RLModule(6, 5, cfg.hidden)
                                     for mid in cfg.policies})
    algo.learners = {mid: jlearn.PPOLearner(algo.module[mid], cfg.learner,
                                            seed=cfg.seed + i)
                     for i, mid in enumerate(sorted(cfg.policies))}
    algo.runners = [InProcess(jma.MultiAgentEnvRunner(
        cfg._env_fn, algo.module, cfg.policy_mapping_fn,
        cfg.num_envs_per_runner, cfg.seed + 1000 * i))
        for i in range(cfg.num_env_runners)]
    algo._sync_weights()
    algo.iteration, algo._reward_window = 0, []
    for _ in range(35):
        algo.train()
    weights = algo.get_weights()
    return {aid: _eval_vs_random(algo.module, weights, aid)
            for aid in cfg.policies}


def chase_port_run(seed):
    import chip_smoke
    from ray_tpu_torch.rllib import learner as tlearn
    from ray_tpu_torch.rllib import multi_agent as tma

    algo = chase_config(tma, tlearn, seed).build(device="cpu")
    for _ in range(35):
        algo.train()
    weights = algo.get_weights()
    return {aid: chip_smoke.chase_vs_random(algo.module, weights, aid)
            for aid in algo.config.policies}


def chase_main(seeds):
    import os

    import torch

    from ray_tpu_torch.rllib.examples.chase import random_baseline

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    torch.set_num_threads(2)
    base = random_baseline(n_episodes=150)
    base = {"pursuer": base["pursuer_mean"], "evader": base["evader_mean"]}
    passed = {"port": 0, "reference": 0}
    for seed in seeds:
        for name, run in (("port", chase_port_run),
                          ("reference", chase_reference_run)):
            scores = run(seed)
            margins = {a: scores[a] - base[a] for a in base}
            ok = all(m > CHASE_MARGIN for m in margins.values())
            passed[name] += ok
            print(f"{name:9s} seed {seed}: margins pursuer "
                  f"{margins['pursuer']:+.3f} evader {margins['evader']:+.3f}"
                  f" {'pass' if ok else 'FAIL'}", flush=True)
    print({k: f"{v} of {len(seeds)}" for k, v in passed.items()})


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["chase"]:
        chase_main([int(s) for s in args[1:]] or list(range(8)))
    else:
        main([int(s) for s in args] or [0, 1, 2, 3])
