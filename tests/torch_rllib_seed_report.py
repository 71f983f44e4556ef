"""Pixel PPO's learning check over seeds, the port against the reference, on
the CPU (not a pytest file).

    JAX_PLATFORMS=cpu python tests/torch_rllib_seed_report.py 0 1 2 3

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


if __name__ == "__main__":
    main([int(s) for s in sys.argv[1:]] or [0, 1, 2, 3])
