"""RLlib's online algorithms, driven end to end on the CPU
(``build(device="cpu")``): one or two iterations each of PPO (flat,
pixels, two learners), IMPALA and APPO (the in-process runners in turns),
DQN (the epsilon schedule) and SAC, with their step counts and finite
losses; the runner group's seeds and weight copies; the device rule; and
one short learning check, PPO on CartPole. The parity of each update with
the reference is tests/test_torch_rllib.py's; the learning runs of the
pixel and SAC configurations are chip_smoke.py's (on the card)."""

import types

import numpy as np
import pytest
import torch

from ray_tpu_torch.rllib import (
    APPOConfig,
    DQNConfig,
    EnvRunnerGroup,
    IMPALAConfig,
    PPOConfig,
    RLModule,
    SACConfig,
)
from ray_tpu_torch.rllib.examples.gridworld import GridWorldEnv
from ray_tpu_torch.rllib.examples.pixel_gridworld import PixelGridWorldBatch
from ray_tpu_torch.rllib.examples.point_goal import PointGoalEnv
from ray_tpu_torch.rllib.vector import SyncVectorEnv


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads for this module's torch work, restored after
    (several pytest workers share the machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def gridworld():
    """GridWorldEnv with the observation_space the algorithms read."""
    env = GridWorldEnv(size=5, wall_density=0.1, max_steps=16, seed=0)
    env.observation_space = types.SimpleNamespace(shape=(env.obs_dim,))
    return env


def test_ppo_runs_flat_pixels_and_two_learners():
    algo = (PPOConfig()
            .environment(env_fn=gridworld)
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                         rollout_fragment_length=32)
            .debugging(seed=0)
            .build(device="cpu"))
    r = algo.train()
    assert r["env_steps_this_iter"] == 2 * 2 * 32
    assert r["training_iteration"] == 1 and np.isfinite(r["loss"])
    assert r["sample_time_s"] > 0 and r["learn_time_s"] > 0
    pix = (PPOConfig()
           .environment(env_fn=lambda: PixelGridWorldBatch(
               num_envs=4, size=5, res=40, seed=1))
           .env_runners(num_env_runners=1, num_envs_per_env_runner=4,
                        rollout_fragment_length=8)
           .training(minibatch_size=16, num_epochs=1)
           .build(device="cpu"))
    assert isinstance(pix.module.obs_dim, tuple)
    r = pix.train()
    assert r["env_steps_this_iter"] == 32 and np.isfinite(r["loss"])
    # 8 steps + the bootstrap forward
    assert pix.module.inference_calls == 9
    two = (PPOConfig()
           .environment(env_fn=gridworld)
           .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                        rollout_fragment_length=32)
           .learners(num_learners=2)
           .build(device="cpu"))
    r = two.train()
    assert r["env_steps_this_iter"] == 128 and np.isfinite(r["loss"])
    w0, w1 = (lr.get_weights() for lr in two.learner_group.learners)
    for k in w0:
        torch.testing.assert_close(w0[k], w1[k], rtol=0, atol=0)


def test_impala_runners_take_turns():
    """Each iteration consumes the rollout of the runner relaunched longest
    ago, then relaunches that runner alone with fresh weights: the other
    runner keeps the weights it sampled with (policy lag 1 at 2 runners)."""
    algo = (IMPALAConfig()
            .environment(env_fn=gridworld)
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                         rollout_fragment_length=16)
            .debugging(seed=0)
            .build(device="cpu"))
    r0, r1 = algo.runners
    assert [r for r, _ in algo._inflight] == [r0, r1]
    init = {k: v.clone() for k, v in r1.params.items()}
    out = algo.train()
    assert out["rollouts_consumed"] == 1 and np.isfinite(out["loss"])
    assert out["env_steps_this_iter"] == 2 * 16
    assert [r for r, _ in algo._inflight] == [r1, r0]
    for k, v in algo.get_weights().items():
        torch.testing.assert_close(r0.params[k], v, rtol=0, atol=0)
        torch.testing.assert_close(r1.params[k], init[k], rtol=0, atol=0)
    assert not torch.equal(r0.params["Dense_0.weight"],
                           init["Dense_0.weight"])
    assert np.isfinite(algo.train()["loss"])
    assert [r for r, _ in algo._inflight] == [r0, r1]


def test_appo_first_update_kl_and_target_refresh():
    algo = (APPOConfig()
            .environment(env_fn=gridworld)
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                         rollout_fragment_length=16)
            .training(target_update_freq=2)
            .build(device="cpu"))
    learner = algo.learner
    rollout = algo._inflight[0][1]
    first = learner.update(rollout)
    # target == initial weights: the first update's KL is ~0
    assert first["kl"] < 1e-4, first
    assert all(np.isfinite(first[k]) for k in ("loss", "pg_loss", "vf_loss"))
    assert not torch.equal(learner.target_params["Dense_0.weight"],
                           learner.params["Dense_0.weight"])
    second = learner.update(rollout)
    assert second["kl"] > 0
    torch.testing.assert_close(learner.target_params["Dense_0.weight"],
                               learner.params["Dense_0.weight"], rtol=0,
                               atol=0)
    out = algo.train()
    assert out["rollouts_consumed"] == 1 and np.isfinite(out["loss"])


def test_dqn_epsilon_schedule_and_replay():
    algo = (DQNConfig()
            .environment(env_fn=gridworld)
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                         rollout_fragment_length=16)
            .training(learn_start=64, batch_size=32, sgd_steps_per_iter=4,
                      epsilon_anneal_steps=256)
            .debugging(seed=0)
            .build(device="cpu"))
    r1 = algo.train()
    assert r1["env_steps_this_iter"] == 2 * 2 * 16
    assert r1["sgd_steps"] == 0 and np.isnan(r1["loss"])
    # 64 env steps of 256: epsilon 1 - 0.95 * 64/256
    assert r1["epsilon"] == pytest.approx(1.0 - 0.95 * 0.25)
    assert algo.buffer.size == 2 * 2 * 15
    r2 = algo.train()
    assert r2["sgd_steps"] == 4 and np.isfinite(r2["loss"])
    assert r2["epsilon"] == pytest.approx(1.0 - 0.95 * 0.5)
    for r in algo.env_runners.runners:
        assert r.params["epsilon"] == pytest.approx(r2["epsilon"])
    for _ in range(2):
        r = algo.train()
    assert r["epsilon"] == pytest.approx(0.05)


def test_sac_runs():
    algo = (SACConfig()
            .environment(lambda: PointGoalEnv())
            .env_runners(num_env_runners=1, num_envs_per_env_runner=4,
                         rollout_fragment_length=20)
            .training(learn_start=64, batch_size=32, sgd_steps_per_iter=4)
            .debugging(seed=0)
            .build(device="cpu"))
    r = algo.train()
    assert r["env_steps_total"] == 80 and r["sgd_steps"] == 4
    assert all(np.isfinite(r[k]) for k in ("q_loss", "pi_loss", "alpha"))
    rollout = algo.env_runners.runners[0].sample(3)
    assert rollout["actions"].shape == (3, 4, 2)
    assert np.all(np.abs(rollout["actions"]) < 1)


def test_runner_group_seeds_and_weight_copies():
    """Runner i is seeded seed + 1000 * i (its SyncVectorEnv resets env j
    with that seed + j), and holds a copy of the synced weights."""
    module = RLModule(4, 2, device="cpu")
    group = EnvRunnerGroup(lambda: PointGoalEnv(), module, num_runners=2,
                           num_envs_per_runner=3, seed=5)
    for i, r in enumerate(group.runners):
        vec = SyncVectorEnv([PointGoalEnv] * 3, seed=5 + 1000 * i)
        np.testing.assert_array_equal(r.obs, vec.reset_all())
        assert r._gen.initial_seed() == 5 + 1000 * i
    weights = module.init_params(0)
    group.sync_weights(weights)
    with torch.no_grad():
        weights["Dense_0.weight"].add_(1.0)
    for r in group.runners:
        assert not torch.equal(r.params["Dense_0.weight"],
                               weights["Dense_0.weight"])


def test_entry_points_need_a_named_device_without_a_card(monkeypatch):
    """With no card and no device named, building raises: the port never
    falls back to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for config in (PPOConfig(), IMPALAConfig(), DQNConfig()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            config.environment(env_fn=gridworld).build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SACConfig().environment(lambda: PointGoalEnv()).build()


def test_ppo_cartpole_learns():
    """The one CPU learning check, the reference's
    (tests/test_rllib.py::test_ppo_cartpole_learns: its config, seed and
    budget): PPO on CartPole (gymnasium, imported when the env is made)
    better than doubles its early return within 12 iterations of 1,024 env
    steps."""
    algo = (PPOConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                         rollout_fragment_length=128)
            .training(minibatch_size=256, num_epochs=4, lr=3e-4)
            .debugging(seed=1)
            .build(device="cpu"))
    first, best = None, 0.0
    for _ in range(12):
        r = algo.train()
        ret = r["episode_return_mean"]
        if np.isfinite(ret):
            first = ret if first is None else first
            best = max(best, ret)
    assert first is not None
    assert best > max(40.0, 2.0 * first), (first, best)
