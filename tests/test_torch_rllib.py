"""Port parity for RLlib's online algorithms (ray_tpu_torch/rllib against
ray_tpu/rllib, on the CPU): the numpy copies (vector.py, the example envs,
compute_gae, the replay buffer) step for step; the RLModule forward, MLP
and conv at res 40 and 84; V-trace and the tanh-Gaussian log-density; and
one update of each learner (PPO flat and conv, the two-learner group,
IMPALA, APPO across a target refresh, DQN across target refreshes, SAC with
the reference's own noise) on the reference's initial weights, converted
by models/convert.py. Every init is the reference's: flax's lecun_normal
kernels and zero biases from ``PRNGKey(seed)``.

Tolerances (ROADMAP rule 4): outputs 2e-5, logits 1e-4, weights after an
update 1e-4. Torch cannot reproduce JAX's PRNG, so sampled actions are held
to properties; a PPO update with ``minibatch_size >= n`` takes every
minibatch whole, so its permutation cannot matter."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib import appo as japo
from ray_tpu.rllib import dqn as jdqn
from ray_tpu.rllib import impala as jimp
from ray_tpu.rllib import learner as jlearn
from ray_tpu.rllib import rl_module as jrl
from ray_tpu.rllib import sac as jsac
from ray_tpu.rllib import vector as jvec
from ray_tpu.rllib.examples import gridworld as jgrid
from ray_tpu.rllib.examples import pixel_gridworld as jpix
from ray_tpu.rllib.examples import point_goal as jpoint
from ray_tpu_torch.models.convert import convert_rl_params, unconvert_rl_params
from ray_tpu_torch.rllib import appo as tapo
from ray_tpu_torch.rllib import dqn as tdqn
from ray_tpu_torch.rllib import impala as timp
from ray_tpu_torch.rllib import learner as tlearn
from ray_tpu_torch.rllib import rl_module as trl
from ray_tpu_torch.rllib import sac as tsac
from ray_tpu_torch.rllib import vector as tvec
from ray_tpu_torch.rllib.examples import gridworld as tgrid
from ray_tpu_torch.rllib.examples import pixel_gridworld as tpix
from ray_tpu_torch.rllib.examples import point_goal as tpoint

OUT_TOL = 2e-5  # outputs (tests/test_attention.py:28)
LOGIT_TOL = 1e-4  # model logits
WEIGHT_TOL = 1e-4  # weights after an update


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads for this module's torch work, restored after
    (several pytest workers share the machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(flax_tree):
    """The reference's params as the port's weights (models/convert.py)."""
    return {k: torch.from_numpy(v.copy())
            for k, v in convert_rl_params(_np(flax_tree)).items()}


def _assert_weights(port, ref_tree, tol=WEIGHT_TOL):
    ref = convert_rl_params(_np(ref_tree))
    assert set(port) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(port[k].detach().numpy(), v, atol=tol,
                                   rtol=0, err_msg=k)


# -- the numpy copies --------------------------------------------------------

def test_gridworld_and_point_goal_copies_step_alike():
    """Same seeds and actions give the same layouts, observations, rewards
    and flags, the BFS expert included; SyncVectorEnv's autoreset too."""
    rng = np.random.default_rng(0)
    for seed in (0, 3):
        j = jgrid.GridWorldEnv(size=6, seed=seed)
        t = tgrid.GridWorldEnv(size=6, seed=seed)
        np.testing.assert_array_equal(j.walls, t.walls)
        np.testing.assert_array_equal(j.reset(seed=seed + 1)[0],
                                      t.reset(seed=seed + 1)[0])
        for a in rng.integers(0, 4, 40):
            assert j.expert_action() == t.expert_action()
            jo, jr, jt, jtr, _ = j.step(a)
            to, tr, tt, ttr, _ = t.step(a)
            np.testing.assert_array_equal(jo, to)
            assert (jr, jt, jtr) == (tr, tt, ttr)
    jv = jvec.SyncVectorEnv([lambda: jpoint.PointGoalEnv(seed=1),
                             lambda: jpoint.PointGoalEnv(seed=2)], seed=7)
    tv = tvec.SyncVectorEnv([lambda: tpoint.PointGoalEnv(seed=1),
                             lambda: tpoint.PointGoalEnv(seed=2)], seed=7)
    np.testing.assert_array_equal(jv.reset_all(), tv.reset_all())
    for a in rng.uniform(-1, 1, (60, 2, 2)).astype(np.float32):
        for x, y in zip(jv.step_batch(a), tv.step_batch(a)):
            np.testing.assert_array_equal(x, y)
    env = tpix.PixelGridWorldBatch(num_envs=3, size=5, res=40)
    assert tvec.as_batch_env(lambda: env, num_envs=99) is env


@pytest.mark.parametrize("res", [40, 84])
def test_pixel_gridworld_copy_steps_alike(res):
    kw = dict(num_envs=4, size=5, wall_density=0.1, max_steps=12, res=res,
              seed=11)
    j, t = jpix.PixelGridWorldBatch(**kw), tpix.PixelGridWorldBatch(**kw)
    np.testing.assert_array_equal(j.reset_all(), t.reset_all())
    for a in np.random.default_rng(res).integers(0, 4, (30, 4)):
        for x, y in zip(j.step_batch(a), t.step_batch(a)):
            np.testing.assert_array_equal(x, y)


def test_compute_gae_and_replay_copies_match():
    rng = np.random.default_rng(1)
    T, N = 9, 3
    batch = {"obs": rng.normal(size=(T, N, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, (T, N)).astype(np.int32),
             "logp": rng.normal(size=(T, N)).astype(np.float32),
             "values": rng.normal(size=(T, N)).astype(np.float32),
             "rewards": rng.normal(size=(T, N)).astype(np.float32),
             "dones": (rng.random((T, N)) < 0.2).astype(np.float32),
             "last_values": rng.normal(size=N).astype(np.float32)}
    ref = jlearn.compute_gae(batch, 0.99, 0.95)
    got = tlearn.compute_gae(batch, 0.99, 0.95)
    for k in ref:
        np.testing.assert_array_equal(ref[k], got[k])
    jb, tb = jdqn.ReplayBuffer(8, 2), tdqn.ReplayBuffer(8, 2)
    for i in range(12):
        args = (np.full((1, 2), i, np.float32), np.array([i]),
                np.array([float(i)]), np.full((1, 2), i + 1, np.float32),
                np.array([0.0]))
        jb.add_batch(*args)
        tb.add_batch(*args)
    a = jb.sample(16, np.random.default_rng(0))
    b = tb.sample(16, np.random.default_rng(0))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_convert_rl_params_round_trip():
    """Bit-exact both ways for Dense/Conv trees and SAC's named twin Q;
    Dense [in, out] -> Linear [out, in], Conv HWIO -> OIHW."""
    conv = _np(jrl.RLModule((40, 40, 1), 4).init_params(
        jax.random.PRNGKey(0)))
    sac = _np(jsac.SACModule(4, 2).init_params(jax.random.PRNGKey(0)))
    for tree in (conv, sac):
        back = unconvert_rl_params(convert_rl_params(tree))
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        jax.tree.map(np.testing.assert_array_equal, back, tree)
    sd = convert_rl_params(conv)
    np.testing.assert_array_equal(sd["Conv_0.weight"],
                                  conv["Conv_0"]["kernel"].transpose(3, 2, 0,
                                                                     1))
    np.testing.assert_array_equal(sd["Dense_0.weight"],
                                  conv["Dense_0"]["kernel"].T)
    assert "q.q2_out.weight" in convert_rl_params(sac)
    port = tsac.SACModule(4, 2, device="cpu").init_params(0)
    for part in ("policy", "q"):
        names = convert_rl_params(sac[part])
        assert {k: v.shape for k, v in names.items()} == \
            {k: tuple(v.shape) for k, v in port[part].items()}


# -- the modules -------------------------------------------------------------

FORWARD_CASES = [(6, (64, 64)), ((40, 40, 1), (64, 64)),
                 ((40, 40, 1), (256,)), ((84, 84, 1), (64, 64)),
                 ((84, 84, 1), (256,))]


def test_rl_module_forward_matches_flax():
    """MLP, and the conv trunk at res 40 (stride-2 SAME pads (0, 1)) and 84
    (symmetric), with the dense widths PPO passes (64, 64) and the conv
    net's default (256,): logits and values on the same weights."""
    rng = np.random.default_rng(2)
    for obs_dim, hidden in FORWARD_CASES:
        jm = jrl.RLModule(obs_dim, 4, hidden)
        tm = trl.RLModule(obs_dim, 4, hidden, device="cpu")
        params = jm.init_params(jax.random.PRNGKey(3))
        weights = _torch(params)
        assert {k: tuple(v.shape) for k, v in weights.items()} == \
            {k: tuple(v.shape) for k, v in tm.init_params(0).items()}
        shape = (5,) + (obs_dim if isinstance(obs_dim, tuple)
                        else (obs_dim,))
        obs = rng.random(shape).astype(np.float32)
        jl, jv = jm.forward_train(params, jnp.asarray(obs))
        with torch.no_grad():
            tl, tv = tm.forward_train(weights, torch.from_numpy(obs))
        np.testing.assert_allclose(tl.numpy(), jl, atol=LOGIT_TOL, rtol=0)
        np.testing.assert_allclose(tv.numpy(), jv, atol=OUT_TOL, rtol=0)


def test_same_pads_follow_xla():
    """flax's SAME: (0, 1) for a stride-2 3x3 over 10, as
    jax.lax.padtype_to_pads gives."""
    for size, k, s in ((40, 8, 4), (10, 3, 2), (5, 3, 2), (84, 8, 4),
                       (21, 3, 2), (11, 3, 2), (6, 3, 1)):
        ref = jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME")[0]
        assert trl.same_pads(size, k, s) == tuple(ref), (size, k, s)


def test_forward_inference_properties_and_state():
    """A draw from the generator: actions in range, logp the log-softmax
    at the action, value the forward's; the same seed draws the same
    actions; frequencies follow the softmax. DQN at epsilon 0 is the
    reference's greedy action; SAC's actions lie in (-1, 1) with the
    density of their pre-activations. Pickled state round trips."""
    obs_dim, A = 6, 3
    jm = jrl.RLModule(obs_dim, A)
    tm = trl.RLModule(obs_dim, A, device="cpu")
    w = _torch(jm.init_params(jax.random.PRNGKey(0)))
    obs = np.repeat(np.random.default_rng(0).random((1, obs_dim), np.float32),
                    4000, axis=0)
    a, logp, v = tm.forward_inference(w, obs, torch.Generator().manual_seed(5))
    a2, _, _ = tm.forward_inference(w, obs, torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(a, a2)
    assert a.dtype == np.int32 and a.min() >= 0 and a.max() < A
    jl, jv = jm.forward_train(jm.init_params(jax.random.PRNGKey(0)),
                              jnp.asarray(obs[:1]))
    probs = np.asarray(jax.nn.softmax(jl))[0]
    np.testing.assert_allclose(logp, np.log(probs)[a], atol=OUT_TOL)
    np.testing.assert_allclose(v, np.full(len(obs), float(jv[0])),
                               atol=OUT_TOL)
    freq = np.bincount(a, minlength=A) / len(a)
    np.testing.assert_allclose(freq, probs, atol=0.03)
    back = pickle.loads(pickle.dumps(tm))
    state = back.__getstate__()
    assert state.pop("device") == "cpu"
    assert state == jm.__getstate__()
    assert tm.inference_calls == 2

    jq = jdqn.DQNModule(obs_dim, A)
    tq = tdqn.DQNModule(obs_dim, A, device="cpu")
    qp = jq.init_params(jax.random.PRNGKey(1))
    obs = np.random.default_rng(1).random((64, obs_dim), np.float32)
    gen = torch.Generator().manual_seed(0)
    greedy, _, _ = tq.forward_inference({"params": _torch(qp),
                                         "epsilon": 0.0}, obs, gen)
    ref, _, _ = jq.forward_inference({"params": qp, "epsilon": 0.0}, obs,
                                     jax.random.PRNGKey(0))
    np.testing.assert_array_equal(greedy, ref)
    rand, _, _ = tq.forward_inference({"params": _torch(qp),
                                       "epsilon": 1.0}, obs, gen)
    assert set(rand.tolist()) == set(range(A))

    js = jsac.SACModule(4, 2)
    ts = tsac.SACModule(4, 2, device="cpu")
    sp = _torch(js.init_params(jax.random.PRNGKey(2))["policy"])
    obs = np.random.default_rng(2).random((16, 4), np.float32)
    act, slogp, _ = ts.forward_inference(sp, obs,
                                         torch.Generator().manual_seed(0))
    assert np.all(np.abs(act) < 1)
    mean, log_std = ts.policy_dist(sp, torch.from_numpy(obs))
    pre = torch.atanh(torch.from_numpy(act).double()).float()
    np.testing.assert_allclose(
        slogp, tsac._tanh_gaussian_logp(pre, mean, log_std).detach().numpy(),
        atol=1e-3)


def test_vtrace_and_tanh_gaussian_logp_match():
    rng = np.random.default_rng(0)
    T, N = 7, 3
    values = rng.normal(size=(T, N)).astype(np.float32)
    next_value = rng.normal(size=N).astype(np.float32)
    rewards = rng.normal(size=(T, N)).astype(np.float32)
    dones = (rng.random((T, N)) < 0.2).astype(np.float32)
    rhos = np.exp(rng.normal(scale=0.5, size=(T, N))).astype(np.float32)
    for rho_clip, c_clip in ((1.0, 1.0), (0.8, 1.2)):
        kw = dict(gamma=0.9, rho_clip=rho_clip, c_clip=c_clip)
        ref = jimp.vtrace_targets(*map(jnp.asarray, (values, next_value,
                                                     rewards, dones, rhos)),
                                  **kw)
        got = timp.vtrace_targets(*map(torch.from_numpy,
                                       (values, next_value, rewards, dones,
                                        rhos)), **kw)
        for r, g in zip(ref, got):
            np.testing.assert_allclose(g.numpy(), r, atol=OUT_TOL, rtol=0)
    # pre-activations drawn as SAC draws them (mean + std * N(0, 1)); far
    # in tanh's tail (|pre| > 4) 1 - tanh(pre)^2 cancels in f32 and both
    # packages lose digits alike.
    mean = rng.normal(size=(64, 2)).astype(np.float32)
    log_std = rng.uniform(-5, 0.5, (64, 2)).astype(np.float32)
    pre = mean + np.exp(log_std) * rng.normal(size=(64, 2)).astype(
        np.float32)
    ref = jsac._tanh_gaussian_logp(*map(jnp.asarray, (pre, mean, log_std)))
    got = tsac._tanh_gaussian_logp(*map(torch.from_numpy,
                                        (pre, mean, log_std)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=OUT_TOL, atol=OUT_TOL)


# -- the learners ------------------------------------------------------------

def _ppo_batch(obs_shape, n, A, seed):
    rng = np.random.default_rng(seed)
    return {"obs": rng.random((n,) + obs_shape).astype(np.float32),
            "actions": rng.integers(0, A, n).astype(np.int32),
            "logp": (np.log(1.0 / A)
                     + 0.3 * rng.normal(size=n)).astype(np.float32),
            "advantages": rng.normal(size=n).astype(np.float32),
            "returns": rng.normal(size=n).astype(np.float32)}


@pytest.mark.parametrize("obs_shape,epochs",
                         [((6,), 2), ((40, 40, 1), 1), ((84, 84, 1), 1)],
                         ids=["flat", "conv40", "conv84"])
def test_ppo_update_matches(obs_shape, epochs):
    """Whole-batch minibatches (minibatch_size >= n): the loss and every
    weight after the update. The conv trunk takes one epoch: after a first
    Adam step of lr 1e-3 its ReLUs whose pre-activation lies within f32
    rounding of 0 switch either way, and Adam's second step moves their
    weights by up to lr (tests/torch_parity_report.py: at res 84 the port in
    f32 lies as far from the port in f64 as from the reference)."""
    A, n = 4, 48
    cfg = jlearn.PPOLearnerConfig(num_epochs=epochs, minibatch_size=64,
                                  lr=1e-3)
    obs_dim = obs_shape if len(obs_shape) == 3 else obs_shape[0]
    ref = jlearn.PPOLearner(jrl.RLModule(obs_dim, A), cfg, seed=0)
    port = tlearn.PPOLearner(trl.RLModule(obs_dim, A, device="cpu"), cfg,
                             seed=0)
    port.set_weights(convert_rl_params(_np(ref.params)))
    batch = _ppo_batch(obs_shape, n, A, 1)
    r = ref.update([batch])
    p = port.update([batch])
    assert p["batch_size"] == r["batch_size"] == n
    np.testing.assert_allclose(p["loss"], r["loss"], rtol=1e-5, atol=1e-6)
    _assert_weights(port.get_weights(), ref.params)


def test_learner_group_two_learners_matches():
    """LearnerGroup(num_learners=2): learners seeded 0 and 1 (their
    reference counterparts' weights, converted), batches sharded [b0, b2]
    and [b1], weights averaged after the update, as learner.py:174-192
    does over its actors."""
    A, cfg = 3, jlearn.PPOLearnerConfig(num_epochs=1, minibatch_size=128)
    jm = jrl.RLModule(5, A)
    refs = [jlearn.PPOLearner(jm, cfg, seed=i) for i in range(2)]
    group = tlearn.LearnerGroup(trl.RLModule(5, A, device="cpu"), cfg,
                                num_learners=2, seed=0)
    assert [lr._gen.initial_seed() for lr in group.learners] == [1, 2]
    for lr, ref in zip(group.learners, refs):
        lr.set_weights(convert_rl_params(_np(ref.params)))
    batches = [_ppo_batch((5,), 24, A, s) for s in range(3)]
    out = group.update(batches)
    r0, r1 = refs[0].update(batches[0::2]), refs[1].update(batches[1::2])
    avg = jax.tree.map(lambda *xs: sum(xs) / len(xs), refs[0].params,
                       refs[1].params)
    assert out["batch_size"] == 72
    np.testing.assert_allclose(out["loss"], (r0["loss"] + r1["loss"]) / 2,
                               rtol=1e-5)
    for lr in group.learners:
        _assert_weights(lr.get_weights(), avg)


def _rollout(T, N, obs_dim, A, seed):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(T, N, obs_dim)).astype(np.float32),
            "actions": rng.integers(0, A, (T, N)).astype(np.int32),
            "logp": (np.log(1.0 / A) + 0.3 * rng.normal(size=(T, N))
                     ).astype(np.float32),
            "rewards": rng.normal(size=(T, N)).astype(np.float32),
            "dones": (rng.random((T, N)) < 0.15).astype(np.float32),
            "last_values": rng.normal(size=N).astype(np.float32)}


def test_impala_and_appo_updates_match():
    """IMPALA: one update. APPO at target_update_freq=1: two updates, the
    target refreshed to a real copy after each, so the second update's KL
    is taken against the first update's weights."""
    A = 3
    icfg = jimp.IMPALALearnerConfig(lr=1e-3)
    ref = jimp.IMPALALearner(jrl.RLModule(4, A), icfg, seed=0)
    port = timp.IMPALALearner(trl.RLModule(4, A, device="cpu"), icfg, seed=0)
    tlearn.set_params_(port.params, convert_rl_params(_np(ref.params)))
    ro = _rollout(8, 4, 4, A, 0)
    np.testing.assert_allclose(port.update(ro)["loss"],
                               ref.update(ro)["loss"], rtol=1e-5, atol=1e-6)
    _assert_weights(port.get_weights(), ref.params)

    # target_update_freq 1: the target is refreshed after every update,
    # so each update's KL is against its own starting weights (0); at 2,
    # the second update's KL is against the initial weights.
    for freq in (1, 2):
        acfg = japo.APPOLearnerConfig(lr=1e-2, target_update_freq=freq)
        ref = japo.APPOLearner(jrl.RLModule(4, A), acfg, seed=1)
        port = tapo.APPOLearner(trl.RLModule(4, A, device="cpu"), acfg,
                                seed=1)
        tlearn.set_params_(port.params, convert_rl_params(_np(ref.params)))
        port.target_params = trl.clone_weights(port.params)
        kls = []
        for i in range(2):
            ro = _rollout(8, 4, 4, A, 10 + i)
            r, p = ref.update(ro), port.update(ro)
            for k in ("loss", "pg_loss", "vf_loss"):
                np.testing.assert_allclose(p[k], r[k], rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(p["kl"], r["kl"], atol=1e-6)
            kls.append(p["kl"])
            _assert_weights(port.get_weights(), ref.params)
            _assert_weights(port.target_params, ref.target_params)
            assert port.target_params["Dense_0.weight"].data_ptr() != \
                port.params["Dense_0.weight"].data_ptr()
        assert kls[0] < 1e-6 and (kls[1] < 1e-6) == (freq == 1), kls


def test_dqn_steps_across_target_refreshes():
    """Five TD steps at target_update_period 2 (refreshes after steps 2 and
    4), Huber loss, with and without double DQN's argmax."""
    A = 3
    rng = np.random.default_rng(0)
    mbs = [{"obs": rng.normal(size=(32, 5)).astype(np.float32),
            "actions": rng.integers(0, A, 32).astype(np.int32),
            "rewards": (3 * rng.normal(size=32)).astype(np.float32),
            "next_obs": rng.normal(size=(32, 5)).astype(np.float32),
            "dones": (rng.random(32) < 0.2).astype(np.float32)}
           for _ in range(5)]
    for double in (True, False):
        cfg = jdqn.DQNLearnerConfig(lr=1e-3, target_update_period=2,
                                    double_dqn=double)
        ref = jdqn.DQNLearner(jdqn.DQNModule(5, A), cfg, seed=0)
        port = tdqn.DQNLearner(tdqn.DQNModule(5, A, device="cpu"), cfg,
                               seed=0)
        tlearn.set_params_(port.params, convert_rl_params(_np(ref.params)))
        port.target_params = trl.clone_weights(port.params)
        r, p = ref.update(mbs), port.update(mbs)
        assert p["sgd_steps"] == r["sgd_steps"] == 5
        np.testing.assert_allclose(p["loss"], r["loss"], rtol=1e-5)
        _assert_weights(port.get_weights(), ref.params)
        _assert_weights(port.target_params, ref.target_params)


def test_sac_steps_match_with_the_reference_noise():
    """Three SAC steps (critics, policy, alpha, Polyak) given the noise the
    reference draws from its key splits (sac.py:228 then :197; drawn at
    :169 and :184): policy, critics, target critics and log alpha."""
    cfg = jsac.SACLearnerConfig(lr=1e-3, tau=0.1)
    ref = jsac.SACLearner(jsac.SACModule(4, 2), cfg, seed=0)
    port = tsac.SACLearner(tsac.SACModule(4, 2, device="cpu"), cfg, seed=0)
    for part in ("policy", "q", "q_target"):
        tlearn.set_params_(port.state[part],
                           convert_rl_params(_np(ref.state[part])))
    rng = np.random.default_rng(0)
    mbs = [{"obs": rng.normal(size=(32, 4)).astype(np.float32),
            "actions": rng.uniform(-1, 1, (32, 2)).astype(np.float32),
            "rewards": rng.normal(size=32).astype(np.float32),
            "next_obs": rng.normal(size=(32, 4)).astype(np.float32),
            "dones": (rng.random(32) < 0.2).astype(np.float32)}
           for _ in range(3)]
    key = ref._key
    losses = []
    for mb in mbs:
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        eps = [torch.from_numpy(np.array(jax.random.normal(k, (32, 2))))
               for k in (k1, k2)]
        losses.append(port.step({k: torch.from_numpy(v)
                                 for k, v in mb.items()}, *eps))
    r = ref.update(mbs)
    np.testing.assert_allclose(np.mean([float(l[0]) for l in losses]),
                               r["q_loss"], rtol=1e-5)
    np.testing.assert_allclose(np.mean([float(l[1]) for l in losses]),
                               r["pi_loss"], rtol=1e-5, atol=1e-6)
    for part in ("policy", "q", "q_target"):
        _assert_weights(port.state[part], ref.state[part])
    np.testing.assert_allclose(float(port.state["log_alpha"].detach()),
                               float(ref.state["log_alpha"]), atol=WEIGHT_TOL)
