"""Port parity for multi-agent RLlib (ray_tpu_torch/rllib/multi_agent.py and
examples/chase.py against ray_tpu/rllib's, on the CPU): the chase copy and
the connectors and episodes step for step; the env runner under an argmax
policy; the per-module GAE batches and one update per module through each
package's ``training_step``; MultiRLModule's draws.

Torch cannot reproduce JAX's PRNG, so the runner parity scales each policy
head by 1e4: both packages' categorical draws are then the argmax, and one
``sample(80)`` over 2 envs (the horizon is 32, so it crosses resets and
cuts in-progress episodes) must give identical observations, actions and
episode rewards. Tolerances (ROADMAP rule 4): log-probabilities, values and
bootstrap values 1e-5; GAE batches exact (numpy copies); weights after an
update 1e-4, with ``minibatch_size >= n`` so the permutation cannot
matter. The learning check (35 iterations) runs on the card
(chip_smoke.py ``rllib_multi_agent_chase``) and over seeds in
tests/torch_rllib_seed_report.py, not here."""

import jax
import numpy as np
import pytest
import torch

import ray_tpu
from ray_tpu.rllib import learner as jlearn
from ray_tpu.rllib import multi_agent as jma
from ray_tpu.rllib import rl_module as jrl
from ray_tpu.rllib.examples import chase as jch
from ray_tpu_torch.models.convert import convert_rl_params
from ray_tpu_torch.rllib import learner as tlearn
from ray_tpu_torch.rllib import multi_agent as tma
from ray_tpu_torch.rllib import rl_module as trl
from ray_tpu_torch.rllib.examples import chase as tch

OUT_TOL = 1e-5
WEIGHT_TOL = 1e-4
HIDDEN = (32, 32)
HEAD = f"Dense_{len(HIDDEN)}"  # the policy head, named after the trunk


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class TurnEnv:
    """Two agents taking turns: only the agent to move is in the obs dict,
    rewards go to it, and ``dones`` holds only "__all__" (so an agent's
    done flag comes from the runner's ``dones.get("__all__")`` fallback).
    numpy only; its dynamics are the same in both packages."""

    agents = ("a", "b")
    obs_dim = 6
    num_actions = 5

    def __init__(self, horizon: int = 7):
        self.horizon = horizon
        self._rng = np.random.default_rng(0)

    def reset(self, *, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.t = 0
        self.state = self._rng.random(6).astype(np.float32)
        return {"a": self.state.copy()}

    def step(self, actions):
        (aid, act), = actions.items()
        self.t += 1
        self.state = np.roll(self.state, act) * 0.9 + 0.1 * act / 5
        done = self.t >= self.horizon
        nxt = "b" if aid == "a" else "a"
        return ({nxt: self.state.astype(np.float32)},
                {aid: float(self.state[0] - 0.5)}, {"__all__": done})


ENVS = {"chase": (jch.ChaseEnv, tch.ChaseEnv, (jch.PURSUER, jch.EVADER),
                  lambda aid: aid),
        "turns": (TurnEnv, TurnEnv, ("shared",), lambda aid: "shared")}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(flax_tree):
    return {k: torch.from_numpy(v.copy())
            for k, v in convert_rl_params(_np(flax_tree)).items()}


def _argmax_params():
    """One reference init (MultiRLModule.init_params(0) over the chase
    policies) with every policy head scaled by 1e4, as numpy trees; the
    turn env's one shared policy takes the pursuer's."""
    mids = ENVS["chase"][2]
    jm = jma.MultiRLModule({m: jrl.RLModule(6, 5, HIDDEN) for m in mids})
    params = _np(jm.init_params(0))
    for m in mids:
        for k in ("kernel", "bias"):
            params[m][HEAD][k] = params[m][HEAD][k] * 1e4
    params["shared"] = params[jch.PURSUER]
    return params


def sample_both():
    """{env: (reference samples, port samples, reference and port episode
    rewards, the port's forward_inference calls)} of one sample(80) over 2
    envs under the argmax policy."""
    params = _argmax_params()
    out = {}
    for name, (jenv, tenv, mids, mapping) in ENVS.items():
        jm = jma.MultiRLModule({m: jrl.RLModule(6, 5, HIDDEN) for m in mids})
        tm = tma.MultiRLModule({m: trl.RLModule(6, 5, HIDDEN, device="cpu")
                                for m in mids})
        jr = jma.MultiAgentEnvRunner(jenv, jm, mapping, num_envs=2, seed=5)
        tr = tma.MultiAgentEnvRunner(tenv, tm, mapping, num_envs=2, seed=5)
        jr.set_weights({m: params[m] for m in mids})
        tr.set_weights({m: _torch(params[m]) for m in mids})
        js, ts = jr.sample(80), tr.sample(80)
        out[name] = (js, ts, jr.episode_rewards(), tr.episode_rewards(),
                     sum(m.inference_calls for _, m in tm.items()))
    return out


@pytest.fixture(scope="module")
def samples():
    return sample_both()


# -- the numpy copies --------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_chase_copy_steps_alike(seed):
    """Same seeds and actions give the same obs, rewards and dones, across
    catches and unseeded resets; random_baseline is equal."""
    rng = np.random.default_rng(seed)
    j, t = jch.ChaseEnv(), tch.ChaseEnv()
    a, b = j.reset(seed=seed), t.reset(seed=seed)
    for aid in a:
        np.testing.assert_array_equal(a[aid], b[aid])
    for _ in range(100):
        acts = {aid: int(x) for aid, x in zip(j.agents,
                                               rng.integers(0, 5, 2))}
        out = j.step(acts)
        for x, y in zip(out, t.step(acts)):
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])
        if out[2]["__all__"]:
            a, b = j.reset(), t.reset()
            for aid in a:
                np.testing.assert_array_equal(a[aid], b[aid])
    assert (tch.random_baseline(150, seed=seed)
            == jch.random_baseline(150, seed=seed))
    assert (tch.PURSUER, tch.EVADER) == (jch.PURSUER, jch.EVADER)


def test_connectors_and_episode_match():
    """The env->module connector groups rows by module id (many agents to
    one module, and one each), keeps recovery indices; the scatter and a
    MultiAgentEpisode's trajectories equal the reference's on the same
    rows."""
    rng = np.random.default_rng(0)
    mapping = lambda aid: "shared" if aid.startswith("npc") else aid
    rows = [(e, aid, rng.random(4).astype(np.float64))
            for e in range(3) for aid in ("npc_1", "hero", "npc_2")]
    ref = jma.AgentToModuleConnector(mapping)(rows)
    got = tma.AgentToModuleConnector(mapping)(rows)
    assert list(ref) == list(got) == ["shared", "hero"]
    for mid in ref:
        assert ref[mid][0] == got[mid][0]
        assert got[mid][1].dtype == np.float32
        np.testing.assert_array_equal(ref[mid][1], got[mid][1])
    outs = {mid: (idxs, rng.integers(0, 5, len(idxs)),
                  rng.normal(size=len(idxs)).astype(np.float32),
                  rng.normal(size=len(idxs)).astype(np.float32))
            for mid, (idxs, _) in got.items()}
    assert (jma.ModuleToAgentConnector()(len(rows), outs)
            == tma.ModuleToAgentConnector()(len(rows), outs))
    je, te = jma.MultiAgentEpisode(), tma.MultiAgentEpisode()
    for t in range(5):
        for aid in ("a", "b")[: 1 + t % 2]:
            args = (aid, rng.random(3), int(rng.integers(5)),
                    float(rng.normal()), float(rng.normal()),
                    float(rng.normal()), float(t == 4))
            je.add(*args)
            te.add(*args)
    assert je.total_rewards == te.total_rewards
    jt, tt = je.trajectories(), te.trajectories()
    assert jt.keys() == tt.keys()
    for aid in jt:
        for k in jt[aid]:
            assert jt[aid][k].dtype == tt[aid][k].dtype, k
            np.testing.assert_array_equal(jt[aid][k], tt[aid][k])


def test_multi_rl_module_draws_independently():
    """init_params(seed) draws each module's weights in turn over the
    sorted ids: two modules of one shape differ, a seed repeats its
    draws, and the names and shapes are the reference's, converted."""
    ids = ("b", "a")
    tm = tma.MultiRLModule({m: trl.RLModule(6, 5, (16,), device="cpu")
                            for m in ids})
    w = tm.init_params(0)
    assert list(w) == ["a", "b"]
    assert not torch.equal(w["a"]["Dense_0.weight"], w["b"]["Dense_0.weight"])
    again = tm.init_params(0)
    other = tm.init_params(1)
    for m in ids:
        for k in w[m]:
            assert torch.equal(w[m][k], again[m][k])
    assert not torch.equal(w["a"]["Dense_0.weight"],
                           other["a"]["Dense_0.weight"])
    jm = jma.MultiRLModule({m: jrl.RLModule(6, 5, (16,)) for m in ids})
    ref = _np(jm.init_params(0))
    for m in ids:
        assert ({k: v.shape for k, v in convert_rl_params(ref[m]).items()}
                == {k: tuple(v.shape) for k, v in w[m].items()})
    with pytest.raises(ValueError):
        tma.MultiRLModule({"a": trl.RLModule(6, 5, device="cpu"),
                           "b": trl.RLModule(6, 5, device="meta")})


# -- the runner ---------------------------------------------------------------

@pytest.mark.parametrize("env", list(ENVS))
def test_runner_matches_under_argmax(samples, env):
    """One sample(80) over 2 envs: the same trajectories per module, in
    the same order (finished episodes, then the cut ones); identical obs,
    actions, rewards, dones and episode rewards; logp, values and
    last_values (0 after an episode's end, the value of the agent's
    current obs at a cut) within 1e-5. One batched forward a module a
    timestep, plus one a bootstrapped agent."""
    js, ts, jrew, trew, calls = samples[env]
    assert js.keys() == ts.keys()
    n_boot = 0
    for mid in js:
        assert len(js[mid]) == len(ts[mid]) > 0
        for a, b in zip(js[mid], ts[mid]):
            assert a.keys() == b.keys()
            for k in ("obs", "actions", "rewards", "dones"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            for k in ("logp", "values", "last_values"):
                assert b[k].dtype == np.float32
                np.testing.assert_allclose(b[k], a[k], atol=OUT_TOL, rtol=0,
                                           err_msg=k)
            n_boot += bool(b["last_values"][0] != 0)
    assert trew == jrew and len(trew) > 0
    assert calls == 80 * len(js) + n_boot


# -- the algorithm ------------------------------------------------------------

class _Remote:
    """A stand-in for an actor method: ``.remote`` returns the value."""

    def __init__(self, fn):
        self.remote = fn


class _RefRunner:
    def __init__(self, sample, rewards):
        self.sample = _Remote(lambda n: sample)
        self.set_weights = _Remote(lambda p: None)
        self.episode_rewards = _Remote(lambda: rewards)


class _PortRunner:
    def __init__(self, sample, rewards):
        self.sample = lambda n: sample
        self.set_weights = lambda p: None
        self.episode_rewards = lambda: rewards


def _recorded(learner, log, mid):
    update = learner.update

    def wrapped(batches):
        log[mid] = batches
        return update(batches)

    learner.update = wrapped


def test_training_step_batches_and_update_match(samples, monkeypatch):
    """Both packages' training_step on the same samples (the reference's,
    handed out by stand-in runners): per-module GAE batches exactly equal;
    one update per module from the reference learners' initial weights,
    minibatch >= n, loss within 1e-5 and weights within 1e-4; a policy with
    no trajectory is skipped and reads NaN; the reward window and the
    result's keys."""
    env = "chase"
    js, _, jrew, _, _ = samples[env]
    _, _, mids, mapping = ENVS[env]
    mids = mids + ("idle",)
    lcfg = dict(lr=1e-3, num_epochs=2, minibatch_size=512)
    ref_cfg = jma.MultiAgentPPOConfig(
        hidden=HIDDEN, learner=jlearn.PPOLearnerConfig(**lcfg),
        num_env_runners=2, num_envs_per_runner=2, rollout_length=80,
        seed=3).environment(ENVS[env][0]).multi_agent(
            policies={m: (6, 5) for m in mids}, policy_mapping_fn=mapping)
    ref = object.__new__(jma.MultiAgentPPO)
    ref.config = ref_cfg
    ref.module = jma.MultiRLModule({m: jrl.RLModule(6, 5, HIDDEN)
                                    for m in mids})
    ref.learners = {m: jlearn.PPOLearner(ref.module[m], ref_cfg.learner,
                                         seed=ref_cfg.seed + i)
                    for i, m in enumerate(sorted(mids))}
    # Two runners handing out the same sample: trajectories merge in order.
    ref.runners = [_RefRunner(js, jrew), _RefRunner(js, jrew[:1])]
    ref.iteration, ref._reward_window = 0, []
    monkeypatch.setattr(ray_tpu, "get", lambda refs, timeout=None: refs)

    port_cfg = tma.MultiAgentPPOConfig(
        hidden=HIDDEN, learner=tlearn.PPOLearnerConfig(**lcfg),
        num_env_runners=2, num_envs_per_runner=2, rollout_length=80,
        seed=3).environment(ENVS[env][1]).multi_agent(
            policies={m: (6, 5) for m in mids}, policy_mapping_fn=mapping)
    port = port_cfg.build(device="cpu")
    assert [port.learners[m]._gen.initial_seed()
            for m in sorted(mids)] == [4 + i for i in range(len(mids))]
    assert [r._gen.initial_seed() for r in port.runners] == [3, 1003]
    for m in mids:
        port.learners[m].set_weights(convert_rl_params(
            _np(ref.learners[m].params)))
    port.runners = [_PortRunner(js, jrew), _PortRunner(js, jrew[:1])]

    jlog, tlog = {}, {}
    for m in mids:
        _recorded(ref.learners[m], jlog, m)
        _recorded(port.learners[m], tlog, m)
    r, p = ref.train(), port.train()

    assert jlog.keys() == tlog.keys() == set(mids) - {"idle"}
    for m in jlog:
        (a,), (b,) = jlog[m], tlog[m]
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert r["losses"].keys() == p["losses"].keys()
    for m in r["losses"]:
        np.testing.assert_allclose(p["losses"][m], r["losses"][m], rtol=1e-5,
                                   atol=1e-6)
        ref_w = convert_rl_params(_np(ref.learners[m].params))
        for k, v in ref_w.items():
            np.testing.assert_allclose(
                port.learners[m].get_weights()[k].numpy(), v,
                atol=WEIGHT_TOL, rtol=0, err_msg=f"{m} {k}")
    assert p["env_steps_this_iter"] == r["env_steps_this_iter"] > 0
    assert p["training_iteration"] == r["training_iteration"] == 1
    for m in mids:
        a, b = r["episode_reward_mean"][m], p["episode_reward_mean"][m]
        assert (np.isnan(a) and np.isnan(b)) or a == b, m
    assert np.isnan(p["episode_reward_mean"]["idle"])
    assert set(p) == set(r) | {"sample_time_s", "learn_time_s",
                               "env_steps_per_s"}
    # the weights the runners get are copies, not the learners' tensors
    runner = tma.MultiAgentEnvRunner(ENVS[env][1], port.module, mapping,
                                     num_envs=1)
    runner.set_weights(port.get_weights())
    m = mids[0]
    assert (runner.params[m]["Dense_0.weight"].data_ptr()
            != port.learners[m].params["Dense_0.weight"].data_ptr())


def test_train_runs_and_needs_config():
    """build() with no device needs the card (none here); a config
    without .environment() or .multi_agent() raises; two iterations over
    the in-process runners give finite losses for both policies."""
    cfg = (tma.MultiAgentPPOConfig(hidden=(8,), num_env_runners=1,
                                   num_envs_per_runner=2, rollout_length=40,
                                   seed=1)
           .environment(tch.ChaseEnv)
           .multi_agent(policies={tch.PURSUER: (6, 5), tch.EVADER: (6, 5)},
                        policy_mapping_fn=lambda aid: aid))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            cfg.build()
    with pytest.raises(ValueError):
        tma.MultiAgentPPOConfig().multi_agent(
            policies={"a": (6, 5)}, policy_mapping_fn=str).build("cpu")
    with pytest.raises(ValueError):
        tma.MultiAgentPPOConfig().environment(tch.ChaseEnv).build("cpu")
    algo = cfg.build(device="cpu")
    for it in (1, 2):
        out = algo.train()
        assert out["training_iteration"] == it
        assert set(out["losses"]) == {tch.PURSUER, tch.EVADER}
        assert all(np.isfinite(v) for v in out["losses"].values())
        assert out["env_steps_this_iter"] == 2 * 2 * 40
    assert out["episode_reward_mean"].keys() == {tch.PURSUER, tch.EVADER}
