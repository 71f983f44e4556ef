"""Port parity for RLlib's offline stack (ray_tpu_torch/rllib/{offline,bc,
cql}.py against ray_tpu/rllib/, on the CPU): record_episodes column for
column, OfflineData's batches, and one BC and one CQL train() from the
reference's init, converted by models/convert.py. The data is the reference
test's fixture (tests/test_rllib_offline.py: GridWorldEnv(size=6, seed=3),
150 expert episodes at seed 0, max_steps 48), held in memory as two blocks
behind ``iter_blocks()``, which both packages' OfflineData read; no runtime
and no parquet.

Tolerances (ROADMAP rule 4): the copies and the batches exactly; a train()
pass's mean loss within 1e-5 relative and the weights after it within 1e-4.
The learning checks (BC and CQL clearing the reference test's return
limits) run on the card in chip_smoke.py and over seeds in
tests/torch_rllib_seed_report.py."""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rllib import bc as jbc
from ray_tpu.rllib import cql as jcql
from ray_tpu.rllib import offline as joff
from ray_tpu.rllib.examples import gridworld as jgrid
from ray_tpu_torch.models.convert import convert_rl_params
from ray_tpu_torch.rllib import bc as tbc
from ray_tpu_torch.rllib import cql as tcql
from ray_tpu_torch.rllib import offline as toff
from ray_tpu_torch.rllib.examples import gridworld as tgrid
from ray_tpu_torch.rllib.learner import set_params_
from ray_tpu_torch.rllib.rl_module import clone_weights

LOSS_RTOL = 1e-5
WEIGHT_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads for this module's torch work, restored after
    (several pytest workers share the machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class Blocks:
    """A dataset of transition blocks (what OfflineData reads from a Data
    dataset): ``iter_blocks()`` yields them."""

    def __init__(self, *blocks):
        self.blocks = blocks

    def iter_blocks(self):
        return iter(self.blocks)


def two_blocks(block, cut=300):
    return Blocks({k: v[:cut] for k, v in block.items()},
                  {k: v[cut:] for k, v in block.items()})


def record(pkg, off, expert=True, **kw):
    env = pkg.GridWorldEnv(size=6, seed=3)
    return off.record_episodes(
        lambda: env, policy=pkg.expert_policy(env) if expert else None,
        **kw)


@pytest.fixture(scope="module")
def blocks():
    """The reference test's fixture, recorded by each package."""
    kw = dict(n_episodes=150, seed=0, max_steps=48)
    return record(jgrid, joff, **kw), record(tgrid, toff, **kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_weights(port, ref_tree, tol=WEIGHT_TOL):
    ref = convert_rl_params(_np(ref_tree))
    assert set(port) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(port[k].detach().numpy(), v, atol=tol,
                                   rtol=0, err_msg=k)


def test_record_episodes_matches_reference(blocks):
    """Column for column, dtypes included: the expert fixture and 20
    uniform-random episodes (the policy's draws from the same rng)."""
    random = [record(pkg, off, expert=False, n_episodes=20, seed=5,
                     max_steps=48)
              for pkg, off in ((jgrid, joff), (tgrid, toff))]
    for ref, port in (blocks, random):
        assert list(port) == list(ref)
        for k in ref:
            assert port[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    assert len(blocks[1]["action"]) == 775
    assert random[1]["done"].sum() <= 20


def test_offline_data_batches_match_reference(blocks):
    block = blocks[1]
    ds = two_blocks(block)
    ref, port = joff.OfflineData(ds), toff.OfflineData(ds)
    assert port.num_transitions() == ref.num_transitions() == 775
    for seed in (0, 1):
        got = list(port.iter_train_batches(batch_size=64, num_epochs=2,
                                           seed=seed))
        want = list(ref.iter_train_batches(batch_size=64, num_epochs=2,
                                           seed=seed))
        assert len(got) == len(want) == 24
        for g, w in zip(got, want):
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    # A list column (an object array of rows) stacks to f32.
    rows = np.empty(len(block["obs"]), dtype=object)
    for i, r in enumerate(block["obs"]):
        rows[i] = r.tolist()
    listed = Blocks(dict(block, obs=rows))
    got = toff.OfflineData(listed)._table()["obs"]
    want = joff.OfflineData(listed)._table()["obs"]
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, block["obs"])
    with pytest.raises(NotImplementedError, match="Data"):
        toff.OfflineData("/some/episodes")
    with pytest.raises(ValueError, match="empty"):
        toff.OfflineData(Blocks()).num_transitions()


def _pair(ref_config, port_config, ds, **training):
    """The reference's and the port's algorithm on ``ds``, the port's
    weights the reference's init."""
    ref = (ref_config().environment(obs_dim=8, num_actions=4)
           .offline_data(dataset=ds).training(**training).build())
    port = (port_config().environment(obs_dim=8, num_actions=4)
            .offline_data(dataset=ds).training(**training)
            .build(device="cpu"))
    set_params_(port.params, convert_rl_params(_np(ref.params)))
    return ref, port


def test_bc_and_cql_train_match_reference(blocks):
    """One train() pass each: BC at batch 256 (3 updates), CQL at batch 64
    with target_update_every 2 (12 updates, 6 target copies); the mean
    loss, the weights, the target, and greedy actions on 32 rows."""
    ds = two_blocks(blocks[1])
    obs = blocks[1]["obs"][::24][:32]
    ref, port = _pair(jbc.BCConfig, tbc.BCConfig, ds)
    value_head = {k: port.params[k].detach().clone()
                  for k in ("Dense_3.weight", "Dense_3.bias")}
    r, p = ref.train(), port.train()
    assert p["num_batches"] == r["num_batches"] == 3
    assert p["training_iteration"] == r["training_iteration"] == 1
    np.testing.assert_allclose(p["loss"], r["loss"], rtol=LOSS_RTOL)
    _assert_weights(port.get_weights(), ref.params)
    for k, v in value_head.items():  # no gradient reaches the value head
        torch.testing.assert_close(port.params[k].detach(), v, rtol=0,
                                   atol=0)
    np.testing.assert_array_equal(port.compute_actions(obs),
                                  ref.compute_actions(obs))

    ref, port = _pair(jcql.CQLConfig, tcql.CQLConfig, ds,
                      train_batch_size=64, cql_alpha=1.0)
    ref.config.learner.target_update_every = 2
    port.config.learner.target_update_every = 2
    port.target_params = clone_weights(port.params)
    r, p = ref.train(), port.train()
    assert p["num_batches"] == r["num_batches"] == 12
    np.testing.assert_allclose(p["loss"], r["loss"], rtol=LOSS_RTOL)
    _assert_weights(port.get_weights(), ref.params)
    _assert_weights(port.target_params, ref.target_params)
    np.testing.assert_array_equal(port.compute_actions(obs),
                                  ref.compute_actions(obs))


def test_cql_target_is_a_snapshot(blocks):
    """At batch 256 a pass takes 3 updates; with target_update_every 2 the
    target is copied after update 2, so after the first pass it lags the
    online weights by one update (as the reference's), shares no storage
    with them, and after the second pass (copies after 4 and 6: the count
    runs across train() calls) equals them."""
    ds = two_blocks(blocks[1])
    ref, port = _pair(jcql.CQLConfig, tcql.CQLConfig, ds,
                      train_batch_size=256)
    ref.config.learner.target_update_every = 2
    port.config.learner.target_update_every = 2
    port.target_params = clone_weights(port.params)
    ref.train()
    port.train()
    _assert_weights(port.target_params, ref.target_params)
    for k, v in port.target_params.items():
        assert not torch.equal(v, port.params[k].detach()), k
        assert v.data_ptr() != port.params[k].data_ptr()
    ref.train()
    port.train()
    _assert_weights(port.get_weights(), ref.params)
    for k, v in port.target_params.items():
        torch.testing.assert_close(v, port.params[k].detach(), rtol=0,
                                   atol=0)


def test_configs_raise_and_run_on_the_card_by_default(blocks, monkeypatch):
    """build() checks the config as the reference's asserts do; with no
    device it needs the card (no CUDA here: it raises)."""
    ds = two_blocks(blocks[1])
    for config in (tbc.BCConfig, tcql.CQLConfig):
        with pytest.raises(ValueError, match="environment"):
            config().offline_data(dataset=ds).build(device="cpu")
        with pytest.raises(ValueError, match="offline_data"):
            config().environment(obs_dim=8, num_actions=4).build(
                device="cpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            config().environment(obs_dim=8, num_actions=4).offline_data(
                dataset=ds).build()
        monkeypatch.undo()
    algo = (tbc.BCConfig().environment(obs_dim=8, num_actions=4)
            .offline_data(dataset=Blocks({k: v[:100] for k, v in
                                          blocks[1].items()}))
            .build(device="cpu"))
    assert algo.train() == {"training_iteration": 1, "loss": None,
                            "num_batches": 0}
    ev = algo.evaluate(lambda: tgrid.GridWorldEnv(size=6, seed=3),
                       n_episodes=2, max_steps=5)
    assert ev["episodes"] == 2 and np.isfinite(ev["episode_return_mean"])
