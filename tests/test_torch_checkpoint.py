"""Port parity for train-state checkpoints (ray_tpu_torch/train/
_checkpoint.py against ray_tpu/train/_checkpoint.py, on the CPU):
CheckpointManager's retention against the reference's on the same
registrations; save_pytree/load_pytree on a tree (the counterpart of
tests/test_train_backends.py::test_orbax_pytree_roundtrip); the tiny f32
Llama's train state saved after 2 AdamW steps, restored into a state drawn
from another seed, and stepped once more, against the same state stepped on
and against the reference's 3 jitted steps with its orbax round trip
between steps 2 and 3; and the same round trip on each rank of a 4-rank
gloo job at {"fsdp": 2, "tensor": 2}, whose checkpoint a state at
{"data": 4} must refuse.

Tolerances: a round trip changes nothing, so the restored state's loss,
parameters and AdamW moments equal the continued state's bit for bit; the
port against the reference as tests/test_torch_train_step.py holds them
(the loss within 1e-5 relative, the weights within 1e-4 absolute, a tenth
of the learning rate).

Hygiene: the rank job rendezvouses through a FileStore under tmp_path and
starts before the reference's compile; every rank process is gone when
its job returns."""

import dataclasses
import os
import pickle
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.train import _checkpoint as jck
from ray_tpu.train import step as jstep
from ray_tpu_torch.entry import train_job, train_rank
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import convert_params
from ray_tpu_torch.parallel.mesh import create_mesh
from ray_tpu_torch.train import _checkpoint as tck
from ray_tpu_torch.train import adamw, init_train_state

CPU = torch.device("cpu")
LR = 1e-3
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4
FOUR = {"fsdp": 2, "tensor": 2}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads in this worker (each rank process takes its
    share of them), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ids():
    return np.random.default_rng(0).integers(0, 512, (2, 32),
                                             dtype=np.int32)


def _flash():
    return dataclasses.replace(tllama.LlamaConfig.tiny(),
                               attention_impl="flash")


@pytest.fixture(scope="module", autouse=True)
def mesh_job(tmp_path_factory):
    """The 4-rank round trip at FOUR (tiny f32, flash attention, 2 steps
    from seed 3), started with the module, before the reference compiles:
    (checkpoint directory, the job)."""
    root = tmp_path_factory.mktemp("ranks")
    old = tempfile.tempdir
    tempfile.tempdir = str(root)
    path = str(root / "ckpt")
    job = train_job([{"shape": FOUR, "cfg": _flash(), "ids": _ids(),
                      "steps": 2, "lr": LR, "seed": 3, "checkpoint": path}],
                    device=CPU)
    try:
        yield path, job
    finally:
        job.close()
        tempfile.tempdir = old


def _register_all(module, storage, sources, score_attribute, order):
    mgr = module.CheckpointManager(storage, num_to_keep=2,
                                   score_attribute=score_attribute,
                                   score_order=order)
    scores = [3.0, 1.0, None, 4.0, 2.0]
    for i, (src, score) in enumerate(zip(sources, scores)):
        metrics = {"it": i} if score is None else {"it": i, "score": score}
        mgr.register(src, metrics, move=i % 2 == 1)
    return mgr


@pytest.mark.parametrize("score_attribute,order",
                         [(None, "max"), ("score", "max"), ("score", "min")])
def test_checkpoint_manager_matches_reference(tmp_path, score_attribute,
                                              order):
    """Five registrations (copied and moved, one without a score) into a
    storage that already holds checkpoint_000004: the same surviving
    directories, ``latest``, ``best`` and numbering as the reference's."""
    out = {}
    for name, module in (("ref", jck), ("port", tck)):
        storage = tmp_path / name / "store"
        os.makedirs(storage / "checkpoint_000004")
        sources = []
        for i in range(5):
            src = tmp_path / name / f"src{i}"
            os.makedirs(src)
            (src / "data.txt").write_text(str(i))
            sources.append(str(src))
        mgr = _register_all(module, str(storage), sources, score_attribute,
                            order)
        out[name] = (sorted(os.listdir(storage)),
                     os.path.basename(mgr.latest.path),
                     os.path.basename(mgr.best.path), mgr._index,
                     sorted(os.path.basename(e[2]) for e in mgr._entries))
    assert out["port"] == out["ref"]
    assert out["port"][3] == 9
    ck = tck.Checkpoint(str(tmp_path / "port" / "store" / out["port"][1]))
    copy = ck.to_directory(str(tmp_path / "copy"))
    assert sorted(os.listdir(copy)) == ["data.txt"]
    assert pickle.loads(pickle.dumps(ck)).path == ck.path


def test_pytree_roundtrip(tmp_path):
    """test_orbax_pytree_roundtrip's tree, plus lists, tuples, Python
    scalars and numpy scalars of their own types; a target tree is
    overwritten in place; a leaf torch cannot hold raises."""
    tree = {"w": torch.arange(12.0).reshape(3, 4), "step": np.int64(7),
            "nested": {"b": torch.ones(5), "n": np.arange(4, dtype=np.int16),
                       "s": [np.float32(0.5), (1, 2.5, True, None, "x")]},
            "view": torch.arange(100_000.0)[2:5]}
    ckpt = tck.save_pytree(tree, str(tmp_path / "ck"))
    restored = tck.load_pytree(ckpt)
    np.testing.assert_array_equal(np.asarray(restored["w"]),
                                  np.arange(12.0).reshape(3, 4))
    np.testing.assert_array_equal(np.asarray(restored["nested"]["b"]),
                                  np.ones(5))
    assert int(restored["step"]) == 7
    assert type(restored["step"]) is np.int64
    n = restored["nested"]["n"]
    assert type(n) is np.ndarray and n.dtype == np.int16
    s = restored["nested"]["s"]
    assert type(s[0]) is np.float32 and s[1] == (1, 2.5, True, None, "x")
    assert torch.equal(restored["view"], torch.tensor([2.0, 3.0, 4.0]))
    assert os.path.getsize(os.path.join(ckpt.path, tck.FILE)) < 8192
    target = {"w": torch.zeros(3, 4), "step": 0,
              "nested": {"b": torch.zeros(5), "n": None, "s": [0, (0,) * 5]},
              "view": torch.zeros(3)}
    w = target["w"]
    out = tck.load_pytree(ckpt, target=target)
    assert out["w"] is w and torch.equal(w, tree["w"])
    assert type(out["step"]) is np.int64
    with pytest.raises(ValueError, match="keys"):
        tck.load_pytree(ckpt, target={"w": torch.zeros(3, 4)})
    with pytest.raises(TypeError, match="cannot be saved"):
        tck.save_pytree({"o": np.array(["a"], dtype=object)},
                        str(tmp_path / "bad"))
    with pytest.raises(TypeError, match="set"):
        tck.save_pytree({"o": {1, 2}}, str(tmp_path / "bad"))


def _state(cfg, seed):
    model = tllama.LlamaModel(cfg, device=CPU, param_dtype=torch.float32)
    opt = adamw(model.parameters(), LR)
    return init_train_state(model, opt, torch.from_numpy(_ids()),
                            device=CPU,
                            generator=torch.Generator().manual_seed(seed))


def test_train_state_round_trip_matches_reference(tmp_path):
    """train_rank's round trip on one device from the reference's init:
    the restored state's third step equals the continued state's exactly,
    and both match the reference's 3 steps with its orbax round trip."""
    cfg = tllama.LlamaConfig.tiny()
    jm = jllama.LlamaModel(jllama.LlamaConfig.tiny())
    opt = optax.adamw(LR)
    ids = jnp.asarray(_ids())
    jstate = jstep.init_train_state(jm, opt, ids)
    sd = convert_params(jax.tree.map(np.asarray, jstate.params))
    res = train_rank(create_mesh({"data": 1}, devices=[CPU]), 0, cfg,
                     _ids(), 2, LR, state_dict=sd, want_params=True,
                     checkpoint=str(tmp_path / "port"))
    ck = res["checkpoint"]
    assert ck["equal"] and ck["restored_at_step"] == 2
    assert ck["loss"] == ck["restored_loss"]
    raw = tck.load_pytree(tck.Checkpoint(str(tmp_path / "port")))
    assert raw["step"] == 2 and set(raw["params"]) == set(sd)
    assert len(raw["opt_state"]["state"]) == len(sd)

    fn = jstep.make_train_step(jm, opt, donate=False)
    for _ in range(2):
        jstate, _ = fn(jstate, ids, ids)
    saved = jck.save_pytree(jstate, str(tmp_path / "ref"))
    jstate = jck.load_pytree(saved, target=jstate)
    jstate, jloss = fn(jstate, ids, ids)
    assert int(jstate.step) == 3
    np.testing.assert_allclose(ck["loss"], float(jloss), rtol=LOSS_RTOL)
    want = convert_params(jax.tree.map(np.asarray, jstate.params))
    for n, p in res["params"].items():
        np.testing.assert_allclose(p, want[n], atol=PARAM_ATOL, rtol=0,
                                   err_msg=n)


def test_mismatched_restores_raise_and_load_nothing(tmp_path):
    """A state of another depth, or whose optimizer holds the parameters in
    another order, refuses the checkpoint before anything is copied."""
    cfg = tllama.LlamaConfig.tiny()
    ckpt = tck.save_pytree(_state(cfg, 0), str(tmp_path / "ck"))
    shallow = _state(dataclasses.replace(cfg, num_layers=1), 1)
    before = {n: p.detach().clone()
              for n, p in shallow.model.named_parameters()}
    with pytest.raises(ValueError, match="missing"):
        tck.load_pytree(ckpt, target=shallow)
    for n, p in shallow.model.named_parameters():
        assert torch.equal(p, before[n])
    assert shallow.step == 0 and not shallow.optimizer.state
    other = _state(cfg, 1)
    params = list(other.model.parameters())
    other.optimizer = adamw(params[::-1], LR)
    with pytest.raises(ValueError, match="order"):
        tck.load_pytree(ckpt, target=other)
    with pytest.raises(ValueError, match="tree, not a train state"):
        tck.load_pytree(tck.save_pytree({"a": 1}, str(tmp_path / "t")),
                        target=_state(cfg, 1))


def test_sharded_round_trip_and_refused_mesh(mesh_job):
    """Each rank of the job at FOUR saves its part, restores it into a
    state from another seed, and steps on exactly as the saved state does;
    a state at {"data": 4} refuses the checkpoint, and it cannot be read
    whole outside the ranks."""
    path, job = mesh_job
    res = [r[0] for r in job.results(300)]
    assert sorted(os.listdir(path)) == [tck.rank_file(r) for r in range(4)]
    for r in res:
        ck = r["checkpoint"]
        assert ck["equal"] and ck["restored_at_step"] == 2, (r["rank"], ck)
        assert ck["loss"] == ck["restored_loss"] == res[0]["checkpoint"][
            "loss"]
    data4 = create_mesh({"data": 4}, devices=[CPU] * 4)
    model = tllama.LlamaModel(_flash(), device=CPU,
                              param_dtype=torch.float32, mesh=data4, rank=1)
    state = tck.TrainState(0, model, adamw(model.parameters(), LR))
    with pytest.raises(ValueError, match="resharding"):
        tck.load_pytree(tck.Checkpoint(path), target=state)
    with pytest.raises(ValueError, match="each rank"):
        tck.load_pytree(tck.Checkpoint(path))
    with pytest.raises(ValueError, match="another mesh"):
        tck.load_pytree(tck.Checkpoint(path), target=_state(_flash(), 0))
