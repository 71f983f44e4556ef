"""Port parity for batch inference (llm/_internal/batch.py): the same dict
batch through ray_tpu's _EngineStage and ray_tpu_torch's, over the same
weights (one pickle of a JAX init read by both packages'
load_model_and_params), must give equal generated_ids and num_generated.
Processor is checked over a list-backed dataset that records the Data API
calls it makes. No ray_tpu.init and no Data actors."""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm._internal import batch as jbatch
from ray_tpu.models import llama as jllama
from ray_tpu_torch.llm import Processor, ProcessorConfig, build_llm_processor
from ray_tpu_torch.llm._internal import batch as tbatch


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads for this module's torch work, restored after
    (several pytest workers share the machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def llm_config(tmp_path_factory):
    """A LlamaConfig.tiny(vocab_size=512) JAX init as a numpy pickle."""
    model = jllama.LlamaModel(jllama.LlamaConfig.tiny(vocab_size=512))
    params = jax.jit(model.init)(jax.random.PRNGKey(2),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    path = str(tmp_path_factory.mktemp("batch") / "params.pkl")
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)
    return {"model": "tiny", "model_config": {"vocab_size": 512},
            "params_path": path,
            "engine_config": {"max_seqs": 3, "page_size": 4,
                              "max_pages_per_seq": 16, "decode_steps": 1}}


@pytest.fixture(scope="module")
def stages(llm_config):
    """(reference, port) engine stages, one each for the module."""
    ref = jbatch._EngineStage(jbatch.ProcessorConfig(llm_config=llm_config,
                                                     max_tokens=7))
    port = tbatch._EngineStage(ProcessorConfig(llm_config=llm_config,
                                               max_tokens=7), device="cpu")
    return ref, port


def _ragged(seed, n=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, int(rng.integers(3, 20))).astype(np.int64)
            for _ in range(n)]


def _column(rows):
    col = np.empty(len(rows), dtype=object)
    col[:] = rows
    return col


def assert_same_batch(port, ref):
    assert set(port) == set(ref)
    for out in (port, ref):
        ids = out["generated_ids"]
        assert ids.dtype == object and ids.ndim == 1
        assert all(r.dtype == np.int32 for r in ids)
        assert out["num_generated"].dtype == np.int64
    for a, b in zip(port["generated_ids"], ref["generated_ids"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port["num_generated"],
                                  ref["num_generated"])


def test_ragged_block_with_row_budgets_equals_reference(stages):
    """Five ragged rows, each with its own max_tokens, through three slots
    (continuous batching admits the last two as slots free)."""
    ref, port = stages
    batch = {"prompt_ids": _column(_ragged(0)),
             "max_tokens": np.array([4, 9, 1, 6, 12]),
             "tag": np.arange(5)}
    got, want = port(dict(batch)), ref(dict(batch))
    assert_same_batch(got, want)
    np.testing.assert_array_equal(got["num_generated"], [4, 9, 1, 6, 12])
    np.testing.assert_array_equal(got["tag"], batch["tag"])


def test_equal_length_block_stays_an_object_column(stages):
    """Every row the same length (dense prompt column, default budget):
    generated_ids is still a 1-D object column of int32 arrays."""
    ref, port = stages
    prompts = np.random.default_rng(1).integers(0, 512, (4, 6))
    got, want = port({"prompt_ids": prompts}), ref({"prompt_ids": prompts})
    assert_same_batch(got, want)
    assert got["generated_ids"].shape == (4,)
    np.testing.assert_array_equal(got["num_generated"], [7] * 4)


class RecordingDataset:
    """A list of row dicts with the Data API's map and map_batches: records
    each call and its kwargs, and runs a callable class on the whole list
    as one batch of numpy columns."""

    def __init__(self, rows, calls=None):
        self.rows = rows
        self.calls = [] if calls is None else calls

    def map(self, fn, **kwargs):
        self.calls.append(("map", fn, kwargs))
        return RecordingDataset([fn(dict(r)) for r in self.rows], self.calls)

    def map_batches(self, fn, **kwargs):
        self.calls.append(("map_batches", fn, kwargs))
        stage = fn(*kwargs["fn_constructor_args"],
                   **(kwargs.get("fn_constructor_kwargs") or {}))
        batch = {k: _column([r[k] for r in self.rows]) for k in self.rows[0]}
        out = stage(batch)
        return RecordingDataset(
            [{k: v[i] for k, v in out.items()} for i in range(len(self.rows))],
            self.calls)


def test_processor_makes_the_data_calls_of_the_reference(llm_config, stages):
    """Processor calls map(preprocess), map_batches(_EngineStage, ...) with
    the reference's kwargs (num_tpus named num_gpus, the device through
    fn_constructor_kwargs) and map(postprocess); the rows equal the stage's
    own output."""
    def pre(row):
        return {"prompt_ids": np.asarray(row["text"], np.int64)}

    def post(row):
        return {"n": int(row["num_generated"]),
                "ids": [int(t) for t in row["generated_ids"]]}

    rows = [{"text": list(p)} for p in _ragged(2, n=4)]
    kw = dict(llm_config=llm_config, batch_size=8, concurrency=2,
              max_tokens=5)
    cfg = ProcessorConfig(num_gpus=1.0, **kw)
    ds = RecordingDataset(rows)
    out = build_llm_processor(cfg, pre, post, device="cpu")(ds)
    jcfg = jbatch.ProcessorConfig(num_tpus=1.0, **kw)
    jds = RecordingDataset(rows)
    jout = jbatch.build_llm_processor(jcfg, pre, post)(jds)

    assert [c[0] for c in ds.calls] == ["map", "map_batches", "map"]
    assert ds.calls[0][1] is pre and ds.calls[2][1] is post
    assert ds.calls[1][1] is tbatch._EngineStage
    assert ds.calls[1][2] == {
        "batch_size": 8, "concurrency": 2, "num_gpus": 1.0,
        "fn_constructor_args": (cfg,),
        "fn_constructor_kwargs": {"device": "cpu"}}
    ref_kwargs = dict(jds.calls[1][2])
    ref_kwargs["num_gpus"] = ref_kwargs.pop("num_tpus")
    ref_kwargs["fn_constructor_args"] = (cfg,)
    assert {k: v for k, v in ds.calls[1][2].items()
            if k != "fn_constructor_kwargs"} == ref_kwargs
    assert out.rows == jout.rows
    assert [r["n"] for r in out.rows] == [5] * 4
    batch = {"prompt_ids": _column([pre(r)["prompt_ids"] for r in rows]),
             "max_tokens": np.full(len(rows), 5)}
    direct = stages[1](batch)
    assert [r["ids"] for r in out.rows] == [
        [int(t) for t in ids] for ids in direct["generated_ids"]]


def test_processor_config_fields_mirror_the_reference():
    port = [f.name for f in dataclasses.fields(ProcessorConfig)]
    ref = [f.name for f in dataclasses.fields(jbatch.ProcessorConfig)]
    assert port == [n.replace("num_tpus", "num_gpus") for n in ref]
    assert Processor(ProcessorConfig()).device is None


def test_stage_raises_without_cuda(llm_config, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbatch._EngineStage(ProcessorConfig(llm_config=llm_config))
