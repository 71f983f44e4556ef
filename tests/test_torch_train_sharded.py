"""Port parity: the sharded train step (ray_tpu_torch.train.step with
mesh=/param_rules=) against the port's single-device step and against
ray_tpu.train.step's sharded step on the 8 virtual CPU devices
(tests/conftest.py).

The tiny f32 Llama starts from one flax init converted by models/convert.py
and takes tests/test_torch_train_step.py's batch (2 × 32 numpy-seeded token
ids) on every side; each mesh rank is a gloo process on the CPU
(parallel/launch.py). Tolerances are that file's: the loss within 1e-5
relative, the weights after 3 AdamW steps within 1e-4 absolute (a tenth of
the learning rate). The weights' limit holds only where no gradient is
zero up to f32 rounding: Adam moves a weight by lr · g / (|g| + 1e-8), so a
gradient of ±3e-9 that a sum in another order gives either sign moves it
by ±0.2 lr. On this batch and init no such gradient occurs
(tests/torch_parity_report.py prints each mesh's errors); other batches
and inits can hold one.

Hygiene: every rank rendezvouses through a FileStore in a temporary
directory under tmp_path; the pytest worker makes no process group; every
rank process is gone when its job returns. Each mesh's ranks run once per
module: the 2-rank meshes in one job, the 4-rank mesh (reference and flash
attention) in another, and dryrun_multigpu(4) on a thread, all started
before the reference's compiles."""

import dataclasses
import os
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from ray_tpu.models import llama as jllama
from ray_tpu.parallel.mesh import create_mesh as jcreate_mesh
from ray_tpu.train import step as jstep
from ray_tpu_torch.entry import dryrun_multigpu, full_params, train_job
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import convert_params
from ray_tpu_torch.parallel.mesh import create_mesh
from ray_tpu_torch.train import step as tstep

CPU = torch.device("cpu")
LR = 1e-3
STEPS = 3
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4
TWO = [{"tensor": 2}, {"fsdp": 2}, {"data": 2}]
FOUR = {"fsdp": 2, "tensor": 2}
# 4 query heads over 2 kv heads at TP 4: each rank holds both kv heads and
# reads one, so their gradients are summed over the tensor ranks.
TP4 = {"tensor": 4}
IMPLS = ["reference", "flash"]


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


def _cfg(impl, shape=None):
    """The tiny config; at FOUR with remat, so FSDP's gathers also run in
    the backward's recompute (the same values: remat recomputes exactly)."""
    return dataclasses.replace(tllama.LlamaConfig.tiny(), attention_impl=impl,
                               remat=shape == FOUR)


def reference_init():
    """The reference's tiny init (tests/test_torch_train_step.py's), as
    flax params and converted (models/convert.py)."""
    model = jllama.LlamaModel(jllama.LlamaConfig.tiny())
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.asarray(_ids()))["params"]
    return params, convert_params(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def init():
    return reference_init()


@pytest.fixture(scope="module")
def started(init, tmp_path_factory):
    """The rank jobs, started together before the reference's compiles,
    their rendezvous directories under a tmp path: the 2-rank meshes' and
    the 4-rank meshes' train jobs [(runs' (shape, impl), job)], and
    dryrun_multigpu(4) on a thread ({"loss"} or {"error"} once it ends).
    Any rank left is killed after."""
    sd = init[1]
    two = [(s, "reference") for s in TWO]
    four = [(FOUR, i) for i in IMPLS] + [(TP4, "reference")]
    old = tempfile.tempdir
    tempfile.tempdir = str(tmp_path_factory.mktemp("ranks"))
    jobs, dry = [], {}

    def dryrun():
        try:
            dry["loss"] = dryrun_multigpu(4, device="cpu")
        except Exception as e:  # read by the test
            dry["error"] = e

    thread = threading.Thread(target=dryrun, daemon=True)
    try:
        for keys in (two, four):
            jobs.append((keys, train_job(
                [{"shape": s, "cfg": _cfg(i, s), "ids": _ids(),
                  "steps": STEPS, "lr": LR, "state_dict": sd,
                  "want_params": True} for s, i in keys], device=CPU)))
        thread.start()
        yield jobs, (thread, dry, tempfile.tempdir)
    finally:
        for _, job in jobs:
            job.close()
        thread.join(120)
        tempfile.tempdir = old


@pytest.fixture(scope="module")
def jax_runs(started, init):
    """The reference's sharded step per impl, compiled while the ranks
    run."""
    return {impl: _jax_sharded(impl, init[0]) for impl in IMPLS}


@pytest.fixture(scope="module")
def single_runs(started, init):
    """The port's single-device step per impl, run while the ranks run."""
    return {impl: _single(impl, init[1]) for impl in IMPLS}


@pytest.fixture(scope="module")
def ranks(started, jax_runs, single_runs):
    """{(str(mesh shape), impl): [per rank train_rank result]}."""
    out = {}
    for keys, job in started[0]:
        per_rank = job.results()
        for j, (shape, impl) in enumerate(keys):
            out[str(shape), impl] = [r[j] for r in per_rank]
    assert not dist.is_initialized()
    return out


def _single(impl, sd):
    """The port's single-device step: losses, and weights after STEPS."""
    model = tllama.LlamaModel(_cfg(impl), device="cpu",
                              param_dtype=torch.float32)
    tllama.load_params(model, sd)
    opt = tstep.adamw(model.parameters(), LR)
    ids = torch.from_numpy(_ids()).long()
    state = tstep.init_train_state(model, opt, ids, device="cpu")
    step = tstep.make_train_step(model, opt)
    losses = [step(state, ids, ids)[1].item() for _ in range(STEPS)]
    return losses, {n: p.detach().numpy()
                    for n, p in model.named_parameters()}


def _jax_sharded(impl, params):
    """The reference's sharded step at FOUR, on the same weights."""
    cfg = dataclasses.replace(jllama.LlamaConfig.tiny(), attention_impl=impl)
    model = jllama.LlamaModel(cfg)
    opt = optax.adamw(LR)
    mesh = jcreate_mesh(FOUR, devices=jax.devices()[:4])
    ids = jnp.asarray(_ids())
    # init_train_state's placement, without compiling the init again.
    params = jax.device_put(
        params, jllama.LLAMA_SHARDING.tree_shardings(mesh, params))
    state = jstep.TrainState(jnp.zeros((), jnp.int32), params,
                             opt.init(params))
    step = jstep.make_train_step(model, opt, mesh=mesh,
                                 param_rules=jllama.LLAMA_SHARDING,
                                 donate=False)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, ids, ids)
        losses.append(float(loss))
    return losses, convert_params(jax.tree.map(np.asarray, state.params))


def _assert_close(results, losses, params, what):
    for r in results:
        np.testing.assert_allclose(r["losses"], losses, rtol=LOSS_RTOL,
                                   err_msg=f"{what} rank {r['rank']}")
    got = full_params(results)
    assert set(got) == set(params)
    for n in params:
        np.testing.assert_allclose(got[n], params[n], atol=PARAM_ATOL,
                                   rtol=0, err_msg=f"{what} {n}")


@pytest.mark.parametrize("shape,impl", [(s, "reference") for s in TWO]
                         + [(FOUR, i) for i in IMPLS]
                         + [(TP4, "reference")])
def test_sharded_step_matches_single_device(ranks, single_runs, shape,
                                            impl):
    """After 3 steps at each mesh, every rank's losses and the unsharded
    weights equal the port's single-device step's."""
    losses, params = single_runs[impl]
    _assert_close(ranks[(str(shape), impl)], losses, params,
                  f"{shape} {impl}")


@pytest.mark.parametrize("impl", IMPLS)
def test_sharded_step_matches_reference_sharded_step(ranks, jax_runs,
                                                     impl):
    """The port at {"fsdp": 2, "tensor": 2} against the reference's
    make_train_step(mesh=, param_rules=LLAMA_SHARDING) on 4 CPU devices
    (flash: the Pallas kernels interpreted, the port's FlashAttention
    autograd on its plain versions)."""
    losses, params = jax_runs[impl]
    _assert_close(ranks[(str(FOUR), impl)], losses, params, f"jax {impl}")


def test_ranks_hold_local_heads(ranks):
    """Under TP 2 a rank holds 2 of 4 query heads and 1 of 2 kv heads; under
    TP 4, 1 query head and both kv heads."""
    for r in ranks[(str(FOUR), "flash")] + ranks[(str(TWO[0]),
                                                    "reference")]:
        assert (r["heads"], r["kv_heads"]) == (2, 1)
    for r in ranks[(str(TP4), "reference")]:
        assert (r["heads"], r["kv_heads"]) == (1, 2)


def test_shard_shapes_match_reference_without_processes():
    """The analog of tests/test_train_step.py:60: at {"fsdp": 2, "tensor":
    4}, gate_proj's rank shard (from param_shards after place_params, on
    the meta device, no process) has JAX's shard_shape, transposed to the
    torch layout."""
    cfg = jllama.LlamaConfig.tiny()
    shape = {"fsdp": 2, "tensor": 4}
    jmesh = jcreate_mesh(shape)
    params = jax.eval_shape(jllama.LlamaModel(cfg).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    sh = jllama.LLAMA_SHARDING.tree_shardings(jmesh, params)
    gate = params["layers_0"]["mlp"]["gate_proj"]["kernel"]
    want = sh["layers_0"]["mlp"]["gate_proj"]["kernel"].shard_shape(
        gate.shape)
    mesh = create_mesh(shape, devices=[CPU] * 8)
    for rank in range(8):
        model = tllama.LlamaModel(tllama.LlamaConfig.tiny(), device="meta",
                                  mesh=mesh, rank=rank)
        tllama.place_params(model, tllama.LLAMA_SHARDING)
        full, index = tllama.param_shards(model)[
            "layers.0.mlp.gate_proj.weight"]
        got = tuple(s.stop - s.start for s in index)
        local = model.layers[0].mlp.gate_proj.weight.shape
        assert got == tuple(local) == want[::-1], rank
        assert full == gate.shape[::-1]


def test_unsplittable_batch_and_unported_axes_raise():
    """A batch that data x fsdp does not divide, and a sequence that the
    "seq" axis does not divide, raise ValueError; MoE layers over a "seq"
    axis raise NotImplementedError, while "seq" (with ring attention),
    "stage" and "expert" axes are taken (tests/test_torch_ep.py trains
    over "expert")."""
    mesh = create_mesh({"data": 2, "fsdp": 2}, devices=[CPU] * 4)
    model = tllama.LlamaModel(_cfg("reference"), device="cpu",
                              param_dtype=torch.float32, mesh=mesh, rank=1)
    opt = tstep.adamw(model.parameters(), LR)
    with pytest.raises(ValueError, match="does not split"):
        tstep.init_train_state(model, opt, torch.zeros((6, 8), dtype=torch.long),
                               device="cpu", mesh=mesh,
                               param_rules=tllama.LLAMA_SHARDING)
    seq = create_mesh({"seq": 2, "data": 2}, devices=[CPU] * 4)
    model = tllama.LlamaModel(_cfg("ring"), device="cpu",
                              param_dtype=torch.float32, mesh=seq, rank=3)
    opt = tstep.adamw(model.parameters(), LR)
    with pytest.raises(ValueError, match="sequence of 7 tokens"):
        tstep.init_train_state(model, opt, torch.zeros((4, 7), dtype=torch.long),
                               device="cpu", mesh=seq,
                               param_rules=tllama.LLAMA_SHARDING)
    bad = create_mesh({"seq": 2}, devices=[CPU] * 2)
    with pytest.raises(NotImplementedError, match="not ported"):
        tllama.LlamaModel(dataclasses.replace(_cfg("ring"), num_experts=2),
                          device="meta", mesh=bad, rank=0)
    for shape, impl in (({"seq": 2}, "ring"), ({"stage": 2}, "reference"),
                        ({"expert": 2}, "reference")):
        ok = create_mesh(shape, devices=[CPU] * 2)
        model = tllama.LlamaModel(_cfg(impl), device="meta", mesh=ok, rank=1)
        assert model.seq == ((2, 1) if "seq" in shape else (1, 0))
        assert (model.ep is not None) == ("expert" in shape)


def test_dryrun_multigpu_on_cpu_ranks(started):
    """dryrun_multigpu(4) (the mesh {"seq": 2, "tensor": 2} with ring
    attention, then the pipeline at {"stage": 2, "data": 2}) in four CPU
    rank processes: one step, the same finite loss on every rank, the
    pipeline's output of xs's shape; no process group in this worker, the
    rendezvous directories gone."""
    thread, dry, tmp = started[1]
    thread.join(300)
    assert not thread.is_alive()
    assert "error" not in dry, dry.get("error")
    assert np.isfinite(dry["loss"]) and 0 < dry["loss"] < 20
    assert not dist.is_initialized()
    assert not [d for d in os.listdir(tmp)
                if d.startswith("ray_tpu_torch_ranks_")]
