"""Port parity: expert parallelism (parallel/ep.py, models/moe.py over a
mesh) against ray_tpu's sharded MoE on the 8 virtual CPU devices
(tests/conftest.py).

Training: the tiny f32 MoE Llama (4 experts, capacity factor 1.25, plain
attention, no remat) starts from one flax init converted by
models/convert.py and takes 3 AdamW steps on a batch of 4 × 32 seeded ids
at {"expert": 2, "data": 2}, {"expert": 2, "tensor": 2} and {"expert": 2,
"fsdp": 2}, each rank a gloo process on the CPU (parallel/launch.py).
Tolerances are tests/test_torch_train_sharded.py's: the loss within 1e-5
relative, the weights within 1e-4 (a tenth of the learning rate). At C =
int(1.25 · 32 / 4) = 10 slots an expert some tokens are dropped, and the
ranks must drop the same ones. As there, the weights' limit is well posed
only where no step-1 gradient is zero up to f32 rounding (Adam moves a
weight by about lr · g / (|g| + 1e-8)): against the reference, an o_proj
weight whose step-1 gradient is 2.1e-8 lies 8.1e-5 apart on the port's
one device already, and 8.7e-5 at {"expert": 2, "data": 2}
(tests/torch_parity_report.py prints each mesh's errors).

Serving: the same model's engine at {"tensor": 2} and {"expert": 2}, each
rank a gloo process (llm/_internal/tp.py), decodes the same greedy tokens
as the port on one device and as the reference's LLMEngine(mesh=) on 2
CPU devices, on the same weights (0 differ). Its 26-token prompt pads to
the 32 bucket (C = 10) and its prefill drops 1 and 8 tokens in the two
layers (as tests/test_torch_moe.py's).

Every training case runs in one job of four rank processes, started with a
job whose two ranks fail before the reference compiles, and the serving
ranks run on a thread meanwhile; the pytest worker makes no process group
and every rank process is gone when its job or engine closes."""

import concurrent.futures
import dataclasses
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from ray_tpu.llm._internal import engine as jeng
from ray_tpu.models import llama as jllama
from ray_tpu.parallel.mesh import create_mesh as jcreate_mesh
from ray_tpu.train import step as jstep
from ray_tpu_torch.entry import dryrun_ep_run, full_params, train_job
from ray_tpu_torch.llm._internal import engine as teng
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import convert_params
from ray_tpu_torch.parallel.launch import RankError
from ray_tpu_torch.parallel.mesh import create_mesh
from ray_tpu_torch.train import step as tstep

CPU = torch.device("cpu")
LR = 1e-3
STEPS = 3
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4
EXPERTS = 4
EP_DP = {"expert": 2, "data": 2}
MESHES = [EP_DP, {"expert": 2, "tensor": 2}, {"expert": 2, "fsdp": 2}]
SERVE = [{"tensor": 2}, {"expert": 2}]
ENGINE = dict(max_seqs=2, page_size=4, max_pages_per_seq=16, decode_steps=2)
# Admitted together: one batched prefill whose first row drops tokens.
REQUESTS = {"a": list(range(40, 66)), "b": [5, 17, 42, 7]}
MAX_TOKENS = 6


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads in this worker (each rank process takes its
    share of them), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ids():
    return np.random.default_rng(0).integers(0, 512, (4, 32),
                                             dtype=np.int32)


def _cfgs():
    """The tiny MoE config of the reference and of the port."""
    return (dataclasses.replace(jllama.LlamaConfig.tiny(),
                                num_experts=EXPERTS),
            dataclasses.replace(tllama.LlamaConfig.tiny(),
                                num_experts=EXPERTS))


def weights():
    """The reference's tiny MoE init, as flax params and converted
    (models/convert.py)."""
    model = jllama.LlamaModel(_cfgs()[0])
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.asarray(_ids()[:, :8]))["params"]
    return params, convert_params(jax.tree.map(np.asarray, params))


def rank_runs(sd):
    """The job's runs: 3 steps at each of MESHES from the state dict
    ``sd``, then the dry run's EP part."""
    runs = [{"shape": shape, "cfg": _cfgs()[1], "ids": _ids(),
             "steps": STEPS, "lr": LR, "state_dict": sd,
             "want_params": True} for shape in MESHES]
    return runs + [dryrun_ep_run(4)]


@pytest.fixture(scope="module")
def rendezvous(tmp_path_factory):
    """Rank rendezvous directories (tempfile.mkdtemp) under a tmp path."""
    old = tempfile.tempdir
    tempfile.tempdir = str(tmp_path_factory.mktemp("ranks"))
    yield
    tempfile.tempdir = old


@pytest.fixture(scope="module")
def init():
    return weights()


@pytest.fixture(scope="module")
def jobs(init, rendezvous):
    """The training job and a job whose two ranks fail (a batch of 3 rows
    over "data" 2), started before the reference's compiles; killed after
    if still there."""
    started = [train_job(rank_runs(init[1]), device=CPU),
               train_job([{"shape": {"data": 2}, "cfg": _cfgs()[1],
                           "ids": _ids()[:3], "steps": 1, "lr": LR,
                           "seed": 0}], device=CPU)]
    yield started
    for j in started:
        j.close()


@pytest.fixture(scope="module")
def job(jobs):
    return jobs[0]


@pytest.fixture(scope="module")
def port_serving(job, init, rendezvous):
    """The port's engine at each of SERVE, on a thread: per mesh, its
    greedy tokens, its ranks' info and whether every rank exited."""
    out, errors = {}, []

    def run():
        try:
            for shape in SERVE:
                mesh = create_mesh(shape, devices=[CPU] * 2)
                eng = teng.LLMEngine(
                    tllama.LlamaModel(_cfgs()[1], device="meta"), init[1],
                    teng.EngineConfig(**ENGINE), mesh=mesh)
                procs = list(eng.runner._procs)
                try:
                    tokens = greedy(eng, teng)
                finally:
                    eng.close()
                out[str(shape)] = (tokens, eng.runner.info,
                                   all(p.poll() is not None for p in procs))
        except Exception as e:  # read by the tests
            errors.append(e)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    yield thread, out, errors
    thread.join(120)


def greedy(eng, mod):
    """The greedy tokens of REQUESTS, admitted in one wave."""
    for rid, prompt in REQUESTS.items():
        eng.add_request(mod.Request(rid, prompt, max_tokens=MAX_TOKENS))
    got = {}
    while eng.has_work():
        for so in eng.step():
            got.setdefault(so.request_id, []).append(so.token)
    return got


@pytest.fixture(scope="module")
def reference(job, port_serving, init):
    """The reference's sharded step at EP_DP, its engine's greedy tokens
    at each of SERVE, and the port's single-device step, on the same
    weights; the two steps on threads while the engines run here (XLA
    compiles and torch computes outside the GIL)."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        step = pool.submit(_jax_step, init[0])
        single = pool.submit(single_device, init[1])
        tokens = {}
        for shape in SERVE:
            mesh = jcreate_mesh(shape, devices=jax.devices()[:2])
            eng = jeng.LLMEngine(jllama.LlamaModel(_cfgs()[0]), init[0],
                                 jeng.EngineConfig(**ENGINE), mesh=mesh)
            tokens[str(shape)] = greedy(eng, jeng)
        return step.result(), tokens, single.result()


def _jax_step(params):
    """The reference's sharded step at EP_DP on 4 CPU devices
    (tests/test_moe.py's training test, with optax.adamw)."""
    mesh = jcreate_mesh(EP_DP, devices=jax.devices()[:4])
    model = jllama.LlamaModel(_cfgs()[0], mesh=mesh)
    opt = optax.adamw(LR)
    params = jax.device_put(
        params, jllama.LLAMA_SHARDING.tree_shardings(mesh, params))
    state = jstep.TrainState(jnp.zeros((), jnp.int32), params,
                             opt.init(params))
    step = jstep.make_train_step(model, opt, mesh=mesh,
                                 param_rules=jllama.LLAMA_SHARDING,
                                 donate=False)
    ids = jnp.asarray(_ids())
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, ids, ids)
        losses.append(float(loss))
    assert "expert" in str(
        state.params["layers_0"]["mlp"]["gate_kernel"].sharding.spec)
    return losses, convert_params(jax.tree.map(np.asarray, state.params))


def single_device(sd):
    """The port's single-device step from the state dict ``sd``."""
    model = tllama.LlamaModel(_cfgs()[1], device="cpu",
                              param_dtype=torch.float32)
    tllama.load_params(model, sd)
    opt = tstep.adamw(model.parameters(), LR)
    ids = torch.from_numpy(_ids()).long()
    state = tstep.init_train_state(model, opt, ids, device="cpu")
    step = tstep.make_train_step(model, opt)
    losses = [step(state, ids, ids)[1].item() for _ in range(STEPS)]
    return losses, {n: p.detach().numpy()
                    for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def single_step(reference):
    return reference[2]


@pytest.fixture(scope="module")
def ranks(job, reference):
    """Per rank, its result of each run."""
    out = job.results()
    assert not dist.is_initialized()
    return out


def _assert_close(results, losses, params, what):
    for r in results:
        np.testing.assert_allclose(r["losses"], losses, rtol=LOSS_RTOL,
                                   err_msg=f"{what} rank {r['rank']}")
    got = full_params(results)
    assert set(got) == set(params)
    for n in params:
        np.testing.assert_allclose(got[n], params[n], atol=PARAM_ATOL,
                                   rtol=0, err_msg=f"{what} {n}")


@pytest.mark.parametrize("i", range(len(MESHES)),
                         ids=["ep_data", "ep_tensor", "ep_fsdp"])
def test_ep_step_matches_single_device(ranks, single_step, i):
    """3 AdamW steps at each mesh with an "expert" axis: every rank's
    losses and the unsharded weights equal the port's single-device
    step's."""
    _assert_close([r[i] for r in ranks], *single_step, str(MESHES[i]))


def test_ep_data_step_matches_reference_step(ranks, reference):
    """The {"expert": 2, "data": 2} run against the reference's
    make_train_step(mesh=, param_rules=LLAMA_SHARDING) on 4 CPU devices
    (tests/test_moe.py:34-60's mesh shape), on the same init and batch."""
    _assert_close([r[0] for r in ranks], *reference[0], "jax EP")


def test_experts_split_over_expert_axis(ranks):
    """Each rank holds E/2 experts, [0, 2) or [2, 4) by its "expert"
    coordinate, and the expert kernels' specs name "expert" (the analog of
    tests/test_moe.py:55); under "tensor" each expert's "mlp" part, under
    "fsdp" (placed by LLAMA_SHARDING) its "embed_fsdp" part. The router,
    attention and norms are whole."""
    cfg = _cfgs()[1]
    h, inter = cfg.hidden_size, cfg.intermediate_size
    want = {0: {"gate_kernel": ((2, h, inter), ("expert",))},
            1: {"gate_kernel": ((2, h, inter // 2),
                                ("expert", None, "tensor")),
                "down_kernel": ((2, inter // 2, h),
                                ("expert", "tensor"))},
            2: {"gate_kernel": ((2, h // 2, inter), ("expert", "fsdp")),
                "down_kernel": ((2, inter, h // 2),
                                ("expert", None, "fsdp"))}}
    for i, shape in enumerate(MESHES):
        mesh = create_mesh(shape, devices=[CPU] * 4)
        for rank in range(4):
            coord = mesh.coords(rank)["expert"]
            assert ranks[rank][i]["experts"] == (2 * coord, 2 * coord + 2)
            model = tllama.LlamaModel(cfg, device="cpu", mesh=mesh,
                                      rank=rank)
            tllama.place_params(model, tllama.LLAMA_SHARDING)
            params = dict(model.named_parameters())
            for name, (local, spec) in want[i].items():
                full = f"layers.1.mlp.{name}"
                assert tuple(params[full].shape) == local, (shape, full)
                assert model.specs[full] == spec, (shape, full)
                assert ranks[rank][i]["index"][full][0] == slice(
                    2 * coord, 2 * coord + 2)
            assert model.specs["layers.0.mlp.router.weight"] == ()
            assert tuple(params["layers.0.mlp.router.weight"].shape) == (
                EXPERTS, h)


def test_dryrun_ep_part(ranks):
    """The dry run's EP part (__graft_entry__.py:87-101): one step of the
    tiny Llama with 2 experts at {"expert": 2, "data": 2}; the same finite
    loss on every rank, each rank holding one expert."""
    res = [r[len(MESHES)] for r in ranks]
    losses = {r["losses"][0] for r in res}
    assert len(losses) == 1 and np.isfinite(losses.pop())
    assert [r["experts"] for r in res] == [(0, 1), (1, 2)] * 2


@pytest.mark.parametrize("shape", SERVE, ids=["tensor2", "expert2"])
def test_moe_serving_matches_single_device_and_reference(
        shape, port_serving, reference, init):
    """Greedy tokens of the MoE engine over two gloo ranks equal the port's
    on one device and the reference's LLMEngine(mesh=) at the same mesh (0
    differ); the ranks hold their experts and heads, and every rank process
    exits on close()."""
    thread, out, errors = port_serving
    thread.join(120)
    assert not thread.is_alive() and not errors, errors
    one = teng.LLMEngine(tllama.LlamaModel(_cfgs()[1], device="cpu"),
                         init[1], teng.EngineConfig(**ENGINE), device="cpu")
    want = greedy(one, teng)
    tokens, info, exited = out[str(shape)]
    assert all(len(t) == MAX_TOKENS for t in want.values())
    assert tokens == want
    assert tokens == reference[1][str(shape)]
    assert exited and not dist.is_initialized()
    ep = shape.get("expert", 1)
    assert [i["experts"] for i in info] == [
        (r * EXPERTS // ep, (r + 1) * EXPERTS // ep) if ep > 1
        else (0, EXPERTS) for r in range(2)]
    assert [i["heads"] for i in info] == [4 // shape.get("tensor", 1)] * 2


def test_failed_ranks_report_every_traceback(jobs):
    """A job whose ranks fail raises RankError with every rank's
    traceback, and no rank process is left."""
    job = jobs[1]
    procs = list(job._procs)
    with pytest.raises(RankError) as err:
        job.results()
    for r in range(2):
        assert f"rank {r} failed:" in str(err.value)
    assert "does not split" in str(err.value)
    tail = str(err.value).rsplit("order they failed:\n", 1)[1].splitlines()
    assert sorted(line.split(" at ")[0] for line in tail) == [
        "rank 0", "rank 1"]
    assert all(p.poll() is not None for p in procs)
