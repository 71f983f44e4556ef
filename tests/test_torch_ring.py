"""Port parity: ring attention (ray_tpu_torch.parallel.ring, the blockwise
update of ray_tpu_torch.ops.attention) and sequence-parallel training
(train/step.py over a "seq" axis) against ray_tpu's on the 8 virtual CPU
devices (tests/conftest.py).

Tolerances are the JAX tests' own (tests/test_attention.py): outputs
within 2e-5, q/k/v gradients within 5e-4; the train step's are
tests/test_torch_train_sharded.py's (loss 1e-5 relative, weights 1e-4 after
3 AdamW steps), on its init and batch. As there, the weights' limit is
well posed only where no gradient is zero up to f32 rounding: Adam moves a
weight by about lr · g / (|g| + 1e-8). On this init and batch 11 step-1
gradients lie below 1e-7 (the least 1.3e-8) and the weights agree within
2.2e-5 (tests/torch_parity_report.py prints the errors); the port's own
seeded init (init_params, seed 0) puts one weight, whose step-1 gradient
is 1.7e-8 on one device and 2.4e-8 on the ranks, 7.1e-5 apart.

Every rank case runs in one job of four gloo rank processes on the CPU
(parallel/launch.py), started before the reference compiles so the two
overlap: ring attention at {"seq": 4} (causal and full at [2, 256, 4/4,
32], GQA at [1, 512, 8/2, 32]) and 3 steps of the tiny Llama at {"seq": 2,
"tensor": 2} with attention_impl="ring". The pytest worker makes no
process group; every rank process is gone when the job returns."""

import concurrent.futures
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import __graft_entry__
from ray_tpu.models import llama as jllama
from ray_tpu.ops import attention as jattn
from ray_tpu.parallel.mesh import create_mesh as jcreate_mesh
from ray_tpu.parallel.ring import ring_attention as jring_attention
from ray_tpu.train import step as jstep
from ray_tpu_torch.entry import full_params, mesh_shape_for, train_job
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import convert_params
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.train import step as tstep

CPU = torch.device("cpu")
OUT_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-4, rtol=5e-4)
LR = 1e-3
STEPS = 3
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4
RING = {"seq": 4}
SP_TP = {"seq": 2, "tensor": 2}
# (name, causal, (b, s, h, hkv, d), seed)
RING_CASES = [("causal", True, (2, 256, 4, 4, 32), 0),
              ("full", False, (2, 256, 4, 4, 32), 1),
              ("gqa", True, (1, 512, 8, 2, 32), 3)]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads in this worker (each rank process takes its
    share of them), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _qkv(b, s, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))]


def _ids():
    return np.random.default_rng(0).integers(0, 512, (2, 32),
                                             dtype=np.int32)


def _cfg():
    return dataclasses.replace(tllama.LlamaConfig.tiny(),
                               attention_impl="ring")


def weights():
    """The reference's tiny init (tests/test_torch_train_sharded.py's), as
    flax params and converted (models/convert.py)."""
    model = jllama.LlamaModel(jllama.LlamaConfig.tiny())
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.asarray(_ids()))["params"]
    return params, convert_params(jax.tree.map(np.asarray, params))


def rank_runs(sd):
    """The job's runs: each ring case, then the {"seq": 2, "tensor": 2}
    train run from the state dict ``sd``."""
    runs = [{"fn": "ring", "shape": RING, "qkv": _qkv(*dims, seed),
             "causal": causal} for _, causal, dims, seed in RING_CASES]
    runs.append({"shape": SP_TP, "cfg": _cfg(), "ids": _ids(),
                 "steps": STEPS, "lr": LR, "state_dict": sd,
                 "want_params": True})
    return runs


@pytest.fixture(scope="module")
def init():
    return weights()


@pytest.fixture(scope="module")
def job(init, tmp_path_factory):
    """The rank job, started before the reference's compiles, its
    rendezvous directory under a tmp path; killed after if still there."""
    old = tempfile.tempdir
    tempfile.tempdir = str(tmp_path_factory.mktemp("ranks"))
    started = []
    try:
        started.append(train_job(rank_runs(init[1]), device=CPU))
        yield started[0]
    finally:
        for j in started:
            j.close()
        tempfile.tempdir = old


@pytest.fixture(scope="module")
def reference(job, init):
    return reference_runs(init[0])


def reference_runs(params):
    """The reference's ring cases and its sharded step from flax
    ``params``, compiled on two threads (XLA compiles outside the GIL)."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        step = pool.submit(_jax_step, params)
        ring = _jax_ring()
        return ring, step.result()


def _jax_ring():
    """The reference's ring attention at {"seq": 4} on 4 CPU devices: each
    case's output and q/k/v gradients of its sum."""
    mesh = jcreate_mesh(RING, devices=jax.devices()[:4])
    out = {}
    for name, causal, dims, seed in RING_CASES:
        def f(q, k, v, causal=causal):
            o, vjp = jax.vjp(lambda q, k, v: jring_attention(
                q, k, v, mesh=mesh, causal=causal), q, k, v)
            return o, vjp(jnp.ones_like(o))

        o, grads = jax.jit(f)(*map(jnp.asarray, _qkv(*dims, seed)))
        out[name] = [np.asarray(o)] + [np.asarray(g) for g in grads]
    return out


def _jax_step(params):
    """The reference's sharded step at {"seq": 2, "tensor": 2} on 4 CPU
    devices with attention_impl="ring", on the same weights."""
    cfg = dataclasses.replace(jllama.LlamaConfig.tiny(),
                              attention_impl="ring")
    mesh = jcreate_mesh(SP_TP, devices=jax.devices()[:4])
    model = jllama.LlamaModel(cfg, mesh=mesh)
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
    return losses, convert_params(jax.tree.map(np.asarray, state.params))


@pytest.fixture(scope="module")
def single_step(job, init):
    return single_device(init[1])


def single_device(sd):
    """The port's single-device step ("ring" without a mesh is plain
    attention) from the state dict ``sd``."""
    model = tllama.LlamaModel(_cfg(), device="cpu",
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
def ranks(job, reference, single_step):
    """Per rank, its result of each run."""
    out = job.results()
    assert not dist.is_initialized()
    return out


@pytest.mark.parametrize("mask", ["full", "masked"])
def test_block_attention_matches_reference(mask):
    """A ring rank's blocks: block_attn_init, the diagonal block with its
    causal mask, then a block before it (no mask) or after it (fully
    masked: it must leave the stats as they are), and block_attn_finish
    equal the reference's on the same seeded f32 inputs, the running stats
    included (tests/test_torch_attention.py holds unmasked and causal
    pairs)."""
    q, k0, v0 = _qkv(2, 64, 4, 4, 32, 7)
    _, k1, v1 = _qkv(2, 64, 4, 4, 32, 8)
    s = q.shape[1]
    tri = np.where(np.arange(s)[None, :] <= np.arange(s)[:, None], 0.0,
                   -1e30).astype(np.float32)
    second = {"full": None,
              "masked": np.full((s, s), -1e30, np.float32)}[mask]
    scale = 0.17
    got, want = [], []
    for mod, arr in ((tattn, torch.from_numpy), (jattn, jnp.asarray)):
        m, l, o = mod.block_attn_init(arr(q))
        for k, v, msk in ((k0, v0, tri), (k1, v1, second)):
            m, l, o = mod.block_attn_update(
                arr(q), arr(k), arr(v), m, l, o, scale=scale,
                mask=None if msk is None else arr(msk))
        out = mod.block_attn_finish(l, o, arr(q).dtype)
        (got if mod is tattn else want).extend(
            np.asarray(x) for x in (m, l, o, out))
    for name, a, b in zip(("m", "l", "o", "out"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **OUT_TOL)


@pytest.mark.parametrize("case", RING_CASES, ids=[c[0] for c in RING_CASES])
def test_ring_attention_matches_reference(ranks, reference, case):
    """ring_attention on four gloo CPU ranks at {"seq": 4}: each rank's
    output block and q/k/v gradient blocks, put together, equal
    ray_tpu.parallel.ring.ring_attention's and its jax.vjp's."""
    name = case[0]
    want = reference[0][name]
    got = assemble(ranks, [c[0] for c in RING_CASES].index(name), want)
    np.testing.assert_allclose(got[0], want[0], err_msg="out", **OUT_TOL)
    for n, a, b in zip("qkv", got[1:], want[1:]):
        np.testing.assert_allclose(a, b, err_msg=f"d{n}", **GRAD_TOL)


def assemble(ranks, i, like):
    """Run i's out, dq, dk and dv put together from every rank's blocks,
    as arrays shaped as ``like``."""
    got = [np.zeros_like(w) for w in like]
    for per_rank in ranks:
        r = per_rank[i]
        for g, key in zip(got, ("out", "dq", "dk", "dv")):
            g[r["kv_index" if key in ("dk", "dv") else "index"]] = r[key]
    return got


def _assert_close(results, losses, params, what):
    for r in results:
        np.testing.assert_allclose(r["losses"], losses, rtol=LOSS_RTOL,
                                   err_msg=f"{what} rank {r['rank']}")
    got = full_params(results)
    assert set(got) == set(params)
    for n in params:
        np.testing.assert_allclose(got[n], params[n], atol=PARAM_ATOL,
                                   rtol=0, err_msg=f"{what} {n}")


def test_seq_tensor_step_matches_single_device(ranks, single_step):
    """3 AdamW steps at {"seq": 2, "tensor": 2} (ring attention, each rank
    16 of 32 tokens of both rows at 2 of 4 heads): every rank's losses and
    the unsharded weights equal the port's single-device step's."""
    _assert_close([r[-1] for r in ranks], *single_step, "single device")


def test_seq_tensor_step_matches_reference_ring_step(ranks, reference):
    """The same run against the reference's make_train_step(mesh=,
    param_rules=LLAMA_SHARDING) with attention_impl="ring" on 4 CPU
    devices (the analog of tests/test_train_step.py's ring step)."""
    _assert_close([r[-1] for r in ranks], *reference[1], "jax ring")


def test_mesh_shape_for_matches_reference():
    """entry.mesh_shape_for factors 1..8 devices as the reference's
    _mesh_shape_for does: dryrun_multigpu(4) runs {"seq": 2, "tensor":
    2}, with ring attention."""
    for n in range(1, 9):
        assert mesh_shape_for(n) == __graft_entry__._mesh_shape_for(n), n
    assert mesh_shape_for(4) == SP_TP
