"""Port parity: pipeline_apply (ray_tpu_torch.parallel.pipeline) against
ray_tpu.parallel.pipeline.pipeline_apply on the 8 virtual CPU devices
(tests/conftest.py), the analogs of tests/test_pipeline.py's two cases, each
at 2 and 4 stages.

The stage function is that file's tanh(x @ w + b); its seeded numpy inputs
go to both packages. Every case runs in one job of four gloo rank
processes on the CPU (parallel/launch.py), the mesh {"stage": 2, "data": 2}
or {"stage": 4}, started before the reference compiles. Each rank returns
the whole output and the gradients of its sum: its own stage's slice of ws
and bs and, on stage 0, xs's. They are held within 1e-5 to the reference's
output and jax.grad, and to the sequential composition's autograd in this
process: a gradient scaled by S (the replicated output's cotangent summed
over the stages) fails both."""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from ray_tpu.parallel.mesh import create_mesh as jcreate_mesh
from ray_tpu.parallel.pipeline import pipeline_apply as jpipeline_apply
from ray_tpu_torch.entry import tanh_stage, train_job

CPU = torch.device("cpu")
TOL = dict(atol=1e-5, rtol=1e-5)
# tests/test_pipeline.py's cases: (name, M, mb, h, seed, bias scale)
CASES = [("sequential", 8, 2, 16, 0, 0.1), ("grad", 4, 2, 8, 1, 0.0)]
STAGES = (2, 4)
RUNS = [(c, S) for c in CASES for S in STAGES]
IDS = [f"{c[0]}-S{S}" for c, S in RUNS]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads in this worker (each rank process takes its
    share of them), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(case, S):
    """(ws [S, h, h], bs [S, h], xs [M, mb, h]) as test_pipeline.py draws
    them."""
    _, M, mb, h, seed, b_scale = case
    rng = np.random.default_rng(seed)
    ws = (rng.standard_normal((S, h, h)) * 0.3).astype(np.float32)
    bs = (rng.standard_normal((S, h)) * b_scale).astype(np.float32)
    xs = rng.standard_normal((M, mb, h)).astype(np.float32)
    return ws, bs, xs


def _mesh(S):
    return {"stage": S} if S == 4 else {"stage": S, "data": 4 // S}


def rank_runs():
    return [{"fn": "pipeline", "shape": _mesh(S), "inputs": _inputs(c, S)}
            for c, S in RUNS]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The rank job, its rendezvous directory under a tmp path; killed
    after if still there."""
    old = tempfile.tempdir
    tempfile.tempdir = str(tmp_path_factory.mktemp("ranks"))
    started = []
    try:
        started.append(train_job(rank_runs(), device=CPU))
        yield started[0]
    finally:
        for j in started:
            j.close()
        tempfile.tempdir = old


@pytest.fixture(scope="module")
def reference(job):
    return reference_runs()


def reference_runs():
    """Per run: the reference's output and jax.grad of its sum over
    (ws, bs, xs), on {"stage": S, "data": 8 // S}."""
    def stage_fn(p, x):
        w, b = p
        return jnp.tanh(x @ w + b)

    out = []
    for case, S in RUNS:
        mesh = jcreate_mesh({"stage": S, "data": 8 // S})

        def f(ws, bs, xs, mesh=mesh):
            y, vjp = jax.vjp(lambda ws, bs, xs: jpipeline_apply(
                stage_fn, (ws, bs), xs, mesh=mesh), ws, bs, xs)
            return y, vjp(jnp.ones_like(y))

        y, grads = jax.jit(f)(*map(jnp.asarray, _inputs(case, S)))
        out.append([np.asarray(y)] + [np.asarray(g) for g in grads])
    return out


@pytest.fixture(scope="module")
def ranks(job, reference):
    """Per rank, its result of each run."""
    out = job.results()
    assert not dist.is_initialized()
    return out


def sequential(case, S):
    """The sequential composition of the S stages in this process: its
    output and the gradients of its sum over (ws, bs, xs)."""
    ws, bs, xs = [torch.from_numpy(a).requires_grad_()
                  for a in _inputs(case, S)]
    y = xs
    for s in range(S):
        y = tanh_stage((ws[s], bs[s]), y)
    y.sum().backward()
    return [y.detach().numpy()] + [t.grad.numpy() for t in (ws, bs, xs)]


@pytest.mark.parametrize("run", range(len(RUNS)), ids=IDS)
def test_pipeline_matches_reference(ranks, reference, run):
    """Every rank's output equals the reference's pipeline_apply and the
    sequential composition."""
    want = reference[run][0]
    seq = sequential(*RUNS[run])[0]
    np.testing.assert_allclose(seq, want, **TOL)
    for per_rank in ranks:
        np.testing.assert_allclose(per_rank[run]["out"], want,
                                   err_msg=f"rank {per_rank[run]['rank']}",
                                   **TOL)


@pytest.mark.parametrize("run", range(len(RUNS)), ids=IDS)
def test_pipeline_grads_match_reference(ranks, reference, run):
    """Each stage's ws and bs gradients, and stage 0's xs gradient, equal
    the reference's jax.grad and the sequential composition's (not S times
    it)."""
    _, dws, dbs, dxs = reference[run]
    seq = sequential(*RUNS[run])
    for want in (seq[1:], (dws, dbs, dxs)):
        for per_rank in ranks:
            r = per_rank[run]
            what = f"rank {r['rank']} stage {r['stage']}"
            np.testing.assert_allclose(r["dw"], want[0][r["stage"]],
                                       err_msg=f"{what} dw", **TOL)
            np.testing.assert_allclose(r["db"], want[1][r["stage"]],
                                       err_msg=f"{what} db", **TOL)
            if r["stage"] == 0:
                np.testing.assert_allclose(r["dx"], want[2],
                                           err_msg=f"{what} dx", **TOL)
    assert np.abs(dws).max() > 0
