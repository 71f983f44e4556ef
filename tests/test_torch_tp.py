"""Tensor-parallel serving on the CPU: the port's LLMServer at
tensor_parallel_size 2 and 4 runs gloo rank processes (llm/_internal/tp.py)
and decodes the same greedy tokens as the port at TP 1 and as the
reference's LLMServer at TP 4 (tests/test_llm_openai.py:142), on weights
carried across with params_path; its forward's logits are within 1e-4 of
TP 1's. A rank killed mid-wave makes the server raise within a stated
deadline, and close() leaves no rank process and no process group.

Hygiene: each rank process rendezvouses through a FileStore in a
temporary directory under tmp_path (no fixed port); the pytest worker
makes no process group, starts no runtime and leaves no thread or process
behind."""

import os
import pickle
import signal
import tempfile
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from ray_tpu.llm._internal.server import LLMServer as JaxServer
from ray_tpu.models import llama as jllama
from ray_tpu_torch.llm import LLMServer


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads in this worker (each rank process takes its
    share of them), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _rendezvous_under_tmp_path(tmp_path, monkeypatch):
    """The runner's rendezvous directory (tempfile.mkdtemp) under tmp_path;
    the test asserts it is gone after close()."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


TINY = {"model": "tiny", "model_config": {"vocab_size": 128},
        "engine_config": {"max_seqs": 2, "page_size": 4,
                          "max_pages_per_seq": 16, "decode_steps": 2}}
PROMPTS = [[5, 17, 42], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], [100, 3]]
# Two requests admitted as one wave: batched prefill and decode.
WAVE = [[9, 8, 7, 6, 5], [11, 22, 33, 44, 55, 66]]
MAX_TOKENS = 6
# A killed rank must surface as an error within this (the runner polls its
# ranks every 50 ms while it waits on them).
DEAD_RANK_DEADLINE_S = 30.0


# The cacheless forward's ids for the logits check.
IDS = torch.tensor([[5, 17, 42, 7, 99, 3, 0, 127, 64, 1],
                    [1, 2, 3, 4, 99, 3, 0, 127, 64, 1]])


def write_params(path):
    """The reference's tiny params (seed 1), pickled as numpy."""
    jcfg = jllama.LlamaConfig.tiny(vocab_size=128)
    params = jax.jit(jllama.LlamaModel(jcfg).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"]
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)
    return str(path)


@pytest.fixture(scope="module")
def params_path(tmp_path_factory):
    return write_params(tmp_path_factory.mktemp("tp") / "params.pkl")


def _serve(server):
    """Greedy tokens of PROMPTS one at a time, then of WAVE admitted at
    once (the reference server has no paused(): its wave is submitted from
    two threads and may be admitted in two)."""
    out = [server.generate_all(p, max_tokens=MAX_TOKENS)["tokens"]
           for p in PROMPTS]
    res = [None] * len(WAVE)

    def go(i):
        res[i] = server.generate_all(WAVE[i], max_tokens=MAX_TOKENS)["tokens"]

    threads = [threading.Thread(target=go, args=(i,), daemon=True)
               for i in range(len(WAVE))]
    if not hasattr(server, "paused"):
        for t in threads:
            t.start()
    else:
        with server.paused():
            for t in threads:
                t.start()
            deadline = time.monotonic() + 60
            while server.stats()["pending"] < len(WAVE):
                assert time.monotonic() < deadline
                time.sleep(0.001)
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    return out + res


@pytest.fixture(scope="module")
def tp1(params_path):
    """The port at TP 1: its tokens and its model (the logits' oracle)."""
    srv = LLMServer(dict(TINY, params_path=params_path), device="cpu")
    try:
        return _serve(srv), srv.model
    finally:
        srv.close()


@pytest.fixture(scope="module")
def reference_tp4(params_path):
    """The reference's LLMServer at tensor_parallel_size=4 over four of the
    virtual CPU devices (called directly: no runtime)."""
    srv = JaxServer(dict(TINY, params_path=params_path,
                         tensor_parallel_size=4))
    try:
        return _serve(srv)
    finally:
        srv._running = False  # the reference server has no shutdown


def _children_gone(procs):
    return all(p.poll() is not None for p in procs)


def _assert_clean(server, procs, rendezvous):
    assert procs and _children_gone(procs)
    assert not dist.is_initialized()
    assert not os.path.exists(rendezvous)
    assert not server._thread.is_alive()
    assert all(t.daemon for t in threading.enumerate()
               if t is not threading.main_thread())


@pytest.mark.parametrize("n", [2, 4])
def test_tp_engine_matches_single_device(n, params_path, tp1,
                                         reference_tp4):
    """TP 2 and TP 4 greedy tokens equal TP 1's and the reference's TP 4
    tokens (0 differ); the TP forward's logits are within 1e-4 of TP 1's;
    close() stops the ranks and destroys their groups."""
    tokens_1, model_1 = tp1
    assert tokens_1 == reference_tp4
    assert not dist.is_initialized()
    srv = LLMServer(dict(TINY, params_path=params_path,
                         tensor_parallel_size=n), device="cpu")
    runner = srv.engine.runner
    procs, rendezvous = list(runner._procs), runner._dir
    try:
        # TP 4 does not divide the 2 kv heads: each rank holds both.
        assert [i["kv_heads"] for i in runner.info] == [{2: 1, 4: 2}[n]] * n
        assert [i["heads"] for i in runner.info] == [4 // n] * n
        got = _serve(srv)
        logits = runner.forward(IDS)
        with torch.no_grad():
            want = model_1(IDS)
    finally:
        srv.close()
    assert got == tokens_1
    assert sum(a != b for x, y in zip(got, tokens_1)
               for a, b in zip(x, y)) == 0
    assert logits.shape == want.shape
    assert (logits - want).abs().max().item() <= 1e-4
    _assert_clean(srv, procs, rendezvous)


def test_dead_rank_raises_within_deadline(params_path):
    """SIGKILL rank 1 after the first token of a long request: the request
    raises within DEAD_RANK_DEADLINE_S, later requests raise at once, and
    close() leaves no rank process."""
    cfg = dict(TINY, params_path=params_path, tensor_parallel_size=2,
               engine_config={**TINY["engine_config"],
                              "max_pages_per_seq": 64})
    srv = LLMServer(cfg, device="cpu")
    runner = srv.engine.runner
    procs, rendezvous = list(runner._procs), runner._dir
    try:
        gen = srv.generate([5, 17, 42], max_tokens=200)
        next(gen)
        t = time.monotonic()
        os.kill(procs[1].pid, signal.SIGKILL)
        with pytest.raises(RuntimeError, match="rank"):
            for _ in gen:
                pass
        waited = time.monotonic() - t
        assert waited < DEAD_RANK_DEADLINE_S
        with pytest.raises(RuntimeError, match="engine failed"):
            srv.generate_all([1, 2], max_tokens=2)
    finally:
        srv.close()
    _assert_clean(srv, procs, rendezvous)
