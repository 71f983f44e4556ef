"""Port tests for LLMServer, load_model_and_params, entry() and the import
boundary of ray_tpu_torch (no jax, flax or ray_tpu in its module graph)."""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm._internal import engine as jeng
from ray_tpu.models import llama as jllama
from ray_tpu_torch import entry as tentry
from ray_tpu_torch.llm import (
    EngineConfig,
    LLMEngine,
    LLMServer,
    load_model_and_params,
)
from ray_tpu_torch.models import llama as tllama


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads for this module's torch work, restored after:
    the suite runs several pytest workers at once, and torch's default of
    one thread per core in each of them oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"model": "tiny", "model_config": {"vocab_size": 128}, "seed": 0,
        "engine_config": {"max_seqs": 2, "page_size": 4,
                          "max_pages_per_seq": 16, "decode_steps": 2}}


@pytest.fixture(scope="module")
def server():
    srv = LLMServer(TINY, device="cpu")
    yield srv
    srv.shutdown()
    assert not srv._thread.is_alive()


def test_generate_streams_and_matches_unary(server):
    items = list(server.generate([5, 17, 42, 7], max_tokens=6))
    assert len(items) == 6
    assert "ttft_s" in items[0] and "ttft_s" not in items[1]
    unary = server.generate_all([5, 17, 42, 7], max_tokens=6)
    assert unary["tokens"] == [it["token"] for it in items]
    assert unary["ttft_s"] > 0
    assert server.check_health()
    assert server.stats()["running"] == 0


def test_generate_logprobs_and_early_close(server):
    out = server.generate_all([9, 3, 11], max_tokens=3, logprobs=2)
    assert len(out["logprobs"]) == 3
    assert all(len(t) == 2 for t in out["top_logprobs"])
    gen = server.generate([1, 2, 3], max_tokens=40)
    next(gen)
    gen.close()  # aborts the request in the engine
    # the slot comes back: a later request still completes
    assert len(server.generate_all([4, 5], max_tokens=2)["tokens"]) == 2


def test_concurrent_requests_match_engine_alone(server):
    """Requests from several threads, batched by the engine thread, give
    the tokens each gets alone."""
    import threading

    prompts = [[5, 17, 42, 7], [9, 3, 11], [2, 4, 6, 8]]
    alone = [server.generate_all(p, max_tokens=5)["tokens"] for p in prompts]
    res = [None] * 3

    def go(i):
        res[i] = server.generate_all(prompts[i], max_tokens=5)["tokens"]

    threads = [threading.Thread(target=go, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert res == alone


def test_paused_admits_submissions_as_one_wave(server, monkeypatch):
    """Requests submitted while the server is paused reach the engine in
    one admission: the first engine step after the pause finds all of them
    waiting, and each gets the tokens it gets alone."""
    import threading
    import time

    prompts = [[5, 17, 42, 7], [9, 3, 11]]
    alone = [server.generate_all(p, max_tokens=4)["tokens"] for p in prompts]
    waiting_at_step = []
    step = server.engine.step

    def recording_step():
        waiting_at_step.append(len(server.engine.waiting))
        return step()

    monkeypatch.setattr(server.engine, "step", recording_step)
    res = [None] * 2

    def go(i):
        res[i] = server.generate_all(prompts[i], max_tokens=4)["tokens"]

    threads = [threading.Thread(target=go, args=(i,)) for i in range(2)]
    with server.paused():
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30
        while server.stats()["pending"] < 2:
            assert time.monotonic() < deadline
            time.sleep(0.001)
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert res == alone
    assert waiting_at_step[0] == 2


def test_params_path_loads_jax_params(tmp_path):
    """A pickle of the JAX params (numpy) loads through convert.py and
    serves the JAX engine's greedy tokens."""
    jcfg = jllama.LlamaConfig.tiny(vocab_size=128)
    jmodel = jllama.LlamaModel(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(1),
                                   jnp.zeros((1, 8), jnp.int32))["params"]
    path = tmp_path / "params.pkl"
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, jparams), f)
    srv = LLMServer({**TINY, "params_path": str(path)}, device="cpu")
    try:
        got = srv.generate_all([5, 17, 42, 7], max_tokens=6)["tokens"]
    finally:
        srv.shutdown()
    je = jeng.LLMEngine(jmodel, jparams, jeng.EngineConfig(
        **TINY["engine_config"]))
    je.add_request(jeng.Request("r", [5, 17, 42, 7], max_tokens=6))
    want = []
    while je.has_work():
        want += [so.token for so in je.step()]
    assert got == want


def test_load_model_and_params_is_seeded():
    (m1, p1), (m2, p2) = (load_model_and_params(TINY, device="cpu")
                          for _ in range(2))
    assert m1.cfg == tllama.LlamaConfig.tiny(vocab_size=128)
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    _, p3 = load_model_and_params({**TINY, "seed": 1}, device="cpu")
    assert not torch.equal(p1["lm_head.weight"], p3["lm_head.weight"])


def test_entry_forward_runs_on_cpu():
    fn, (params, ids) = tentry.entry(device="cpu")
    out = fn(params, ids)
    assert out.shape == (2, 256, 512) and torch.isfinite(out).all()


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tllama.LlamaConfig.tiny(vocab_size=32)
    model = tllama.LlamaModel(cfg, device="cpu")
    for call in (lambda: LLMServer(TINY),
                 lambda: load_model_and_params(TINY),
                 lambda: LLMEngine(model, None, EngineConfig(
                     max_seqs=1, page_size=4, max_pages_per_seq=4)),
                 lambda: tllama.LlamaModel(cfg),
                 tentry.entry):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_port_imports_no_jax_flax_or_ray_tpu():
    """Importing every ray_tpu_torch module (the training slice's
    ray_tpu_torch.train, ray_tpu_torch.parallel with ring attention, the
    pipeline and expert parallelism, the serving rank process's entry
    module, ray_tpu_torch.rllib with multi-agent PPO and the ResNet among
    them) and chip_smoke.py's imports
    loads no jax, flax, optax or ray_tpu; naming a gymnasium env id in an
    RL config loads no gymnasium either (the card's machine has none)."""
    code = r"""
import importlib, pkgutil, sys
import ray_tpu_torch
for m in pkgutil.walk_packages(ray_tpu_torch.__path__, "ray_tpu_torch."):
    importlib.import_module(m.name)
for m in ("ray_tpu_torch.train.step", "ray_tpu_torch.parallel.mesh",
          "ray_tpu_torch.parallel.sharding", "ray_tpu_torch.parallel.tp",
          "ray_tpu_torch.llm._internal.tp_rank",
          "ray_tpu_torch.parallel.fsdp", "ray_tpu_torch.parallel.launch",
          "ray_tpu_torch.parallel.ring", "ray_tpu_torch.parallel.pipeline",
          "ray_tpu_torch.parallel.ep", "ray_tpu_torch.entry",
          "ray_tpu_torch.rllib", "ray_tpu_torch.rllib.rl_module",
          "ray_tpu_torch.rllib.learner", "ray_tpu_torch.rllib.env_runner",
          "ray_tpu_torch.rllib.vector", "ray_tpu_torch.rllib.ppo",
          "ray_tpu_torch.rllib.impala", "ray_tpu_torch.rllib.appo",
          "ray_tpu_torch.rllib.dqn", "ray_tpu_torch.rllib.sac",
          "ray_tpu_torch.rllib.examples.gridworld",
          "ray_tpu_torch.rllib.examples.pixel_gridworld",
          "ray_tpu_torch.rllib.examples.point_goal",
          "ray_tpu_torch.rllib.multi_agent",
          "ray_tpu_torch.rllib.examples.chase",
          "ray_tpu_torch.models.resnet", "ray_tpu_torch.models.convert",
          "ray_tpu_torch.utils.flax_rules"):
    assert m in sys.modules, m
import chip_smoke
from ray_tpu_torch.rllib import DQNConfig, IMPALAConfig, PPOConfig
for config in (PPOConfig, IMPALAConfig, DQNConfig):
    config().environment("CartPole-v1")
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "ray_tpu", "gymnasium"))
assert not bad, bad
print("clean", len([n for n in sys.modules if n.startswith("ray_tpu_torch")]))
"""
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_port_sources_call_no_library_attention():
    """The port computes attention itself: no SDPA, torch.compile or cuDNN
    attention anywhere in ray_tpu_torch (chip_smoke.py times SDPA only as
    a yardstick)."""
    banned = ("scaled_dot_product_attention", "torch.compile",
              "cudnn_attention", "flash_attn", "import triton")
    for root, _, files in os.walk(os.path.join(REPO, "ray_tpu_torch")):
        for name in files:
            if name.endswith((".py", ".cu")):
                with open(os.path.join(root, name)) as f:
                    text = f.read()
                for b in banned:
                    assert b not in text, (name, b)
