"""Port parity for the serving engine: every case of tests/test_llm_engine.py,
tests/test_llm_prefix_cache.py and tests/test_llm_lora.py, run through the
JAX engine and the port's engine on the same (converted) tiny weights.
Greedy tokens must be EQUAL. Sampled tokens cannot be (JAX's threefry bits
are not reproduced); they are held to the properties
tests/test_llm_openai.py checks: same seed same stream, different seeds
diverge, top-k/top-p keep to their support."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm._internal import engine as jeng
from ray_tpu.models import llama as jllama
from ray_tpu_torch.llm._internal import engine as teng
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import convert_params


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads for this module's torch work, restored after:
    the suite runs several pytest workers at once, and torch's default of
    one thread per core in each of them oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.LlamaConfig.tiny(vocab_size=128)
    jmodel = jllama.LlamaModel(jcfg)
    # jitted: one compile instead of an eager dispatch of every op
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 8), jnp.int32))["params"]
    return jmodel, jparams, convert_params(jax.tree.map(np.asarray, jparams))


def _port_engine(tiny, param_transform=None, **kw):
    _, _, sd = tiny
    model = tllama.LlamaModel(tllama.LlamaConfig.tiny(vocab_size=128),
                              device="cpu")
    return teng.LLMEngine(model, sd, teng.EngineConfig(**kw),
                          param_transform=param_transform, device="cpu")


# Jitted steps of the JAX engine, shared by the engines of one model,
# decode_steps and max_logprobs. Every case gets a fresh JAX engine
# (allocator, prefix cache, slots), but the steps it jits close over
# nothing else than those three; every other field of the config reaches
# them as an argument's shape, which jax.jit keys its compilations on. So
# XLA compiles a step once per module and shape instead of once per case.
_JAX_STEPS = {}


def _jax_engine(tiny, **kw):
    jmodel, jparams, _ = tiny
    cfg = jeng.EngineConfig(**kw)
    eng = jeng.LLMEngine(jmodel, jparams, cfg)
    eng._decode_fns, eng._prefill_fns = _JAX_STEPS.setdefault(
        (id(jmodel), cfg.decode_steps, cfg.max_logprobs), ({}, {}))
    return eng


def _drain(eng, objects=False):
    got, steps = {}, 0
    while eng.has_work() and steps < 500:
        for so in eng.step():
            got.setdefault(so.request_id, []).append(so if objects
                                                     else so.token)
        steps += 1
    return got


def _run_both(tiny, requests, **kw):
    """requests: list of dicts of Request fields, added in order to a fresh
    JAX engine and a fresh port engine. Returns (jax_out, port_out,
    port_engine)."""
    je, te = _jax_engine(tiny, **kw), _port_engine(tiny, **kw)
    for r in requests:
        je.add_request(jeng.Request(**r))
        te.add_request(teng.Request(**r))
    return _drain(je), _drain(te), te


def _oracle(tiny, prompt, n):
    """Greedy continuation by full recompute on the port's model."""
    _, _, sd = tiny
    model = tllama.LlamaModel(tllama.LlamaConfig.tiny(vocab_size=128),
                              device="cpu")
    tllama.load_params(model, sd)
    ids, out = list(prompt), []
    with torch.no_grad():
        for _ in range(n):
            tok = int(model(torch.tensor([ids]))[0, -1].argmax())
            out.append(tok)
            ids.append(tok)
    return out


# --- tests/test_llm_engine.py -----------------------------------------------
def test_single_request_matches_jax_engine(tiny):
    j, t, _ = _run_both(tiny, [dict(request_id="r1", prompt_ids=[5, 17, 42, 7],
                                    max_tokens=8)],
                        max_seqs=2, page_size=4, max_pages_per_seq=16)
    assert t == j
    assert t["r1"] == _oracle(tiny, [5, 17, 42, 7], 8)


def test_continuous_batching_matches_jax_engine(tiny):
    prompts = {"a": [1, 2, 3], "b": [9, 8, 7, 6, 5], "c": [100, 3],
               "d": [11, 22, 33, 44]}
    j, t, _ = _run_both(
        tiny, [dict(request_id=k, prompt_ids=p, max_tokens=6)
               for k, p in prompts.items()],
        max_seqs=2, page_size=4, max_pages_per_seq=16)
    assert t == j
    assert t["d"] == _oracle(tiny, prompts["d"], 6)


def test_page_reuse_across_many_requests(tiny):
    j, t, te = _run_both(
        tiny, [dict(request_id=f"r{i}", prompt_ids=[i + 1, i + 2],
                    max_tokens=5) for i in range(6)],
        max_seqs=2, page_size=4, max_pages_per_seq=4, num_pages=8)
    assert t == j
    assert len(t) == 6 and all(len(v) == 5 for v in t.values())
    assert te.allocator.num_free == te.cache_cfg.num_pages  # all freed


def test_stop_token_and_temperature_paths(tiny):
    expect = _oracle(tiny, [3, 4], 12)
    k = next((i for i in range(1, 12) if expect[i] not in expect[:i]), None)
    reqs = [dict(request_id="t", prompt_ids=[5, 6], max_tokens=4,
                 temperature=0.8)]
    if k is not None:
        reqs.insert(0, dict(request_id="s", prompt_ids=[3, 4], max_tokens=12,
                            stop_token=expect[k]))
    j, t, _ = _run_both(tiny, reqs, max_seqs=2, page_size=4,
                        max_pages_per_seq=8)
    if k is not None:
        assert t["s"] == j["s"] == expect[:k + 1]
    assert len(t["t"]) == len(j["t"]) == 4


# --- tests/test_llm_prefix_cache.py -----------------------------------------
COMMON = [5, 17, 42, 7, 9, 3, 11, 2]  # exactly 2 full pages of 4


def test_prefix_pages_shared_across_requests(tiny):
    kw = dict(max_seqs=2, page_size=4, max_pages_per_seq=16, decode_steps=2)
    je, te = _jax_engine(tiny, **kw), _port_engine(tiny, **kw)
    outs = []
    for eng, mod in ((je, jeng), (te, teng)):
        eng.add_request(mod.Request("a", COMMON + [21, 33], max_tokens=6))
        a = _drain(eng)
        assert len(eng.prefix_cache) == 2
        eng.add_request(mod.Request("b", COMMON + [44], max_tokens=6))
        b = _drain(eng)
        assert eng.prefix_cache.hit_pages >= 2
        outs.append((a, b))
    assert outs[1] == outs[0]


def test_whole_prompt_hit_backs_off_one_page(tiny):
    kw = dict(max_seqs=2, page_size=4, max_pages_per_seq=16, decode_steps=2)
    outs = []
    for eng, mod in ((_jax_engine(tiny, **kw), jeng),
                     (_port_engine(tiny, **kw), teng)):
        eng.add_request(mod.Request("a", COMMON, max_tokens=4))
        a = _drain(eng)["a"]
        eng.add_request(mod.Request("b", COMMON, max_tokens=4))
        b = _drain(eng)["b"]
        assert a == b
        outs.append(a)
    assert outs[1] == outs[0] == _oracle(tiny, COMMON, 4)


def test_prefix_cache_eviction_under_pressure(tiny):
    kw = dict(max_seqs=1, page_size=4, max_pages_per_seq=8, num_pages=10,
              decode_steps=2)
    outs = []
    for eng, mod in ((_jax_engine(tiny, **kw), jeng),
                     (_port_engine(tiny, **kw), teng)):
        got = {}
        for i in range(3):
            eng.add_request(mod.Request(f"warm{i}",
                                        [i * 7 + j for j in range(8)],
                                        max_tokens=2))
            got.update(_drain(eng))
        held = len(eng.prefix_cache)
        assert held >= 3
        eng.add_request(mod.Request("big", list(range(1, 25)), max_tokens=2))
        got.update(_drain(eng))
        assert len(got["big"]) == 2
        assert len(eng.prefix_cache) < held + 25 // 4
        outs.append((got, len(eng.prefix_cache)))
    assert outs[1] == outs[0]


@pytest.mark.parametrize("pipelined", [False, True])
def test_pipelined_dispatch_matches_jax_engine(tiny, pipelined):
    prompts = {"a": [5, 17, 42, 7], "b": [9, 3, 11], "c": [2, 4, 6, 8, 10]}
    j, t, _ = _run_both(
        tiny, [dict(request_id=k, prompt_ids=p, max_tokens=9)
               for k, p in prompts.items()],
        max_seqs=4, page_size=4, max_pages_per_seq=16, decode_steps=2,
        pipeline_dispatch=pipelined, enable_prefix_cache=False)
    assert t == j
    assert t["c"] == _oracle(tiny, prompts["c"], 9)


def test_pipelined_staggered_admission(tiny):
    kw = dict(max_seqs=4, page_size=4, max_pages_per_seq=16, decode_steps=2,
              pipeline_dispatch=True)
    outs = []
    for eng, mod in ((_jax_engine(tiny, **kw), jeng),
                     (_port_engine(tiny, **kw), teng)):
        eng.add_request(mod.Request("a", [5, 17, 42, 7], max_tokens=10))
        got = {}
        for _ in range(3):
            for so in eng.step():
                got.setdefault(so.request_id, []).append(so.token)
        eng.add_request(mod.Request("b", [9, 3, 11], max_tokens=10))
        for k, v in _drain(eng).items():
            got.setdefault(k, []).extend(v)
        outs.append(got)
    assert outs[1] == outs[0]
    assert outs[1]["b"] == _oracle(tiny, [9, 3, 11], 10)


def test_same_wave_sharing_dispatch_order(tiny):
    p0 = [60, 61, 62]
    p1 = COMMON + [21, 33, 44, 55, 66, 77, 88, 99, 13]  # S=17 -> bucket 32
    p2 = COMMON + [44]  # suffix len 1 after a 2-page hit -> bucket 8
    j, t, _ = _run_both(
        tiny, [dict(request_id=f"r{i}", prompt_ids=p, max_tokens=4)
               for i, p in enumerate((p0, p1, p2))],
        max_seqs=4, page_size=4, max_pages_per_seq=16, decode_steps=2,
        prefill_buckets=(8, 32))
    assert t == j
    assert t["r2"] == _oracle(tiny, p2, 4)


def test_same_wave_same_bucket_owner_sharer(tiny):
    j, t, _ = _run_both(
        tiny, [dict(request_id="a", prompt_ids=COMMON + [21], max_tokens=5),
               dict(request_id="b", prompt_ids=COMMON + [44], max_tokens=5)],
        max_seqs=4, page_size=4, max_pages_per_seq=16, decode_steps=2,
        prefill_buckets=(32,))
    assert t == j
    assert t["b"] == _oracle(tiny, COMMON + [44], 5)


# --- tests/test_llm_lora.py -------------------------------------------------
def _adapter(seed, r=4, scale=0.5):
    """q/v adapters for both layers of the tiny config, from numpy."""
    rng = np.random.default_rng(seed)
    h, qd, kvd = 128, 4 * 32, 2 * 32
    adapter = {f"layers_{i}": {
        "q_proj": (0.2 * rng.standard_normal((r, h), dtype=np.float32),
                   0.2 * rng.standard_normal((qd, r), dtype=np.float32)),
        "v_proj": (0.2 * rng.standard_normal((r, h), dtype=np.float32),
                   0.2 * rng.standard_normal((kvd, r), dtype=np.float32)),
    } for i in range(2)}
    return adapter, scale


def test_lora_bank_logits_match_jax_and_merged_weights(tiny):
    jmodel, jparams, sd = tiny
    adapter, scale = _adapter(7)
    ids = np.array([[5, 17, 42, 7, 9]], np.int32)
    kw = dict(max_seqs=2, page_size=4, max_pages_per_seq=16, lora_rank=4,
              enable_prefix_cache=False)
    je, te = _jax_engine(tiny, **kw), _port_engine(tiny, **kw)
    je.load_lora("ad1", adapter, scale=scale)
    te.load_lora("ad1", adapter, scale=scale)
    ref = jax.jit(jmodel.apply)({"params": jparams}, jnp.asarray(ids),
                                lora=je.lora_banks,
                                lora_idx=jnp.asarray([1]))
    with torch.no_grad():
        got = te.model(torch.from_numpy(ids), lora=te.lora_banks,
                       lora_idx=torch.tensor([1]))
        merged = tllama.LlamaModel(te.model.cfg, device="cpu")
        msd = dict(sd)
        for lname, projs in adapter.items():
            i = lname.split("_")[1]
            for proj, (a, b) in projs.items():
                key = f"layers.{i}.self_attn.{proj}.weight"
                msd[key] = sd[key] + scale * (b @ a)  # [out, in]
        tllama.load_params(merged, msd)
        merged_logits = merged(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), merged_logits.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_mixed_batch_lora_and_base(tiny):
    adapter, scale = _adapter(3)
    kw = dict(max_seqs=4, page_size=4, max_pages_per_seq=16, lora_rank=4,
              decode_steps=2, enable_prefix_cache=False)
    p1, p2 = [5, 17, 42, 7], [9, 3, 11, 2, 6]

    def run(make, mod, requests):
        eng = make(tiny, **kw)
        eng.load_lora("ad1", adapter, scale=scale)
        for r in requests:
            eng.add_request(mod.Request(**r))
        return _drain(eng)

    reqs = [dict(request_id="b", prompt_ids=p1, max_tokens=6),
            dict(request_id="l", prompt_ids=p2, max_tokens=6, lora_id="ad1")]
    mixed_j = run(_jax_engine, jeng, reqs)
    mixed_t = run(_port_engine, teng, reqs)
    assert mixed_t == mixed_j
    solo_t = run(_port_engine, teng, reqs[1:])
    base_t = run(_port_engine, teng,
                 [dict(request_id="x", prompt_ids=p2, max_tokens=6)])
    assert mixed_t["l"] == solo_t["l"]
    assert base_t["x"] != solo_t["l"]  # the adapter changes the output


def test_unknown_adapter_raises(tiny):
    eng = _port_engine(tiny, max_seqs=2, page_size=4, max_pages_per_seq=16,
                       lora_rank=4)
    with pytest.raises(KeyError, match="nope"):
        eng.add_request(teng.Request("r", [1, 2, 3], max_tokens=4,
                                     lora_id="nope"))


def test_param_transform_hook(tiny):
    """The engine runs every forward on param_transform(params): an
    identity transform changes nothing, a zeroed lm_head changes the
    tokens (argmax of all-zero logits is token 0)."""
    _, _, sd = tiny
    kw = dict(max_seqs=2, page_size=4, max_pages_per_seq=16, decode_steps=2)
    req = dict(request_id="r", prompt_ids=[5, 17, 42, 7], max_tokens=4)
    outs = []
    for fn in (lambda p: p,
               lambda p: {**p, "lm_head.weight": p["lm_head.weight"] * 0}):
        eng = teng.LLMEngine(
            tllama.LlamaModel(tllama.LlamaConfig.tiny(vocab_size=128),
                              device="cpu"),
            {k: torch.tensor(v) for k, v in sd.items()},
            teng.EngineConfig(**kw), param_transform=fn, device="cpu")
        eng.add_request(teng.Request(**req))
        outs.append(_drain(eng)["r"])
    assert outs[0] == _oracle(tiny, req["prompt_ids"], 4)
    assert outs[1] == [0, 0, 0, 0]


# --- sampling (tests/test_llm_openai.py) ------------------------------------
SAMPLE_KW = dict(max_seqs=2, page_size=4, max_pages_per_seq=16,
                 decode_steps=2)


@pytest.mark.parametrize("trunc", [{"top_p": 1e-6}, {"top_k": 1}])
def test_vanishing_truncation_is_greedy(tiny, trunc):
    j, t, _ = _run_both(tiny, [dict(request_id="r", prompt_ids=[5, 17, 42, 7],
                                    max_tokens=8, temperature=1.0, seed=123,
                                    **trunc)], **SAMPLE_KW)
    assert t["r"] == j["r"] == _oracle(tiny, [5, 17, 42, 7], 8)


def test_seed_reproducibility_and_divergence(tiny):
    runs = []
    for seed in (42, 42, 43):
        eng = _port_engine(tiny, **SAMPLE_KW)
        eng.add_request(teng.Request("r", [9, 3, 11], max_tokens=12,
                                     temperature=5.0, seed=seed))
        runs.append(_drain(eng)["r"])
    assert runs[0] == runs[1], "same seed must reproduce the stream"
    assert runs[0] != runs[2], "different seeds should diverge (temp=5)"


def test_seeded_stream_ignores_batch_mates(tiny):
    """A seeded request's tokens depend on its own seed only, not on a
    sampling neighbour in the batch."""
    solo = _port_engine(tiny, **SAMPLE_KW)
    solo.add_request(teng.Request("r", [9, 3, 11], max_tokens=8,
                                  temperature=2.0, seed=5))
    pair = _port_engine(tiny, **SAMPLE_KW)
    pair.add_request(teng.Request("x", [1, 2], max_tokens=8,
                                  temperature=2.0, seed=9))
    pair.add_request(teng.Request("r", [9, 3, 11], max_tokens=8,
                                  temperature=2.0, seed=5))
    assert _drain(pair)["r"] == _drain(solo)["r"]


def _replay_probs(tiny, prompt, toks):
    """The model's next-token distribution before each emitted token."""
    _, _, sd = tiny
    model = tllama.LlamaModel(tllama.LlamaConfig.tiny(vocab_size=128),
                              device="cpu")
    tllama.load_params(model, sd)
    ids, out = list(prompt), []
    with torch.no_grad():
        for t in toks:
            logits = model(torch.tensor([ids]))[0, -1].double().numpy()
            out.append(logits)
            ids.append(t)
    return out


@pytest.mark.parametrize("top_p,top_k", [(0.6, 0), (1.0, 3)])
def test_truncated_sampling_stays_in_support(tiny, top_p, top_k):
    prompt = [5, 17, 42, 7]
    eng = _port_engine(tiny, **SAMPLE_KW)
    eng.add_request(teng.Request("r", prompt, max_tokens=10, temperature=1.0,
                                 top_p=top_p, top_k=top_k, seed=7))
    toks = _drain(eng)["r"]
    for t, logits in zip(toks, _replay_probs(tiny, prompt, toks)):
        probs = np.exp(logits - logits.max())
        probs /= probs.sum()
        order = np.argsort(-probs)
        if top_k:
            support = set(order[:top_k])
        else:
            cum = np.cumsum(probs[order])
            support = set(order[:int(np.searchsorted(cum, top_p) + 1)])
        assert t in support, (t, sorted(support))


def test_logprobs_match_jax_engine_and_model(tiny):
    kw = dict(SAMPLE_KW)
    req = dict(request_id="r", prompt_ids=[5, 17, 42, 7], max_tokens=6,
               logprobs=3)
    je, te = _jax_engine(tiny, **kw), _port_engine(tiny, **kw)
    je.add_request(jeng.Request(**req))
    te.add_request(teng.Request(**req))
    jo, to = _drain(je, True)["r"], _drain(te, True)["r"]
    assert [s.token for s in to] == [s.token for s in jo]
    replay = _replay_probs(tiny, req["prompt_ids"], [s.token for s in to])
    for sj, st, logits in zip(jo, to, replay):
        assert st.logprob == pytest.approx(sj.logprob, abs=1e-4)
        logp = logits - logits.max()
        logp -= np.log(np.exp(logp).sum())
        assert st.logprob == pytest.approx(logp[st.token], abs=1e-4)
        assert [i for i, _ in st.top_logprobs] == [
            i for i, _ in sj.top_logprobs]
        np.testing.assert_allclose([v for _, v in st.top_logprobs],
                                   [v for _, v in sj.top_logprobs],
                                   atol=1e-4)
        assert st.top_logprobs[0][0] == st.token


def test_request_validation(tiny):
    eng = _port_engine(tiny, **SAMPLE_KW)
    for bad in (dict(top_p=0.0), dict(top_k=-1), dict(logprobs=9),
                dict(max_tokens=100)):
        with pytest.raises(ValueError):
            eng.add_request(teng.Request("r", [1, 2], **{"max_tokens": 4,
                                                         **bad}))
