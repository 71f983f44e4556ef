"""Port parity for int8 weight quantization (models/quant.py): the same
numpy weights through ray_tpu.models.quant and ray_tpu_torch.models.quant.
Quantized int8, scales, dequantized weights, random_quantized_like and
quantized_bytes must be equal BIT FOR BIT after models/convert.py; the int8
engine's greedy tokens must equal the JAX engine's, and the engine's at-use
dequant (one module at a time) must give the logits of the whole-tree
dequant bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm._internal import engine as jeng
from ray_tpu.models import llama as jllama
from ray_tpu.models import quant as jquant
from ray_tpu_torch.llm._internal import engine as teng
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import quant as tquant
from ray_tpu_torch.models.convert import (
    convert_params,
    is_qleaf,
    unconvert_params,
)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads for this module's torch work, restored after
    (several pytest workers share the machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _configs(experts=0, **kw):
    j = dataclasses.replace(jllama.LlamaConfig.tiny(vocab_size=128),
                            num_experts=experts, **kw)
    t = dataclasses.replace(tllama.LlamaConfig.tiny(vocab_size=128),
                            num_experts=experts, **kw)
    return j, t


def _init(jcfg):
    model = jllama.LlamaModel(jcfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    return model, params


def _np(t):
    """A port tensor as numpy, bf16 as its f32 values (exact)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _f32(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def assert_same_tree(port, ref):
    """port: the port's state dict (tensors); ref: a converted reference
    state dict (numpy). Same names, quantized leaves, dtypes and bits."""
    assert set(port) == set(ref)
    for name in ref:
        r, p = ref[name], port[name]
        assert is_qleaf(r) == is_qleaf(p), name
        pairs = ([(p["__q__"], r["__q__"]), (p["s"], r["s"])]
                 if is_qleaf(r) else [(p, r)])
        for pt, rt in pairs:
            assert str(pt.dtype).split(".")[-1] == np.asarray(rt).dtype.name
            assert tuple(pt.shape) == np.shape(rt), name
            np.testing.assert_array_equal(_np(pt), _f32(rt), err_msg=name)


@pytest.fixture(scope="module")
def quantized():
    """Dense and MoE tiny params, quantized by the reference at its test's
    min_size=64, and the port's quantization of the converted weights."""
    out = {}
    for experts in (0, 4):
        jcfg, tcfg = _configs(experts)
        _, params = _init(jcfg)
        np_params = jax.tree.map(np.asarray, params)
        jq = jquant.quantize_tree(params, min_size=64)
        tq = tquant.quantize_tree(convert_params(np_params), tcfg,
                                  min_size=64, device="cpu")
        out[experts] = (jcfg, tcfg, params, jq, tq)
    return out


@pytest.mark.parametrize("experts", [0, 4])
def test_quantize_tree_matches_reference(quantized, experts):
    _, tcfg, _, jq, tq = quantized[experts]
    ref = convert_params(jax.tree.map(np.asarray, jq))
    assert_same_tree(tq, ref)
    # every matrix went to int8, the norms did not; q/k/v's scale is one
    # per head_dim index, the same for every head
    assert all(is_qleaf(v) == name.endswith(("proj.weight", "kernel",
                                              "router.weight", "lm_head."
                                              "weight", "embed_tokens."
                                              "weight"))
               for name, v in tq.items())
    s = tq["layers.0.self_attn.q_proj.weight"]["s"]
    assert s.shape == (tcfg.num_heads * tcfg.head_dim, 1)
    assert torch.equal(s.reshape(tcfg.num_heads, -1),
                       s.reshape(tcfg.num_heads, -1)[:1].expand(
                           tcfg.num_heads, -1))


@pytest.mark.parametrize("experts", [0, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_tree_matches_reference(quantized, experts, dtype):
    _, _, _, jq, tq = quantized[experts]
    ref = convert_params(jax.tree.map(
        np.asarray, jquant.dequantize_tree(jq, getattr(jnp, dtype))))
    assert_same_tree(tquant.dequantize_tree(tq, getattr(torch, dtype)), ref)


@pytest.mark.parametrize("experts", [0, 4])
def test_quantized_bytes_matches_reference(quantized, experts):
    """Equal but for the port's q/k/v scales, stored for every head: one
    [heads * head_dim, 1] where the reference has [1, 1, head_dim]."""
    _, tcfg, _, jq, tq = quantized[experts]
    tiled = sum((v["s"].numel() - tcfg.head_dim) * 2
                for name, v in tq.items()
                if name.endswith(("q_proj.weight", "k_proj.weight",
                                  "v_proj.weight")))
    assert tiled == tcfg.num_layers * (tcfg.num_heads
                                       + 2 * tcfg.num_kv_heads - 3) * 64
    assert tquant.quantized_bytes(tq) == jquant.quantized_bytes(jq) + tiled


@pytest.mark.parametrize("experts", [0, 4])
def test_convert_roundtrip_quantized(quantized, experts):
    jcfg, _, _, jq, _ = quantized[experts]
    ref = jax.tree.map(np.asarray, jq)
    back = unconvert_params(convert_params(ref), jcfg.head_dim)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(ref))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_f32(a), _f32(b))


@pytest.mark.parametrize("min_size", [64, 10_000])
def test_random_quantized_like_matches_reference(min_size):
    """12 layers, so that the leaves' numbering follows jax's sorted
    flatten order (layers_10 before layers_2); min_size 10,000 leaves the
    [128, 2, 32] k/v kernels as bf16 ones."""
    jcfg, tcfg = _configs(num_layers=12)
    jmodel = jllama.LlamaModel(jcfg)
    shape = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    ref = convert_params(jax.tree.map(
        np.asarray, jquant.random_quantized_like(shape, min_size=min_size)))
    port = tquant.random_quantized_like(tcfg, min_size=min_size,
                                        device="cpu")
    assert_same_tree(port, ref)
    assert is_qleaf(port["layers.10.mlp.gate_proj.weight"])
    assert is_qleaf(port["layers.0.self_attn.k_proj.weight"]) == (
        min_size == 64)


def _drain(eng):
    got = {}
    while eng.has_work():
        for so in eng.step():
            got.setdefault(so.request_id, []).append(so)
    return got


REQUESTS = [dict(request_id="a", prompt_ids=[5, 17, 42, 7], max_tokens=6),
            dict(request_id="b", prompt_ids=[1, 2, 3], max_tokens=6),
            dict(request_id="c", prompt_ids=list(range(9, 30)),
                 max_tokens=6, logprobs=3)]
ENGINE_KW = dict(max_seqs=2, page_size=4, max_pages_per_seq=16,
                 decode_steps=1)


def test_int8_engine_matches_jax_engine(quantized):
    """The reference's int8 serving path (param_transform=dequantize_tree,
    bf16 dequant of an f32 model) against the port's, on a meta model: the
    greedy tokens are equal."""
    jcfg, tcfg, _, jq, tq = quantized[0]
    jmodel = jllama.LlamaModel(jcfg)
    je = jeng.LLMEngine(jmodel, jq, jeng.EngineConfig(**ENGINE_KW),
                        param_transform=jquant.dequantize_tree)
    te = teng.LLMEngine(tllama.LlamaModel(tcfg, device="meta"), tq,
                        teng.EngineConfig(**ENGINE_KW),
                        param_transform=tquant.dequantize_tree, device="cpu")
    assert te._weights is not None  # the at-use path
    for r in REQUESTS:
        je.add_request(jeng.Request(**r))
        te.add_request(teng.Request(**r))
    j = {k: [s.token for s in v] for k, v in _drain(je).items()}
    t = {k: [s.token for s in v] for k, v in _drain(te).items()}
    assert t == j
    assert all(len(v) == 6 for v in t.values())


def _dequantize_f32(p):
    return tquant.dequantize_tree(p, torch.float32)


@pytest.mark.parametrize("transform", [tquant.dequantize_tree,
                                       _dequantize_f32])
def test_at_use_dequant_matches_whole_tree(quantized, transform):
    """Logits through WeightsAtUse equal those of functional_call on the
    whole dequantized tree bit for bit, in the cacheless forward and in
    the engine (its logprobs, against the same engine forced onto the
    whole-tree path), for the reference's two transforms (bf16, and f32
    as tests/test_quant.py:50-73 uses it). The engines run a LoRA bank and
    pipelined windows of 2 steps."""
    _, tcfg, _, _, tq = quantized[0]
    model = tllama.LlamaModel(tcfg, device="meta")
    ids = torch.tensor([[5, 17, 42, 7, 99, 3, 0, 127]])
    with torch.no_grad():
        at_use = model(ids, weights=tquant.WeightsAtUse(tq, transform))
        whole = torch.func.functional_call(model, transform(tq), (ids,))
    assert torch.equal(at_use, whole)

    rng = np.random.default_rng(0)
    d = tcfg.num_heads * tcfg.head_dim
    adapter = {f"layers_{i}": {"q_proj": (rng.standard_normal((2, 128)),
                                          rng.standard_normal((d, 2)))}
               for i in range(tcfg.num_layers)}
    outs = []
    for at in (True, False):
        eng = teng.LLMEngine(tllama.LlamaModel(tcfg, device="meta"), tq,
                             teng.EngineConfig(**{**ENGINE_KW,
                                                  "decode_steps": 2,
                                                  "lora_rank": 2}),
                             param_transform=transform, device="cpu")
        eng.load_lora("ad", adapter, scale=0.5)
        if not at:
            eng._weights = None  # functional_call on the whole tree
        for r in REQUESTS:
            eng.add_request(teng.Request(**r, lora_id="ad"
                                         if r["request_id"] == "a" else ""))
        outs.append({k: [(s.token, s.logprob, s.top_logprobs) for s in v]
                     for k, v in _drain(eng).items()})
    assert outs[0] == outs[1]
    assert outs[0]["c"][0][1] is not None


def test_at_use_transform_sees_full_names(quantized):
    """On a quantized tree the transform sees each module's leaves under
    their full names, so one that acts on a leaf by name acts on the same
    weight as on the whole tree: a zeroed lm_head gives all-zero logits."""
    _, tcfg, _, _, tq = quantized[0]

    def zero_head(p):
        return {k: v * 0 if k == "lm_head.weight" else v
                for k, v in tquant.dequantize_tree(p).items()}

    model = tllama.LlamaModel(tcfg, device="meta")
    ids = torch.tensor([[5, 17, 42, 7]])
    with torch.no_grad():
        at_use = model(ids, weights=tquant.WeightsAtUse(tq, zero_head))
        whole = torch.func.functional_call(model, zero_head(tq), (ids,))
    assert torch.equal(at_use, whole)
    assert not at_use.any()


def test_at_use_transform_that_adds_a_leaf_raises(quantized):
    """A transform that is not a map over leaves (here one that adds
    lm_head.weight to every module's sub-tree) raises in the engine
    instead of acting on other weights than on the whole tree."""
    _, tcfg, _, _, tq = quantized[0]
    head = tquant.dequantize_tree({"w": tq["lm_head.weight"]})["w"]
    eng = teng.LLMEngine(tllama.LlamaModel(tcfg, device="meta"), tq,
                         teng.EngineConfig(**ENGINE_KW),
                         param_transform=lambda p: {
                             **tquant.dequantize_tree(p),
                             "lm_head.weight": head * 0},
                         device="cpu")
    eng.add_request(teng.Request(**REQUESTS[0]))
    with pytest.raises(ValueError, match="param_transform on module"):
        _drain(eng)
