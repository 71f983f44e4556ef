"""Port parity for the switch-routed MoE MLP (models/moe.py): the same numpy
weights and inputs through ray_tpu.models.moe and ray_tpu_torch.models.moe
(f32, the JAX tests' 2e-5), a tiny MoE Llama through both models (1e-4),
and the tiny MoE engine (capacity 1.25, so its prefill drops tokens)
through both engines (greedy tokens equal)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm._internal import engine as jeng
from ray_tpu.models import llama as jllama
from ray_tpu.models import moe as jmoe
from ray_tpu_torch.llm._internal import engine as teng
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models.convert import convert_params, unconvert_params

TOL = 2e-5  # tests/test_attention.py:28's output tolerance


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads for this module's torch work, restored after
    (several pytest workers share the machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _layer_pair(b, s, h, inter, e, cf, seed):
    x = np.random.default_rng(seed).standard_normal((b, s, h)).astype(
        np.float32)
    jlayer = jmoe.MoEMlp(h, inter, e, capacity_factor=cf, dtype=jnp.float32)
    params = jlayer.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    np_params = jax.tree.map(np.asarray, params)
    tlayer = tmoe.MoEMlp(h, inter, e, capacity_factor=cf,
                         dtype=torch.float32, device="cpu")
    with torch.no_grad():
        tlayer.router.weight.copy_(torch.tensor(
            np_params["router"]["kernel"].T))
        for k in ("gate_kernel", "up_kernel", "down_kernel"):
            getattr(tlayer, k).copy_(torch.tensor(np_params[k]))
    return x, jlayer, params, np_params, tlayer


def _dropped(x, np_params, cap):
    """Tokens past their expert's capacity, routed as the reference routes
    (numpy)."""
    idx = np.argmax(x @ np_params["router"]["kernel"], axis=-1)  # [B,S]
    n = 0
    for row in idx:
        n += sum(max(0, int((row == k).sum()) - cap)
                 for k in range(np_params["router"]["kernel"].shape[1]))
    return n


@pytest.mark.parametrize("cf,drops,tie", [(4.0, False, False),
                                          (0.25, True, False),
                                          (4.0, False, True)])
def test_moe_mlp_matches_jax(cf, drops, tie):
    """Ample capacity (cf = E, nothing dropped), cf 0.25 (C = 2 of 32 tokens
    an expert: most tokens dropped), and a zero router: every expert ties,
    and argmax must pick the first, as jnp.argmax does."""
    b, s, h, inter, e = 2, 32, 32, 64, 4
    x, jlayer, params, np_params, tlayer = _layer_pair(b, s, h, inter, e,
                                                       cf, 0)
    if tie:
        params = {**params, "router": {"kernel": jnp.zeros((h, e))}}
        np_params = jax.tree.map(np.asarray, params)
        with torch.no_grad():
            tlayer.router.weight.zero_()
    ref = np.asarray(jlayer.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tlayer(torch.from_numpy(x)).numpy()
    cap = tlayer.capacity(s)
    assert cap == max(1, int(cf * s / e))
    assert (_dropped(x, np_params, cap) > 0) == drops
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    if drops:  # a dropped token's MLP output is exactly zero on both sides
        zero = np.all(ref == 0, axis=-1)
        assert zero.any() and np.array_equal(zero, np.all(got == 0, axis=-1))


def test_moe_reference_matches_jax():
    b, s, h, inter, e = 2, 16, 32, 64, 4
    x, _, params, np_params, _ = _layer_pair(b, s, h, inter, e, float(e), 1)
    ref = jmoe.moe_reference(jnp.asarray(x), params, e)
    got = tmoe.moe_reference(torch.from_numpy(x), np_params, e).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


def _configs():
    j = dataclasses.replace(jllama.LlamaConfig.tiny(vocab_size=128),
                            num_experts=4)
    t = dataclasses.replace(tllama.LlamaConfig.tiny(vocab_size=128),
                            num_experts=4)
    return j, t


@pytest.fixture(scope="module")
def tiny_moe():
    jcfg, tcfg = _configs()
    jmodel = jllama.LlamaModel(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 8), jnp.int32))["params"]
    return jcfg, tcfg, jmodel, jparams, convert_params(
        jax.tree.map(np.asarray, jparams))


def test_moe_llama_logits_match_jax(tiny_moe):
    """num_experts > 0 builds MoEMlp (it raised before the port had it);
    logits within 1e-4 (ROADMAP rule 4) at the default capacity 1.25."""
    jcfg, tcfg, jmodel, jparams, sd = tiny_moe
    ids = np.random.default_rng(0).integers(0, 128, (2, 24)).astype(np.int32)
    ref = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(ids)))
    model = tllama.LlamaModel(tcfg, device="cpu")
    assert isinstance(model.layers[0].mlp, tmoe.MoEMlp)
    tllama.load_params(model, sd)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_convert_roundtrip_moe(tiny_moe):
    jcfg, tcfg, _, jparams, sd = tiny_moe
    model = tllama.LlamaModel(tcfg, device="meta")
    shapes = {k: tuple(v.shape) for k, v in model.named_parameters()}
    assert {k: v.shape for k, v in sd.items()} == shapes
    assert shapes["layers.0.mlp.router.weight"] == (4, 128)
    assert shapes["layers.1.mlp.down_kernel"] == (4, 256, 128)
    ref = jax.tree.map(np.asarray, jparams)
    back = unconvert_params(sd, jcfg.head_dim)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(ref))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)


def test_moe_engine_matches_jax_engine(tiny_moe):
    """Greedy tokens of the tiny MoE engine equal the JAX engine's, and
    their logprobs agree to the model's 1e-4. The 26-token prompt pads to
    the 32 bucket (C = int(1.25 * 32 / 4) = 10), and more than 10 of its
    tokens go to one expert in some layer: its prefill drops tokens, and
    the port must drop the same ones."""
    jcfg, tcfg, jmodel, jparams, sd = tiny_moe
    kw = dict(max_seqs=2, page_size=4, max_pages_per_seq=16, decode_steps=1)
    requests = [dict(request_id="a", prompt_ids=list(range(40, 66)),
                     max_tokens=6, logprobs=1),
                dict(request_id="b", prompt_ids=[5, 17, 42, 7],
                     max_tokens=6, logprobs=1)]
    je = jeng.LLMEngine(jmodel, jparams, jeng.EngineConfig(**kw))
    model = tllama.LlamaModel(tcfg, device="cpu")
    te = teng.LLMEngine(model, sd, teng.EngineConfig(**kw), device="cpu")
    drops = []

    def count_drops(mlp, args, _out):
        x = args[0]
        if x.shape[1] == 32:  # the prefill; row 0 is "a", admitted first
            with torch.no_grad():
                idx = mlp.router(x[0, :26].float()).argmax(-1)
            counts = torch.stack([(idx == k).sum() for k in range(4)])
            drops.append(int((counts - mlp.capacity(32)).clamp_min(0).sum()))

    for layer in model.layers:
        layer.mlp.register_forward_hook(count_drops)
    for r in requests:
        je.add_request(jeng.Request(**r))
        te.add_request(teng.Request(**r))
    got, ref = _drain(te), _drain(je)
    assert ({k: [s.token for s in v] for k, v in got.items()}
            == {k: [s.token for s in v] for k, v in ref.items()})
    assert all(len(v) == 6 for v in got.values())
    for k in ref:
        np.testing.assert_allclose([s.logprob for s in got[k]],
                                   [s.logprob for s in ref[k]], atol=1e-4,
                                   rtol=1e-4)
    assert sum(drops) > 0


def _drain(eng):
    got = {}
    while eng.has_work():
        for so in eng.step():
            got.setdefault(so.request_id, []).append(so)
    return got
