"""Port parity: ray_tpu_torch.models.llama against the flax Llama
(ray_tpu/models/llama.py) on weights converted by models/convert.py.

Logits are held to 1e-4, not the 2e-5 of a single attention call: the
error of f32 sums taken in another order grows through two layers, the
norms and a 128-way lm_head product (measured ~3e-6 on these inputs)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu_torch.llm._internal import paged as tpaged
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import convert_params, unconvert_params
from ray_tpu_torch.parallel.mesh import create_mesh


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads for this module's torch work, restored after:
    the suite runs several pytest workers at once, and torch's default of
    one thread per core in each of them oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.LlamaConfig.tiny(vocab_size=128)
    # jitted: one compile instead of an eager dispatch of every op
    jparams = jax.jit(jllama.LlamaModel(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, convert_params(np_params)


def _models(tiny, impl="reference"):
    jcfg, jparams, sd = tiny
    jcfg = dataclasses.replace(jcfg, attention_impl=impl)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(vocab_size=128),
                               attention_impl=impl)
    tm = tllama.LlamaModel(tcfg, device="cpu")
    tllama.load_params(tm, sd)
    # jitted: one compile per input shape instead of an eager dispatch of
    # every op
    return jax.jit(jllama.LlamaModel(jcfg).apply), jparams, tm


def test_convert_round_trips(tiny):
    jcfg, jparams, sd = tiny
    back = unconvert_params(sd, jcfg.head_dim)
    flat_a = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jparams))[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, arr in flat_a:
        np.testing.assert_array_equal(flat_b[path], arr)
    again = convert_params(back)
    assert sd.keys() == again.keys()
    for k in sd:
        np.testing.assert_array_equal(sd[k], again[k])


def test_state_dict_names_and_count_match(tiny):
    jcfg, jparams, sd = tiny
    tm = tllama.LlamaModel(tllama.LlamaConfig.tiny(vocab_size=128),
                           device="cpu")
    shapes = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert shapes == {k: v.shape for k, v in sd.items()}
    assert tllama.count_params(tm) == jllama.count_params(jparams)
    assert tllama.count_params(sd) == jllama.count_params(jparams)


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_forward_logits_match_jax(tiny, impl):
    """Cacheless forward: the reference path, and the flash path (the
    Pallas kernel in interpret mode against the port's plain flash)."""
    japply, jparams, tm = _models(tiny, impl)
    ids = np.random.default_rng(0).integers(0, 128, (2, 24), dtype=np.int32)
    ref = japply({"params": jparams}, jnp.asarray(ids))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LOGIT_TOL)


def test_kv_cache_decode_logits_match_jax(tiny):
    japply, jparams, tm = _models(tiny)
    cfg = tm.cfg
    ids = np.array([[5, 17, 42, 7, 9]], np.int32)
    jcaches = jllama.init_kv_caches(tiny[0], 1, 16)
    tcaches = tllama.init_kv_caches(cfg, 1, 16, device="cpu")
    jl, jcaches = japply({"params": jparams}, jnp.asarray(ids),
                           kv_caches=jcaches, cache_index=0)
    with torch.no_grad():
        tl, tcaches = tm(torch.from_numpy(ids), kv_caches=tcaches,
                         cache_index=0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        nxt = np.array([[3]], np.int32)
        jl, _ = japply({"params": jparams}, jnp.asarray(nxt),
                         kv_caches=jcaches, cache_index=5)
        tl, _ = tm(torch.from_numpy(nxt), kv_caches=tcaches, cache_index=5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_paged_prefill_and_decode_logits_match_jax(tiny):
    """Batched prefill with padded lanes into the paged cache, then one
    decode step with an inactive slot: logits and pages agree."""
    japply, jparams, tm = _models(tiny)
    cfg = tm.cfg
    pcfg = tpaged.PagedCacheConfig(num_pages=9, page_size=4, max_seqs=2,
                                   max_pages_per_seq=4)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 128, (2, 8), dtype=np.int32)
    true_lens = np.array([8, 5], np.int32)
    page_table = np.array([[3, 7, 1, 0], [2, 5, 8, 0]], np.int32)
    positions = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8))
    mask = np.arange(8)[None, :] < true_lens[:, None]
    from ray_tpu.llm._internal import paged as jpaged

    jcache = jpaged.init_paged_cache(pcfg, cfg.num_layers, cfg.num_kv_heads,
                                     cfg.head_dim, jnp.float32)
    tcache = tpaged.init_paged_cache(pcfg, cfg.num_layers, cfg.num_kv_heads,
                                     cfg.head_dim, torch.float32, "cpu")
    jargs = dict(positions=jnp.asarray(positions), paged_kv=jcache,
                 page_table=jnp.asarray(page_table),
                 write_mask=jnp.asarray(mask),
                 seq_lens=jnp.asarray(true_lens))
    jl, jcache = japply({"params": jparams}, jnp.asarray(ids), **jargs)
    t = torch.from_numpy
    with torch.no_grad():
        tl, tcache = tm(t(ids), positions=t(positions.copy()),
                        paged_kv=tcache, page_table=t(page_table),
                        write_mask=t(mask), seq_lens=t(true_lens))
        for row in range(2):
            n = true_lens[row]
            np.testing.assert_allclose(tl[row, :n].numpy(),
                                       np.asarray(jl)[row, :n], **LOGIT_TOL)
        # decode: slot 0 active at position 8, slot 1 inactive
        last = np.array([[4], [9]], np.int32)
        dpos = true_lens[:, None].copy()
        active = np.array([[True], [False]])
        jl, jcache = japply(
            {"params": jparams}, jnp.asarray(last), positions=jnp.asarray(dpos),
            paged_kv=jcache, page_table=jnp.asarray(page_table),
            write_mask=jnp.asarray(active), seq_lens=jnp.asarray(true_lens + 1))
        tl, tcache = tm(t(last), positions=t(dpos), paged_kv=tcache,
                        page_table=t(page_table), write_mask=t(active),
                        seq_lens=t(true_lens + 1))
    np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl)[0], **LOGIT_TOL)
    for (jk, jv), (tk, tv) in zip(jcache, tcache):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


@pytest.mark.parametrize("positions", [
    np.arange(6, dtype=np.int32),
    np.array([[0, 1, 2, 3, 4, 5], [7, 8, 9, 10, 11, 12]], np.int32),
    np.array([[4000, 4001, 4002, 8000, 8001, 8191]] * 2, np.int32),
])
def test_apply_rope_matches_jax(positions):
    x = np.random.default_rng(2).standard_normal((2, 6, 4, 32),
                                                 dtype=np.float32)
    ref = jllama.apply_rope(jnp.asarray(x), jnp.asarray(positions), 500_000.0)
    got = tllama.apply_rope(torch.from_numpy(x), torch.from_numpy(positions),
                            500_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_rope_rotates_split_halves():
    """Position 1 rotates (x[i], x[i + D/2]) by freq_i, not adjacent pairs."""
    x = torch.zeros(1, 1, 1, 4)
    x[..., 0] = 1.0
    out = tllama.apply_rope(x, torch.tensor([1]), 10_000.0)
    np.testing.assert_allclose(out[0, 0, 0].numpy(),
                               [np.cos(1.0), 0.0, np.sin(1.0), 0.0],
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jllama.RMSNorm(1e-5, jdt).apply(
        {"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x).astype(jdt))
    norm = tllama.RMSNorm(64, 1e-5, tdt)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        got = norm(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and norm.weight.dtype == torch.float32
    tol = 2e-5 if dtype == "float32" else 1e-2  # one bf16 ulp at |x| < 2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("per_slot_scale", [False, True])
def test_lora_delta_matches_jax(per_slot_scale):
    rng = np.random.default_rng(4)
    K, r, din, dout = 3, 4, 16, 8
    a = rng.normal(size=(K, r, din)).astype(np.float32)
    b = rng.normal(size=(K, dout, r)).astype(np.float32)
    scale = (np.array([1.0, 0.5, 2.0], np.float32) if per_slot_scale
             else 0.7)
    x = rng.normal(size=(2, 5, din)).astype(np.float32)
    idx = np.array([2, 0], np.int32)
    jbank = {"a": jnp.asarray(a), "b": jnp.asarray(b),
             "scale": jnp.asarray(scale) if per_slot_scale else scale}
    tbank = {"a": torch.from_numpy(a), "b": torch.from_numpy(b),
             "scale": torch.from_numpy(scale) if per_slot_scale else scale}
    ref = jllama.lora_delta(jnp.asarray(x), jbank, jnp.asarray(idx))
    got = tllama.lora_delta(torch.from_numpy(x), tbank,
                            torch.from_numpy(idx).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("preset", ["llama3_8b", "llama3_70b", "tiny"])
def test_config_presets_match_jax(preset):
    j = getattr(jllama.LlamaConfig, preset)()
    t = getattr(tllama.LlamaConfig, preset)()
    for f in dataclasses.fields(j):
        if f.name == "dtype":
            assert str(t.dtype).split(".")[-1] == jnp.dtype(j.dtype).name
        else:
            assert getattr(t, f.name) == getattr(j, f.name), f.name


def test_unported_branches_raise(tiny):
    """attention_impl="ring" without a "seq" axis is plain attention, as in
    the reference (ray_tpu/models/llama.py:207-214): the same logits as
    the reference's ring model without a mesh, and as the port's
    "reference" path exactly. A mesh with a "seq" axis above 1 is taken by
    the ring model (ring attention) and refused with another impl, and a
    KV cache over it raises, and so do MoE layers over it; an "expert"
    axis above 1 splits an MoE model's experts (expert parallelism)."""
    japply, jparams, ring = _models(tiny, "ring")
    _, _, plain = _models(tiny, "reference")
    ids = np.random.default_rng(5).integers(0, 128, (2, 12), dtype=np.int32)
    ref = japply({"params": jparams}, jnp.asarray(ids))
    with torch.no_grad():
        got = ring(torch.from_numpy(ids))
        want = plain(torch.from_numpy(ids))
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LOGIT_TOL)
    mesh = create_mesh({"seq": 2}, devices=[torch.device("cpu")] * 2)
    sp = tllama.LlamaModel(ring.cfg, device="cpu", mesh=mesh, rank=1)
    assert sp.layers[0].self_attn.ring == (mesh, 1)
    with pytest.raises(NotImplementedError, match="KV cache"):
        sp(torch.zeros((1, 4), dtype=torch.long),
           kv_caches=tllama.init_kv_caches(ring.cfg, 1, 8, device="cpu"),
           cache_index=0)
    with pytest.raises(NotImplementedError, match="attention_impl"):
        tllama.LlamaModel(plain.cfg, device="meta", mesh=mesh, rank=0)
    moe = dataclasses.replace(ring.cfg, num_experts=2)
    with pytest.raises(NotImplementedError, match="MoE layers over"):
        tllama.LlamaModel(moe, device="meta", mesh=mesh, rank=0)
    expert = create_mesh({"expert": 2}, devices=[torch.device("cpu")] * 2)
    ep = tllama.LlamaModel(moe, device="meta", mesh=expert, rank=1)
    assert ep.layers[0].mlp.experts == (1, 2)


def test_init_params_is_seeded():
    cfg = tllama.LlamaConfig.tiny(vocab_size=32)
    a, b = (tllama.LlamaModel(cfg, device="cpu") for _ in range(2))
    tllama.init_params(a, torch.Generator().manual_seed(3))
    tllama.init_params(b, torch.Generator().manual_seed(3))
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    assert torch.all(a.norm.weight == 1)
