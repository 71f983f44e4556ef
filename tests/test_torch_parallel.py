"""Port parity for parallel/mesh.py and parallel/sharding.py (no processes):
mesh sizes and errors, specs, and each TP rank's shard of a converted tree,
against ray_tpu.parallel over the 8 virtual CPU devices (tests/conftest.py).
Also the refusals of serving over a mesh that need no rank process.

Grids run as loops inside a few tests (each failure names its case): the
file stays smaller than the suite's large files, so pytest-xdist's
largest-first hand-out of files keeps their order."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import sharding as jshard
from ray_tpu_torch.llm import EngineConfig, LLMEngine, LLMServer
from ray_tpu_torch.llm._internal.tp import resolve_backend
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import convert_params, layout_kind, torch_name
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import sharding as tshard

CPU = torch.device("cpu")


def _meshes(shape, n=8):
    """The reference's mesh over the first n JAX CPU devices and the
    port's over n CPU devices."""
    return (jmesh.create_mesh(shape, devices=jax.devices()[:n]),
            tmesh.create_mesh(shape, devices=[CPU] * n))


MESH_SHAPES = [
    ({}, 1), ({"tensor": 8}, 8), ({"tensor": 4}, 4), ({"tensor": 2}, 2),
    ({"data": 2, "tensor": 4}, 8), ({"data": -1, "tensor": 2}, 8),
    ({"fsdp": 2, "seq": 2, "tensor": -1}, 8),
    ({"data": 2, "fsdp": 2, "expert": 2}, 8), ({"stage": -1}, 8),
]


def test_create_mesh_sizes_match_reference():
    for shape, n in MESH_SHAPES:
        ref, port = _meshes(shape, n)
        assert tmesh.mesh_shape(port) == jmesh.mesh_shape(ref), shape
        assert port.axis_names == tuple(ref.axis_names) == tmesh.AXIS_ORDER
        assert tmesh.dp_axes(port) == jmesh.dp_axes(ref), shape
        assert port.size == ref.devices.size == n, shape
        # Rank r sits where device r sits in the reference's device array.
        for r in range(n):
            where = np.argwhere(ref.devices == jax.devices()[r])[0]
            assert list(port.coords(r).values()) == where.tolist(), (shape,
                                                                     r)


MESH_ERRORS = [{"tensor": 3}, {"bogus": 2}, {"data": -1, "tensor": -1},
               {"data": -1, "tensor": 3}, {"data": 4, "tensor": 4}]


def test_create_mesh_errors_match_reference():
    for shape in MESH_ERRORS:
        with pytest.raises(ValueError) as ref:
            jmesh.create_mesh(shape, devices=jax.devices())
        with pytest.raises(ValueError) as port:
            tmesh.create_mesh(shape, devices=[CPU] * 8)
        assert str(port.value) == str(ref.value), shape


def test_create_mesh_without_devices_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.create_mesh({"tensor": 2})


AXES = [("batch", "seq", "embed"), ("embed_fsdp", "heads", "head_dim"),
        ("heads", "head_dim", "embed_fsdp"), ("vocab", "embed_fsdp"),
        ("expert", "embed_fsdp", "mlp"), ("batch", None, "kv_heads"),
        (None, None), ("stage", "mlp"), ("embed",)]
RULES = [None, {"embed": "fsdp"}, {"heads": ("tensor", "seq")},
         {"batch": "data", "mlp": None}]
# Shapes with dims the axes do not divide (2 kv heads on tensor=4, odd
# vocab, 3 experts).
SHAPES = [(8, 8, 8), (2, 6, 4), (7, 2, 3), (4, 2, 128), (3, 16, 12)]


SPEC_MESHES = [{"tensor": 4}, {"data": 2, "tensor": 4},
               {"fsdp": 2, "seq": 2, "tensor": 2},
               {"data": 2, "fsdp": 2, "expert": 2}, {"tensor": 8}]


def spec_pairs(mesh_shape, rules):
    """(port spec, tuple of the reference's) for every logical axes of AXES,
    without a mesh and on the mesh, and after _drop_indivisible over
    SHAPES."""
    ref, port = _meshes(mesh_shape, int(np.prod(list(mesh_shape.values()))))
    out = []
    for axes in AXES:
        for mesh_r, mesh_p in ((None, None), (ref, port)):
            out.append((tshard.spec_for(axes, rules, mesh_p),
                        tuple(jshard.spec_for(axes, rules, mesh_r))))
        for shape in SHAPES:
            shape = shape[:len(axes)] + (5,) * (len(axes) - len(shape))
            out.append((tshard._drop_indivisible(
                tshard.spec_for(axes, rules, port), shape, port),
                tuple(jshard._drop_indivisible(
                    jshard.spec_for(axes, rules, ref), shape, ref))))
    return out


def test_spec_for_and_drop_indivisible_match_reference():
    for mesh_shape in SPEC_MESHES:
        for rules in RULES:
            for got, want in spec_pairs(mesh_shape, rules):
                assert got == want, (mesh_shape, rules)


def _rank_of(mesh, device):
    return int(np.argwhere(mesh.devices.reshape(-1) == device)[0, 0])


def tiny_shards(n):
    """Per rank r of TP n: (convert_params of the reference's shard on
    device r, the port's shard_state_dict of the converted tree, the port's
    TP model of rank r on the meta device, the converted tree)."""
    jcfg = jllama.LlamaConfig.tiny(vocab_size=128)
    params = jax.jit(jllama.LlamaModel(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    ref, port = _meshes({"tensor": n}, n)
    sharded = jshard.shard_tree(
        params, jllama.LLAMA_SHARDING.tree_shardings(ref, params))
    full = convert_params(jax.tree.map(np.asarray, params))
    per_rank = [{} for _ in range(n)]
    for path, leaf in jax.tree_util.tree_flatten_with_path(sharded)[0]:
        keys = [k.key for k in path]
        for shard in leaf.addressable_shards:
            node = per_rank[_rank_of(ref, shard.device)]
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = np.asarray(shard.data)
    cfg = tllama.LlamaConfig.tiny(vocab_size=128)
    return [(convert_params(per_rank[r]),
             tshard.shard_state_dict(full, port, r, tllama.LLAMA_SHARDING,
                                     {"heads": cfg.head_dim}),
             tllama.LlamaModel(cfg, device="meta", mesh=port, rank=r), full)
            for r in range(n)]


@pytest.mark.parametrize("n", [2, 4])
def test_tiny_rank_shards_equal_converted_reference_shards(n):
    """Each rank's shard of a converted tree (shard_params and
    shard_state_dict) equals convert_params of the reference's shard on
    the same device, exactly; the port's TP model holds those shapes."""
    for r, (want, got, model, full) in enumerate(tiny_shards(n)):
        local = dict(model.named_parameters())
        assert set(got) == set(want) == set(local)
        for k in want:
            assert np.array_equal(got[k], want[k]), (n, r, k)
            assert tuple(local[k].shape) == want[k].shape, (n, r, k)
        assert all(np.array_equal(v, got[k]) for k, v in
                   tllama.shard_params(model, full).items())


def _torch_index(kind, flax_index, flax_shape, head_dim):
    """A reference shard's flax-layout index as (start, stop) per dim of
    the torch layout (models/convert.py)."""
    span = [(s.start or 0, flax_shape[i] if s.stop is None else s.stop)
            for i, s in enumerate(flax_index)]
    if kind == "qkv":  # [hidden, heads, hd] -> [heads * hd, hidden]
        assert span[2] == (0, head_dim)
        return [(span[1][0] * head_dim, span[1][1] * head_dim), span[0]]
    if kind == "o":  # [heads, hd, hidden] -> [hidden, heads * hd]
        assert span[1] == (0, head_dim)
        return [span[2], (span[0][0] * head_dim, span[0][1] * head_dim)]
    return span[::-1] if kind == "dense" else span


@pytest.mark.parametrize("n", [2, 4])
def test_8b_rank_shard_slices_equal_reference(n):
    """At the Llama-3-8B shapes (jax.eval_shape; nothing allocated), each
    rank's slice of every parameter equals the reference's index for the
    same device, mapped to the torch layout, and the port's TP model (on
    the meta device) holds those shapes."""
    jcfg = jllama.LlamaConfig.llama3_8b()
    shapes = jax.eval_shape(jllama.LlamaModel(jcfg).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    ref, port = _meshes({"tensor": n}, n)
    shardings = jllama.LLAMA_SHARDING.tree_shardings(ref, shapes)
    cfg = tllama.LlamaConfig.llama3_8b()
    models = [tllama.LlamaModel(cfg, device="meta", mesh=port, rank=r)
              for r in range(n)]
    full = dict(tllama.LlamaModel(cfg, device="meta").named_parameters())
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert len(leaves) == len(full)
    for path, leaf in leaves:
        name = torch_name(tuple(k.key for k in path))
        sharding = shardings
        for k in path:
            sharding = sharding[k.key]
        tshape = tuple(full[name].shape)
        spec = tllama.LLAMA_SHARDING.spec(name, tshape, port,
                                          {"heads": cfg.head_dim})
        for device, index in sharding.devices_indices_map(
                leaf.shape).items():
            r = _rank_of(ref, device)
            want = _torch_index(layout_kind(name), index, leaf.shape,
                                cfg.head_dim)
            got = tshard.shard_index(spec, tshape, port, r)
            got = [(s.start or 0, tshape[i] if s.stop is None else s.stop)
                   for i, s in enumerate(got)]
            assert got == want, (name, r)
            local = dict(models[r].named_parameters())[name]
            assert list(local.shape) == [b - a for a, b in want], (name, r)
    attn = models[0].layers[0].self_attn
    assert (attn.heads, attn.kv_heads, models[0].kv_heads) == (
        32 // n, 8 // n, 8 // n)


def test_tp_backend_for_shared_cards():
    """Ranks that share a card need gloo named: NCCL refuses two ranks on
    one device, and nothing picks gloo on its own."""
    two_on_one = [torch.device("cuda", 0)] * 2
    with pytest.raises(ValueError, match="gloo"):
        resolve_backend(two_on_one, None)
    with pytest.raises(ValueError, match="NCCL refuses"):
        resolve_backend(two_on_one, "nccl")
    assert resolve_backend(two_on_one, "gloo") == "gloo"
    assert resolve_backend([torch.device("cuda", i) for i in range(2)],
                           None) == "nccl"
    assert resolve_backend([CPU] * 4, None) == "gloo"
    with pytest.raises(ValueError):
        resolve_backend([CPU] * 2, "nccl")


TINY = {"model": "tiny", "model_config": {"vocab_size": 128}, "seed": 0,
        "engine_config": {"max_seqs": 2, "page_size": 4,
                          "max_pages_per_seq": 16, "decode_steps": 2}}


def test_server_on_one_card_without_backend_raises(monkeypatch):
    """tensor_parallel_size=2 on a machine with one card puts both ranks
    on cuda:0; with no backend named the server raises before it starts a
    process."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="share a card"):
        LLMServer(dict(TINY, tensor_parallel_size=2), device="cuda")


def test_unported_tensor_parallel_combinations_raise(monkeypatch):
    """Combinations the reference serves over a mesh that the port refuses,
    before any rank process starts (ROADMAP Queue 3): a mesh axis other
    than "tensor" and "expert", and LoRA and int8 (a param_transform) over
    "tensor" or "expert" ranks, MoE model or not. MoE at {"tensor": 2} and
    {"expert": 2} passes these checks and reaches the rank runner (a stub
    here; tests/test_torch_ep.py serves it over rank processes)."""
    from ray_tpu_torch.llm._internal import tp as ttp

    class Runner:
        def __init__(self, model_cfg, params, cfg, cache_cfg, mesh,
                     backend=None):
            reached.append((model_cfg.num_experts, dict(
                (a, n) for a, n in zip(mesh.axis_names, mesh.shape)
                if n > 1)))

    reached = []
    monkeypatch.setattr(ttp, "TPRunner", Runner)
    tiny = tllama.LlamaConfig.tiny(vocab_size=128)
    moe = dataclasses.replace(tiny, num_experts=4)
    for what in ("mesh_axis", "lora", "int8", "moe"):
        for shape in ({"tensor": 2}, {"expert": 2}):
            cfg = moe if shape.get("expert") else tiny
            mesh = tmesh.create_mesh(shape, devices=[CPU] * 2)
            kw = {}
            if what == "mesh_axis":
                mesh = tmesh.create_mesh({"data": 2, **shape},
                                         devices=[CPU] * 4)
            elif what == "lora":
                kw["ecfg"] = {"lora_rank": 2}
            elif what == "int8":
                kw["param_transform"] = lambda p: p
            else:
                cfg = moe

            def engine():
                return LLMEngine(tllama.LlamaModel(cfg, device="meta"), {},
                                 EngineConfig(max_seqs=2, page_size=4,
                                              max_pages_per_seq=4,
                                              **kw.get("ecfg", {})),
                                 param_transform=kw.get("param_transform"),
                                 mesh=mesh, device="cpu")

            if what == "moe":
                engine()
                continue
            match = ("sharded-training" if what == "mesh_axis"
                     else "not ported")
            with pytest.raises(NotImplementedError, match=match):
                engine()
    assert reached == [(4, {"tensor": 2}), (4, {"expert": 2})]
