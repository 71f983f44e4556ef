"""Llama-family transformer in PyTorch. Port of ray_tpu/models/llama.py.

Same structure and parameter names as the flax model (see
models/convert.py for the weight layouts): RMSNorm with f32 accumulation,
RoPE on split halves, GQA, SwiGLU; attention by plain softmax, by flash
attention (the CUDA kernel K1 on the card), over a contiguous KV cache, or
over the paged KV cache of the serving engine.

Parameters live in ``param_dtype`` (norm scales always in f32) and every
projection, the embedding and ``lm_head`` cast their weight to ``cfg.dtype``
at use, as flax does with ``param_dtype=jnp.float32``. ``param_dtype``
defaults to ``cfg.dtype``: for inference that computes the same thing with
half the memory in bf16, and the cast is skipped. Training needs f32
parameters (``param_dtype=torch.float32``): AdamW applied to bf16 weights
drops every update smaller than one bf16 ulp.

With ``cfg.remat``, grad enabled and no KV cache, each decoder layer runs
under ``torch.utils.checkpoint`` (flax's ``nn.remat``): its activations are
recomputed in the backward, so K1 runs twice per layer and step.

``cfg.num_experts > 0`` swaps each layer's SwiGLU MLP for the switch-routed
``MoEMlp`` of models/moe.py; over an "expert" axis each rank holds its
experts (expert parallelism, parallel/ep.py), under "tensor" each expert's
"mlp" part, under "fsdp" each expert kernel's "embed_fsdp" part.
``forward(..., weights=)`` takes each module's weights from a
``WeightsAtUse`` (models/quant.py) at its point of use instead of from the
module: the serving path of an int8 state dict.

``LlamaModel(cfg, mesh=)`` with a "tensor" axis of size N builds one rank's
shard of the model (megatron-style TP, ``LLAMA_SHARDING``): attention holds
h/N query heads and hk/N kv heads (all hk where N does not divide them) and
its ``o_proj`` is row-parallel; the MLP's gate/up are column-parallel and its
down row-parallel; ``embed_tokens`` and ``lm_head`` are vocab-parallel where
N divides the vocabulary (the rank masks its lookup, the logits are
gathered). A row-parallel partial is all-reduced in float32
(parallel/tp.py), over the rank's line along "tensor"; the collectives carry
their gradient rules, so the shard trains. The mesh may also have "data"
and "fsdp" axes (sharded training, train/step.py): ``place_params`` then
keeps each parameter's part of its "fsdp" dim, gathered at its use
(parallel/fsdp.py); attention, the norms, the embedding and ``lm_head``
are replicated over "expert". A "seq" axis of size n splits the sequence:
the rank holds tokens [c·S/n, (c+1)·S/n) at its coordinate c, rotates them
by those global positions, and attends by ring attention over the axis
(parallel/ring.py; ``attention_impl="ring"``, training only). A "stage"
axis holds replicas: the reference's model does not use it. The rank runs
inside a process group of ``mesh.size`` processes (llm/_internal/tp.py,
parallel/launch.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.models.convert import is_qleaf
from ray_tpu_torch.ops.attention import (
    NEG_INF,
    _gqa_expand,
    attention_reference,
    flash_attention,
)
from ray_tpu_torch.parallel.fsdp import FSDP, fsdp_dim, fsdp_of, place
from ray_tpu_torch.parallel.mesh import Mesh
from ray_tpu_torch.parallel.sharding import (
    ParamShardingRules,
    keep_axes,
    shard_index,
)
from ray_tpu_torch.parallel.ep import ExpertParallel, expert_parallel
from ray_tpu_torch.parallel.tp import AxisParallel, TensorParallel
from ray_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    hidden_size: int = 4096
    intermediate_size: int = 14_336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    max_seq_len: int = 8192
    rope_theta: float = 500_000.0
    rms_norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    # "flash" (K1 on the card), "reference", or "ring" (ring attention over
    # the mesh's "seq" axis; plain attention without one)
    attention_impl: str = "flash"
    # Activation checkpointing for training; inference ignores it.
    remat: bool = True
    # >0 replaces the dense SwiGLU Mlp with a switch-routed MoE of this many
    # experts (models/moe.py).
    num_experts: int = 0
    moe_capacity_factor: float = 1.25

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama3_70b() -> "LlamaConfig":
        return LlamaConfig(hidden_size=8192, intermediate_size=28672,
                           num_layers=80, num_heads=64, num_kv_heads=8)

    @staticmethod
    def tiny(vocab_size: int = 512) -> "LlamaConfig":
        """Test-sized config: runs on the CPU in seconds."""
        return LlamaConfig(vocab_size=vocab_size, hidden_size=128,
                           intermediate_size=256, num_layers=2, num_heads=4,
                           num_kv_heads=2, head_dim=32, max_seq_len=512,
                           dtype=torch.float32, attention_impl="reference",
                           remat=False)


# Parameter sharding rules: port name -> logical axes of the torch [out, in]
# layout (ray_tpu/models/llama.py's LLAMA_SHARDING on the flax layout; the
# tensor axis shards heads/mlp/vocab, fsdp the remaining embed dim). A q/k/v
# weight's rows and o_proj's columns are [heads * head_dim]: they split in
# whole heads (``blocks={"heads": head_dim}``).
LLAMA_SHARDING = ParamShardingRules([
    (r"embed_tokens\.weight", ("vocab", "embed_fsdp")),
    (r"(q_proj|k_proj|v_proj)\.weight", ("heads", "embed_fsdp")),
    (r"o_proj\.weight", ("embed_fsdp", "heads")),
    (r"(gate_proj|up_proj)\.weight", ("mlp", "embed_fsdp")),
    (r"down_proj\.weight", ("embed_fsdp", "mlp")),
    # MoE experts keep the flax layout [E, in, out]; the router is a Linear.
    (r"router\.weight", (None, "embed")),
    (r"(gate_kernel|up_kernel)", ("expert", "embed_fsdp", "mlp")),
    (r"down_kernel", ("expert", "mlp", "embed_fsdp")),
    (r"lm_head\.weight", ("vocab", "embed_fsdp")),
    (r"norm", ("embed",)),
])


def mesh_rank(mesh: Optional[Mesh], rank: Optional[int] = None) -> int:
    """``rank``, or this process's rank in its process group when the mesh
    has more than one rank (0 otherwise)."""
    if rank is not None or mesh is None or mesh.size == 1:
        return rank or 0
    import torch.distributed as dist

    return dist.get_rank()


def tensor_parallel(mesh: Optional[Mesh], rank: Optional[int] = None
                    ) -> Optional[TensorParallel]:
    """The TP rank of mesh rank ``rank`` (None for no mesh or a tensor axis
    of 1). ``rank`` defaults to this process's rank in its process group.
    A model takes every mesh axis (parallel/mesh.py's AXIS_ORDER)."""
    if mesh is None:
        return None
    n = mesh.axis_size("tensor")
    if n == 1:
        return None
    return TensorParallel(n, mesh.coords(mesh_rank(mesh, rank))["tensor"],
                          mesh)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        x32 = x32 * torch.rsqrt(
            x32.square().mean(dim=-1, keepdim=True) + self.eps)
        return (x32 * self.weight.float()).to(self.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] or [S]. Rotates the split halves
    (x[..., :D/2], x[..., D/2:]), not interleaved pairs."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs  # [B,S,D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _cast(w: torch.Tensor, dtype) -> torch.Tensor:
    return w if w.dtype == dtype else w.to(dtype)


class _AtUse:
    """A weight of a module at its use, in ``compute_dtype``: gathered
    over the fsdp ranks when ``fsdp.place`` kept only a part of it
    (``fsdp_dims``), and with its gradient summed over the ranks of each
    axis in ``sum_grad`` (a weight every rank holds whole but uses in
    part: TP's kv projections, the MoE router under EP or TP)."""

    fsdp: Optional[FSDP] = None
    sum_grad: Tuple[AxisParallel, ...] = ()

    def weight_at_use(self, name: str = "weight") -> torch.Tensor:
        p = getattr(self, name)
        dim = self.fsdp_dims.get(name)
        if dim is None:
            w = _cast(p, self.compute_dtype)
        else:
            w = self.fsdp.gather(p, dim, self.compute_dtype)
        for ax in self.sum_grad:
            w = ax.copy_in(w)
        return w


class Linear(_AtUse, nn.Linear):
    """Bias-free ``nn.Linear`` whose weight is kept in ``param_dtype`` and
    cast to ``dtype`` at use (flax ``Dense(dtype=, param_dtype=)``)."""

    def __init__(self, in_features: int, out_features: int, dtype,
                 param_dtype, device=None):
        super().__init__(in_features, out_features, bias=False,
                         device=device, dtype=param_dtype)
        self.compute_dtype = dtype
        self.fsdp_dims: Dict[str, int] = {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight_at_use())


class Embedding(_AtUse, nn.Embedding):
    """``nn.Embedding`` kept in ``param_dtype`` whose rows come out in
    ``dtype``: the rows gathered, then cast (the same values as casting
    the table first), or the table gathered over the fsdp ranks."""

    def __init__(self, num: int, dim: int, dtype, param_dtype, device=None):
        # A table on the meta device (the full model whose shapes the
        # sharding specs read) is given, not drawn: normal_ there runs
        # through torch._refs, whose first call imports torch._dynamo, some
        # seconds in every rank process.
        weight = None
        if device is not None and torch.device(device).type == "meta":
            weight = torch.empty(num, dim, dtype=param_dtype, device=device)
        super().__init__(num, dim, device=device, dtype=param_dtype,
                         _weight=weight)
        self.compute_dtype = dtype
        self.fsdp_dims: Dict[str, int] = {}

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if not self.fsdp_dims:
            return _cast(super().forward(ids), self.compute_dtype)
        return F.embedding(ids, self.weight_at_use())


def lora_delta(x, bank, idx):
    """Per-sequence batched LoRA. bank = {"a": [K, r, Din], "b": [K, Dout,
    r], "scale"}; idx [B] selects each sequence's adapter (slot 0 = zero
    adapter)."""
    a_sel = bank["a"][idx]  # [B, r, Din]
    b_sel = bank["b"][idx]  # [B, Dout, r]
    h1 = torch.einsum("bsd,brd->bsr", x.float(), a_sel.float())
    out = torch.einsum("bsr,bor->bso", h1, b_sel.float())
    scale = bank.get("scale", 1.0)
    if torch.is_tensor(scale) and scale.dim() == 1:  # per-slot scales
        scale = scale[idx][:, None, None]
    return out * scale


def _masked_attention(q, k, v, mask):
    """Decode-path attention with an explicit [S_q, S_k] boolean mask."""
    k, v = _gqa_expand(k, v, q.shape[2])
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    logits = torch.where(mask[None, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


class Attention(nn.Module):
    """With ``tp``: this rank's query heads [h0, h1) and kv heads (its
    1/N, or all of them when N does not divide them). The rank's query
    heads read the kv heads [kv0, kv1) of those it holds, a whole GQA group
    each; a split of heads that gives its query heads unequal groups
    raises. With ``ring`` (the mesh and mesh rank of a model whose "seq"
    axis is above 1), the cacheless forward is ring attention over that
    axis."""

    def __init__(self, cfg: LlamaConfig, device=None, param_dtype=None,
                 tp: Optional[TensorParallel] = None,
                 ring: Optional[Tuple[Mesh, int]] = None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        self.ring = ring
        h, hk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        h0, h1 = tp.part(h) if tp else (0, h)
        k0, k1 = tp.part(hk) if tp else (0, hk)
        g = h // hk
        lo, hi = h0 // g, (h1 - 1) // g + 1
        whole = (h0 % g == 0 and (h1 - h0) % g == 0) if h1 - h0 >= g else \
            hi - lo == 1
        if not whole:
            raise NotImplementedError(
                f"query heads [{h0}, {h1}) of {h} over {hk} kv heads give "
                "this rank unequal GQA groups; not ported")
        self.heads, self.kv_heads = h1 - h0, k1 - k0
        self.kv0, self.kv1 = lo - k0, hi - k0
        # Row-parallel o_proj: its partial sums are all-reduced.
        self.reduce = self.heads < h
        lin = lambda i, o: Linear(i, o, cfg.dtype, param_dtype or cfg.dtype,
                                  device)
        self.q_proj = lin(cfg.hidden_size, self.heads * d)
        self.k_proj = lin(cfg.hidden_size, self.kv_heads * d)
        self.v_proj = lin(cfg.hidden_size, self.kv_heads * d)
        self.o_proj = lin(self.heads * d, cfg.hidden_size)
        if self.reduce and self.kv_heads == hk:
            # Every rank holds the kv heads whole and its query heads read
            # some: their gradients are summed over the ranks.
            self.k_proj.sum_grad = self.v_proj.sum_grad = (tp,)

    def forward(self, x, positions, kv_cache=None, cache_index=None,
                paged=None, lora=None, lora_idx=None):
        cfg = self.cfg
        b, s, _ = x.shape
        h, hk, d = self.heads, self.kv_heads, cfg.head_dim
        if self.reduce:
            x = self.tp.copy_in(x)
        q = self.q_proj(x).view(b, s, h, d)
        k = self.k_proj(x).view(b, s, hk, d)
        v = self.v_proj(x).view(b, s, hk, d)
        if lora is not None and self.tp is not None:
            raise NotImplementedError(
                "LoRA under tensor parallelism is not ported")
        if lora is not None:
            if "q_proj" in lora:
                q = q + lora_delta(x, lora["q_proj"], lora_idx).reshape(
                    b, s, h, d).to(q.dtype)
            if "k_proj" in lora:
                k = k + lora_delta(x, lora["k_proj"], lora_idx).reshape(
                    b, s, hk, d).to(k.dtype)
            if "v_proj" in lora:
                v = v + lora_delta(x, lora["v_proj"], lora_idx).reshape(
                    b, s, hk, d).to(v.dtype)

        def o_proj(out4d):
            flat = out4d.reshape(b, s, h * d)
            y = self.o_proj(flat)
            if lora is not None and "o_proj" in lora:
                y = y + lora_delta(flat, lora["o_proj"], lora_idx).to(y.dtype)
            return self.tp.all_reduce(y) if self.reduce else y

        # The kv heads this rank's query heads read: all it holds, or some
        # where TP replicates them. A slice of the pages' leading dim (a
        # contiguous view) and a view of k/v.
        kv = slice(self.kv0, self.kv1)

        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

        if paged is not None:
            # Paged KV decode/prefill (serving engine). Pages are written in
            # place.
            from ray_tpu_torch.llm._internal.paged import (
                paged_attention,
                paged_write_lanes,
            )

            k_pages, v_pages = paged["kv_pages"]
            pos2d = torch.broadcast_to(positions, (b, s))
            paged_write_lanes(k_pages, k, paged["page_table"], pos2d,
                              paged["write_lanes"])
            paged_write_lanes(v_pages, v, paged["page_table"], pos2d,
                              paged["write_lanes"])
            out = paged_attention(q, k_pages[kv], v_pages[kv],
                                  paged["page_table"], pos2d,
                                  paged["seq_lens"])
            return o_proj(out), (k_pages, v_pages)

        if kv_cache is not None:
            # Decode: append to the cache (in place), attend over the prefix.
            ck, cv = kv_cache  # [B, max_len, hk, d]
            ck[:, cache_index:cache_index + s] = k
            cv[:, cache_index:cache_index + s] = v
            k_ids = torch.arange(ck.shape[1], device=x.device)
            q_pos = cache_index + torch.arange(s, device=x.device)
            out = _masked_attention(q, ck[:, :, kv], cv[:, :, kv],
                                    k_ids[None, :] <= q_pos[:, None])
            return o_proj(out), (ck, cv)

        # "ring" without a "seq" axis is plain attention, as in the
        # reference.
        k, v = k[:, :, kv], v[:, :, kv]
        if self.ring is not None:
            from ray_tpu_torch.parallel.ring import ring_attention

            mesh, rank = self.ring
            out = ring_attention(q, k, v, mesh=mesh, causal=True, rank=rank)
        elif cfg.attention_impl == "flash":
            out = flash_attention(q, k, v, causal=True)
        else:
            out = attention_reference(q, k, v, causal=True)
        return o_proj(out), None


class Mlp(nn.Module):
    """With ``tp``: gate/up column-parallel, down row-parallel (its partial
    sums all-reduced), where N divides the intermediate size."""

    def __init__(self, cfg: LlamaConfig, device=None, param_dtype=None,
                 tp: Optional[TensorParallel] = None):
        super().__init__()
        lin = lambda i, o: Linear(i, o, cfg.dtype, param_dtype or cfg.dtype,
                                  device)
        i0, i1 = tp.part(cfg.intermediate_size) if tp else (
            0, cfg.intermediate_size)
        self.tp = tp
        self.reduce = i1 - i0 < cfg.intermediate_size
        self.gate_proj = lin(cfg.hidden_size, i1 - i0)
        self.up_proj = lin(cfg.hidden_size, i1 - i0)
        self.down_proj = lin(i1 - i0, cfg.hidden_size)

    def forward(self, x):
        if self.reduce:
            x = self.tp.copy_in(x)
        y = self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))
        return self.tp.all_reduce(y) if self.reduce else y


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, param_dtype=None,
                 tp: Optional[TensorParallel] = None,
                 ring: Optional[Tuple[Mesh, int]] = None,
                 ep: Optional[ExpertParallel] = None):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       cfg.dtype, device)
        self.self_attn = Attention(cfg, device, param_dtype, tp, ring)
        self.post_attention_layernorm = RMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, device)
        if cfg.num_experts > 0:
            from ray_tpu_torch.models.moe import MoEMlp

            self.mlp = MoEMlp(cfg.hidden_size, cfg.intermediate_size,
                              cfg.num_experts, cfg.moe_capacity_factor,
                              cfg.dtype, device, param_dtype, tp, ep)
        else:
            self.mlp = Mlp(cfg, device, param_dtype, tp)

    def forward(self, x, positions, kv_cache=None, cache_index=None,
                paged=None, lora=None, lora_idx=None):
        attn_out, new_cache = self.self_attn(
            self.input_layernorm(x), positions, kv_cache, cache_index, paged,
            lora, lora_idx)
        x = x + attn_out
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x, new_cache


def _run(module: nn.Module, name: str, weights: Optional[Callable], *args):
    """``module(*args)``, on ``weights(name)`` when given (dropped on
    return) instead of the module's own parameters."""
    if weights is None:
        return module(*args)
    return torch.func.functional_call(module, weights(name), args)


class LlamaModel(nn.Module):
    """Parameters are created on ``device``: the card unless the caller
    names one (no CUDA and no device raises). ``param_dtype`` is the
    storage dtype of the projections, embedding and ``lm_head`` (default
    ``cfg.dtype``; training uses torch.float32).

    ``mesh`` builds mesh rank ``rank``'s shard (default: this process's
    rank in its process group, which the forward's collectives run over):
    its "tensor" part at construction, its "fsdp" part by ``place_params``.
    ``specs`` holds each parameter's spec on the mesh as it is placed. A
    "seq" axis above 1 needs ``attention_impl="ring"`` and runs the
    cacheless forward only; MoE layers over it are not ported (raises):
    a token's place in its expert's buffer counts along the whole
    sequence. An "expert" axis splits the MoE layers' experts."""

    def __init__(self, cfg: LlamaConfig, device=None, param_dtype=None,
                 mesh: Optional[Mesh] = None, rank: Optional[int] = None):
        super().__init__()
        device = resolve_device(device)
        param_dtype = param_dtype or cfg.dtype
        self.cfg = cfg
        self.mesh = mesh
        self.rank = mesh_rank(mesh, rank)
        self.tp = tp = tensor_parallel(mesh, self.rank)
        self.fsdp = fsdp_of(mesh, self.rank)
        # (size, this rank's coordinate) of the "seq" axis.
        self.seq = (1, 0) if mesh is None else (
            mesh.axis_size("seq"), mesh.coords(self.rank)["seq"])
        ring = None
        if self.seq[0] > 1:
            if cfg.attention_impl != "ring":
                raise NotImplementedError(
                    f"a \"seq\" axis of {self.seq[0]} splits the sequence, "
                    f"which only attention_impl=\"ring\" attends over; got "
                    f"{cfg.attention_impl!r}")
            ring = (mesh, self.rank)
        if ring is not None and cfg.num_experts > 0:
            raise NotImplementedError(
                "MoE layers over a \"seq\" axis are not ported: a token's "
                "place in its expert's buffer counts along the whole "
                "sequence")
        self.ep = ep = expert_parallel(mesh, self.rank)
        v0, v1 = tp.part(cfg.vocab_size) if tp else (0, cfg.vocab_size)
        self.vocab0 = v0
        self.vocab_parallel = v1 - v0 < cfg.vocab_size
        self.embed_tokens = Embedding(v1 - v0, cfg.hidden_size, cfg.dtype,
                                      param_dtype, device)
        self.layers = nn.ModuleList(
            [DecoderLayer(cfg, device, param_dtype, tp, ring, ep)
             for _ in range(cfg.num_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype,
                            device)
        self.lm_head = Linear(cfg.hidden_size, v1 - v0, cfg.dtype,
                              param_dtype, device)
        # The kv heads a layer holds, and so a rank's paged KV cache.
        k0, k1 = tp.part(cfg.num_kv_heads) if tp else (0, cfg.num_kv_heads)
        self.kv_heads = k1 - k0
        # The tensor and expert parts of LLAMA_SHARDING's specs: what the
        # modules above hold.
        self.specs = {} if mesh is None else _rule_specs(self, None)

    def _embed(self, input_ids):
        """Embedding rows in cfg.dtype. Vocab-parallel: each rank looks up
        the ids in its rows and zeros the rest, and the ranks' rows are
        summed (exact: one rank holds each id)."""
        if not self.vocab_parallel:
            return self.embed_tokens(input_ids)
        local = input_ids - self.vocab0
        held = (local >= 0) & (local < self.embed_tokens.num_embeddings)
        rows = self.embed_tokens(torch.where(held, local, 0))
        rows = torch.where(held[..., None], rows, 0)
        return self.tp.all_reduce(rows)

    def forward(self, input_ids, positions=None, kv_caches=None,
                cache_index=None, paged_kv=None, page_table=None,
                write_mask=None, seq_lens=None, lora=None, lora_idx=None,
                weights=None):
        """lora: {"layers_<i>": {proj: {"a": [K,r,Din], "b": [K,Dout,r],
        "scale": s}}} adapter BANKS; lora_idx [B] picks each sequence's
        adapter, slot 0 = none. With ``paged_kv``, ``write_mask`` [B,S]
        enables each lane's KV write (a mask built on the host costs no
        device sync). ``weights``: a WeightsAtUse (models/quant.py) that
        gives each module its weights where it runs, the embedding its
        gathered rows only; the model's own parameters are then not read
        (they may live on the meta device). Over a "seq" axis of n,
        ``input_ids`` is this rank's block of S/n tokens of each row, at
        positions from c·S/n on (c its coordinate)."""
        cfg = self.cfg
        device = input_ids.device
        n_seq, c_seq = self.seq
        if n_seq > 1 and (kv_caches is not None or paged_kv is not None):
            raise NotImplementedError(
                "a KV cache over a \"seq\" axis (serving) is not ported")
        if positions is None:
            start = cache_index if (kv_caches is not None
                                    and cache_index is not None) else 0
            start += c_seq * input_ids.shape[1]
            positions = start + torch.arange(input_ids.shape[1],
                                             device=device)
        if weights is not None and (self.tp is not None
                                    or self.fsdp is not None
                                    or self.ep is not None):
            raise NotImplementedError(
                "weights at use (int8) under tensor or expert parallelism "
                "or FSDP are not ported")
        # Gather rows, then cast: the same values as casting the table first.
        if weights is None:
            x = self._embed(input_ids)
        else:
            x = _cast(weights("embed_tokens", rows=input_ids)["weight"],
                      cfg.dtype)
        lanes = None
        if paged_kv is not None:
            from ray_tpu_torch.llm._internal.paged import write_lanes

            lanes = write_lanes(write_mask, device)
        remat = (cfg.remat and torch.is_grad_enabled() and kv_caches is None
                 and paged_kv is None)
        new_caches = []
        for i, layer in enumerate(self.layers):
            cache = kv_caches[i] if kv_caches is not None else None
            paged = None
            if paged_kv is not None:
                paged = {"kv_pages": paged_kv[i], "page_table": page_table,
                         "write_lanes": lanes, "seq_lens": seq_lens}
            layer_lora = (lora or {}).get(f"layers_{i}")
            args = (layer, f"layers.{i}", weights, x, positions, cache,
                    cache_index, paged, layer_lora, lora_idx)
            if remat:
                x, new_cache = checkpoint(_run, *args, use_reentrant=False)
            else:
                x, new_cache = _run(*args)
            new_caches.append(new_cache)
        x = _run(self.norm, "norm", weights, x)
        if self.vocab_parallel:
            x = self.tp.copy_in(x)
        logits = _run(self.lm_head, "lm_head", weights, x)
        if self.vocab_parallel:
            logits = self.tp.gather_last(logits)
        if kv_caches is not None or paged_kv is not None:
            return logits, new_caches
        return logits


# The mesh axes a model's modules split at construction; place_params adds
# "fsdp".
BUILT_AXES = ("tensor", "expert")


def _rule_specs(model: LlamaModel, rules: Optional[ParamShardingRules]
                ) -> Dict[str, Any]:
    """{name: spec under ``rules`` on the model's mesh} for every parameter
    (no rules: LLAMA_SHARDING's "tensor" and "expert" parts, the layout the
    model is built with)."""
    full = LlamaModel(model.cfg, device="meta")
    blocks = {"heads": model.cfg.head_dim}
    if rules is not None:
        return {n: rules.spec(n, p.shape, model.mesh, blocks)
                for n, p in full.named_parameters()}
    return {n: keep_axes(LLAMA_SHARDING.spec(n, p.shape, model.mesh, blocks),
                         BUILT_AXES)
            for n, p in full.named_parameters()}


def param_shards(model: LlamaModel) -> Dict[str, Any]:
    """{name: (full shape, this rank's index into it)} for every parameter
    of ``model`` (the whole of each without a mesh), by its ``specs``."""
    if model.mesh is None:
        return {n: (tuple(p.shape), (slice(None),) * p.dim())
                for n, p in model.named_parameters()}
    full = LlamaModel(model.cfg, device="meta")
    return {n: (tuple(p.shape), shard_index(model.specs[n], p.shape,
                                            model.mesh, model.rank))
            for n, p in full.named_parameters()}


def shard_params(model: LlamaModel, state_dict: Mapping[str, Any]
                 ) -> Dict[str, Any]:
    """A full state dict cut to ``model``'s shard (itself without a mesh):
    ``load_params(model, shard_params(model, sd))``. Quantized leaves are
    not sharded (raises)."""
    if model.mesh is None:
        return dict(state_dict)
    out = {}
    for name, (_, index) in param_shards(model).items():
        value = state_dict[name]
        if is_qleaf(value):
            raise NotImplementedError(
                f"{name}: sharding a quantized leaf is not ported")
        out[name] = value[index]
    return out


def place_params(model: LlamaModel,
                 rules: Optional[ParamShardingRules]) -> None:
    """Shard ``model``'s parameters over the mesh's "fsdp" axis as
    ``rules`` place them (``rules.spec`` of each, as the reference applies
    any rules; None places nothing over fsdp): each keeps this rank's part
    of the dim whose spec names "fsdp", and its module gathers the whole at
    use (parallel/fsdp.py). The tensor and expert parts of every spec must
    be what the model holds (they are built at construction), and the
    optimizer over these parameters must not have stepped yet. Placing
    again by the same rules changes nothing; by other rules raises."""
    if model.mesh is None:
        return
    specs = _rule_specs(model, rules)
    changed = sorted(n for n in specs if specs[n] != model.specs[n])
    modules = dict(model.named_modules())
    for n in changed:
        have, want = model.specs[n], specs[n]
        if keep_axes(want, BUILT_AXES) != keep_axes(have, BUILT_AXES):
            raise ValueError(
                f"{n}: the rules shard it over {BUILT_AXES} as {want}, the "
                f"model as {have} (its layout is LLAMA_SHARDING's)")
        if fsdp_dim(have) is not None:
            raise ValueError(f"{n} is placed as {have}; the rules place it "
                             f"as {want}")
        owner, _, attr = n.rpartition(".")
        if (keep_axes(want, BUILT_AXES + ("fsdp",)) != want
                or not hasattr(modules[owner], "fsdp_dims")):
            raise NotImplementedError(
                f"{n}: placing it as {want} is not ported (only Linear and "
                "Embedding weights and MoE expert kernels shard, over "
                "\"fsdp\")")
    for n in changed:
        owner, _, attr = n.rpartition(".")
        place(modules[owner], attr, fsdp_dim(specs[n]), model.fsdp)
        model.specs[n] = specs[n]


@torch.no_grad()
def init_params(model: LlamaModel, generator: torch.Generator) -> None:
    """Seeded random weights at flax's default scales: normal with
    variance 1/fan_in for every projection, 1/vocab for the embedding
    (flax's embed init), ones for the norm scales. ``generator`` lives on
    the parameters' device. A TP shard draws each full parameter in turn
    and keeps its slice, so it holds exactly the values the unsharded model
    gets from the same seed."""
    shards = param_shards(model)
    for name, p in model.named_parameters():
        full, index = shards[name]
        if p.dim() == 1:
            p.fill_(1.0)
            continue
        fan_in = full[0] if name == "embed_tokens.weight" else full[1]
        std = 1.0 / math.sqrt(fan_in)
        if full == tuple(p.shape):
            p.normal_(0.0, std, generator=generator)
        else:
            w = torch.empty(full, dtype=p.dtype, device=p.device)
            p.copy_(w.normal_(0.0, std, generator=generator)[index])
            del w


@torch.no_grad()
def load_params(model: nn.Module,
                state_dict: Mapping[str, Any]) -> None:
    """Copy a state dict of arrays or tensors (e.g. from
    models/convert.py) into the model's parameters, casting each to the
    parameter's dtype and device. Names must match exactly."""
    params = dict(model.named_parameters())
    missing = set(params) - set(state_dict)
    extra = set(state_dict) - set(params)
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {sorted(missing)}, "
                       f"unexpected {sorted(extra)}")
    for name, value in state_dict.items():
        t = value if torch.is_tensor(value) else torch.tensor(
            np.asarray(value))
        if tuple(t.shape) != tuple(params[name].shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(params[name].shape)}")
        params[name].copy_(t)


def init_kv_caches(cfg: LlamaConfig, batch: int, max_len: int, device=None):
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    device = resolve_device(device)
    return [(torch.zeros(shape, dtype=cfg.dtype, device=device),
             torch.zeros(shape, dtype=cfg.dtype, device=device))
            for _ in range(cfg.num_layers)]


def count_params(params) -> int:
    """Parameter count of a module or a state dict."""
    if isinstance(params, nn.Module):
        return sum(p.numel() for p in params.parameters())
    return sum(int(np.prod(np.shape(v))) for v in params.values())
