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
``MoEMlp`` of models/moe.py. ``forward(..., weights=)`` takes each module's
weights from a ``WeightsAtUse`` (models/quant.py) at its point of use instead
of from the module: the serving path of an int8 state dict.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.ops.attention import (
    NEG_INF,
    _gqa_expand,
    attention_reference,
    flash_attention,
)
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
    # "flash" (K1 on the card), "reference", or "ring" (the parallel/ slice)
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


class Linear(nn.Linear):
    """Bias-free ``nn.Linear`` whose weight is kept in ``param_dtype`` and
    cast to ``dtype`` at use (flax ``Dense(dtype=, param_dtype=)``)."""

    def __init__(self, in_features: int, out_features: int, dtype,
                 param_dtype, device=None):
        super().__init__(in_features, out_features, bias=False,
                         device=device, dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, _cast(self.weight, self.compute_dtype))


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
    def __init__(self, cfg: LlamaConfig, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        h, hk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        lin = lambda i, o: Linear(i, o, cfg.dtype, param_dtype or cfg.dtype,
                                  device)
        self.q_proj = lin(cfg.hidden_size, h * d)
        self.k_proj = lin(cfg.hidden_size, hk * d)
        self.v_proj = lin(cfg.hidden_size, hk * d)
        self.o_proj = lin(h * d, cfg.hidden_size)

    def forward(self, x, positions, kv_cache=None, cache_index=None,
                paged=None, lora=None, lora_idx=None):
        cfg = self.cfg
        b, s, _ = x.shape
        h, hk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = self.q_proj(x).view(b, s, h, d)
        k = self.k_proj(x).view(b, s, hk, d)
        v = self.v_proj(x).view(b, s, hk, d)
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
            return y

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
            out = paged_attention(q, k_pages, v_pages, paged["page_table"],
                                  pos2d, paged["seq_lens"])
            return o_proj(out), (k_pages, v_pages)

        if kv_cache is not None:
            # Decode: append to the cache (in place), attend over the prefix.
            ck, cv = kv_cache  # [B, max_len, hk, d]
            ck[:, cache_index:cache_index + s] = k
            cv[:, cache_index:cache_index + s] = v
            k_ids = torch.arange(ck.shape[1], device=x.device)
            q_pos = cache_index + torch.arange(s, device=x.device)
            out = _masked_attention(q, ck, cv, k_ids[None, :] <= q_pos[:, None])
            return o_proj(out), (ck, cv)

        if cfg.attention_impl == "ring":
            raise NotImplementedError(
                "ring attention is not ported yet (the parallel/ slice)")
        if cfg.attention_impl == "flash":
            out = flash_attention(q, k, v, causal=True)
        else:
            out = attention_reference(q, k, v, causal=True)
        return o_proj(out), None


class Mlp(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, param_dtype=None):
        super().__init__()
        lin = lambda i, o: Linear(i, o, cfg.dtype, param_dtype or cfg.dtype,
                                  device)
        self.gate_proj = lin(cfg.hidden_size, cfg.intermediate_size)
        self.up_proj = lin(cfg.hidden_size, cfg.intermediate_size)
        self.down_proj = lin(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, param_dtype=None):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       cfg.dtype, device)
        self.self_attn = Attention(cfg, device, param_dtype)
        self.post_attention_layernorm = RMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, device)
        if cfg.num_experts > 0:
            from ray_tpu_torch.models.moe import MoEMlp

            self.mlp = MoEMlp(cfg.hidden_size, cfg.intermediate_size,
                              cfg.num_experts, cfg.moe_capacity_factor,
                              cfg.dtype, device, param_dtype)
        else:
            self.mlp = Mlp(cfg, device, param_dtype)

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
    ``cfg.dtype``; training uses torch.float32)."""

    def __init__(self, cfg: LlamaConfig, device=None, param_dtype=None):
        super().__init__()
        device = resolve_device(device)
        param_dtype = param_dtype or cfg.dtype
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         device=device, dtype=param_dtype)
        self.layers = nn.ModuleList(
            [DecoderLayer(cfg, device, param_dtype)
             for _ in range(cfg.num_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype,
                            device)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, cfg.dtype,
                              param_dtype, device)

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
        (they may live on the meta device)."""
        cfg = self.cfg
        device = input_ids.device
        if positions is None:
            start = cache_index if (kv_caches is not None
                                    and cache_index is not None) else 0
            positions = start + torch.arange(input_ids.shape[1],
                                             device=device)
        # Gather rows, then cast: the same values as casting the table first.
        if weights is None:
            x = self.embed_tokens(input_ids)
        else:
            x = weights("embed_tokens", rows=input_ids)["weight"]
        x = _cast(x, cfg.dtype)
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
        logits = _run(self.lm_head, "lm_head", weights, x)
        if kv_caches is not None or paged_kv is not None:
            return logits, new_caches
        return logits


@torch.no_grad()
def init_params(model: LlamaModel, generator: torch.Generator) -> None:
    """Seeded random weights at flax's default scales: normal with
    variance 1/fan_in for every projection, 1/vocab for the embedding
    (flax's embed init), ones for the norm scales. ``generator`` lives on
    the parameters' device."""
    for name, p in model.named_parameters():
        if p.dim() == 1:
            p.fill_(1.0)
        elif name == "embed_tokens.weight":
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[0]), generator=generator)
        else:
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=generator)


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
