"""Attention ops: plain softmax attention, the blockwise (flash) update, and
flash attention through the hand-written CUDA kernel K1.

Port of ray_tpu/ops/attention.py. Shapes follow that module: q [B, Sq, H, D],
k/v [B, Skv, Hkv, D] with GQA (H a multiple of Hkv).

On a CUDA tensor ``flash_attention`` launches ``csrc/flash_fwd.cu`` (K1, the
counterpart of the Pallas ``_flash_kernel``); on a CPU tensor it runs
``flash_attention_fwd_plain``, the plain PyTorch version of the same
function. There is no fallback between the two: a CUDA tensor the kernel
does not take raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ray_tpu_torch import native

NEG_INF = -1e30


def _gqa_expand(k: torch.Tensor, v: torch.Tensor, num_heads: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    num_kv = k.shape[2]
    if num_kv == num_heads:
        return k, v
    rep = num_heads // num_kv
    return (k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2))


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Plain softmax attention (test oracle)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    k, v = _gqa_expand(k, v, q.shape[2])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_ids = torch.arange(q.shape[1], device=q.device)[:, None] + q_offset
        k_ids = torch.arange(k.shape[1], device=q.device)[None, :]
        logits = torch.where(k_ids <= q_ids, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# Blockwise primitive: one (q_block × kv_block) flash update on [B, S, H, D]
# blocks with running stats (the per-step primitive of ring attention).
# ---------------------------------------------------------------------------
def block_attn_update(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, H, D] (already GQA-expanded)
    v: torch.Tensor,
    m: torch.Tensor,  # [B, H, Sq] running rowmax
    l: torch.Tensor,  # [B, H, Sq] running denominator
    o: torch.Tensor,  # [B, Sq, H, D] running numerator (unnormalized)
    *,
    scale: float,
    mask: Optional[torch.Tensor] = None,  # [Sq, Sk] additive (0 / NEG_INF)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = s + mask[None, None, :, :]
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o_new = o * alpha.transpose(1, 2)[..., None] + pv
    return m_new, l_new, o_new


def block_attn_init(q: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, sq, h, d = q.shape
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    return m, l, o


def block_attn_finish(l: torch.Tensor, o: torch.Tensor, dtype) -> torch.Tensor:
    denom = l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return (o / denom).to(dtype)


# ---------------------------------------------------------------------------
# Flash attention forward: plain version and K1
# ---------------------------------------------------------------------------
def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1: (out [B,Sq,H,D] in q's dtype, row
    logsumexp [B,H,Sq] in f32), computed in f32 in one pass. Causal masks
    key j > query i with both counted from 0, as the Pallas kernel does."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    k, v = _gqa_expand(k, v, q.shape[2])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_ids = torch.arange(q.shape[1], device=q.device)[:, None]
        k_ids = torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(k_ids <= q_ids, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bhqd", p, v.float()) / denom
    lse = (m + torch.log(denom))[..., 0]
    return out.transpose(1, 2).to(q.dtype), lse


_FLASH_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
               + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
# Head dims the bf16 tensor-core path is compiled for (flash_fwd.cu); the f32
# path takes any multiple of 8 up to 128.
_BF16_HEAD_DIMS = (32, 64, 128)


def flash_fwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, scale: Optional[float] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 (csrc/flash_fwd.cu) on contiguous CUDA tensors q [B,Sq,H,D],
    k/v [B,Skv,Hkv,D] of one dtype (bf16 or f32). Returns (out [B,Sq,H,D],
    lse [B,H,Sq] f32). Raises on anything the kernel does not take."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_fwd_kernel takes CUDA tensors")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.bfloat16, torch.float32):
        raise TypeError(f"flash_fwd_kernel takes bf16 or f32, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)}"
                         f" v{tuple(v.shape)}")
    if hkv == 0 or h % hkv or skv == 0 or sq == 0:
        raise ValueError(f"bad head counts or lengths: H={h} Hkv={hkv} "
                         f"Sq={sq} Skv={skv}")
    if q.dtype == torch.bfloat16 and d not in _BF16_HEAD_DIMS:
        raise ValueError(f"bf16 flash kernel takes head_dim in "
                         f"{_BF16_HEAD_DIMS}, got {d}")
    if q.dtype == torch.float32 and (d % 8 or d > 128):
        raise ValueError(f"f32 flash kernel takes head_dim a multiple of 8 "
                         f"up to 128, got {d}")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_fwd_kernel takes contiguous, 16-byte "
                             "aligned tensors")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    name = "flash_fwd_bf16" if q.dtype == torch.bfloat16 else "flash_fwd_f32"
    fn = native.function("flash_fwd", name, _FLASH_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), b, h, hkv, sq, skv, d, scale, int(causal),
             torch.cuda.current_stream(q.device).cuda_stream)
    native.check(err, name)
    flash_fwd_kernel.launches += 1
    return out, lse


flash_fwd_kernel.launches = 0


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    block_q: int = 1024,
    block_k: int = 1024,
) -> torch.Tensor:
    """Flash attention. q [B,Sq,H,D], k/v [B,Skv,Hkv,D] → [B,Sq,H,D].

    CUDA tensors go through K1, which indexes the kv head as h // (H/Hkv)
    instead of materializing the GQA repeat, and uses its own fixed tiles
    with masked ragged tails; ``block_q``/``block_k`` are accepted for the
    JAX contract and do not change the result. CPU tensors go through
    ``flash_attention_fwd_plain`` (differentiable by autograd). The backward
    kernels (K2/K3) are not ported yet, so asking for gradients through the
    CUDA path raises."""
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block sizes must be positive, got "
                         f"({block_q},{block_k})")
    if not q.is_cuda:
        return flash_attention_fwd_plain(q, k, v, causal, scale)[0]
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError("flash backward: K2/K3 not yet ported")
    out, _ = flash_fwd_kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=causal, scale=scale)
    return out
