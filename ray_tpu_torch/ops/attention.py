"""Attention ops: plain softmax attention, the blockwise (flash) update, and
flash attention with its backward through the hand-written CUDA kernels
K1 (forward), K2 (dQ) and K3 (dK, dV).

Port of ray_tpu/ops/attention.py. Shapes follow that module: q [B, Sq, H, D],
k/v [B, Skv, Hkv, D] with GQA (H a multiple of Hkv).

``flash_attention`` is differentiable through ``FlashAttention`` (the
counterpart of the JAX ``_flash_core`` custom_vjp). On a CUDA tensor its
forward launches ``csrc/flash_fwd.cu`` (K1, the Pallas ``_flash_kernel``)
and its backward ``csrc/flash_bwd.cu`` (K2 and K3, the Pallas
``_flash_dq_kernel`` and ``_flash_dkv_kernel``); on a CPU tensor they run
``flash_attention_fwd_plain`` and ``flash_attention_bwd_plain``, the plain
PyTorch versions of the same functions. There is no fallback between the
two: a CUDA tensor the kernels do not take raises. A head dim the kernels
are not built for, up to 128, runs them on q, k and v padded with zero
columns (``kernel_head_dim``); past 128 it raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ray_tpu_torch import native

NEG_INF = -1e30


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """exp(x) for the plain versions. On a CPU float32 tensor it goes
    through float64 and rounds back: torch's first multi-threaded float32
    exp in a process (the CPU build of torch 2.13) can return one worker
    thread's share of the tensor off by up to 1e-4, which float64's exp
    does not; on the card it is float32's exp."""
    if x.is_cuda or x.dtype != torch.float32:
        return torch.exp(x)
    return torch.exp(x.double()).float()


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
    alpha = exp_f32(m - m_new)
    p = exp_f32(s - m_new[..., None])
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
    p = exp_f32(s - m)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bhqd", p, v.float()) / denom
    lse = (m + torch.log(denom))[..., 0]
    return out.transpose(1, 2).to(q.dtype), lse


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, dout: torch.Tensor,
                              causal: bool = True,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain PyTorch version of K2 + K3: (dq [B,Sq,H,D], dk, dv
    [B,Skv,Hkv,D]) in their inputs' dtypes, computed in f32 by the recipe
    of ``_flash_bwd_core``: P rebuilt from the row logsumexp ``lse``
    [B,H,Sq], Delta = rowsum(dO * O), dP = dO V^T, dS = P (dP - Delta)
    scale. dk/dv are summed over each query group (the VJP of the GQA
    repeat)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    ke, ve = _gqa_expand(k.float(), v.float(), h)
    qf, dof = q.float(), dout.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, ke) * scale
    if causal:
        q_ids = torch.arange(sq, device=q.device)[:, None]
        k_ids = torch.arange(skv, device=q.device)[None, :]
        s = torch.where(k_ids <= q_ids, s, NEG_INF)
    p = exp_f32(s - lse[..., None])
    delta = flash_bwd_delta(out, dout)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, ve)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, ke)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    group = (b, skv, hkv, h // hkv, d)
    return (dq.to(q.dtype), dk.view(group).sum(3).to(k.dtype),
            dv.view(group).sum(3).to(v.dtype))


# ---------------------------------------------------------------------------
# The kernels: K1 (csrc/flash_fwd.cu), K2 and K3 (csrc/flash_bwd.cu)
# ---------------------------------------------------------------------------
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_TAIL = [_INT] * 6 + [ctypes.c_float, _INT, _PTR]  # B,H,Hkv,Sq,Skv,D, ...
_FWD_ARGS = [_PTR] * 5 + _TAIL
_BWD_DQ_ARGS = [_PTR] * 7 + _TAIL
_BWD_DKV_ARGS = [_PTR] * 8 + _TAIL
# Head dims the bf16 tensor-core paths are compiled for; the f32 paths take
# any multiple of 8 up to 128.
_BF16_HEAD_DIMS = (32, 64, 128)


def _check_flash_args(what: str, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, *rest: torch.Tensor) -> None:
    """Raise on anything the kernels do not take: q [B,Sq,H,D], k/v
    [B,Skv,Hkv,D] of one dtype (bf16 or f32), and they and the backward's
    ``rest`` (dO, lse, delta) contiguous, 16-byte aligned CUDA tensors."""
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    if not all(t.is_cuda for t in (q, k, v, *rest)):
        raise ValueError(f"{what} takes CUDA tensors")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.bfloat16, torch.float32):
        raise TypeError(f"{what} takes bf16 or f32, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)}"
                         f" v{tuple(v.shape)}")
    if hkv == 0 or h % hkv or skv == 0 or sq == 0:
        raise ValueError(f"bad head counts or lengths: H={h} Hkv={hkv} "
                         f"Sq={sq} Skv={skv}")
    if q.dtype == torch.bfloat16 and d not in _BF16_HEAD_DIMS:
        raise ValueError(f"bf16 {what} takes head_dim in {_BF16_HEAD_DIMS}, "
                         f"got {d}")
    if q.dtype == torch.float32 and (d % 8 or d > 128):
        raise ValueError(f"f32 {what} takes head_dim a multiple of 8 up to "
                         f"128, got {d}")
    for t in (q, k, v, *rest):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} takes contiguous, 16-byte aligned "
                             f"tensors")


def _check_bwd_args(what: str, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                    delta: torch.Tensor) -> None:
    """``_check_flash_args``, and dout like q, lse and delta f32
    [B,H,Sq]."""
    _check_flash_args(what, q, k, v, dout, lse, delta)
    b, sq, h, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"{what}: dout {tuple(dout.shape)} {dout.dtype} "
                         f"must match q {tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, sq) or t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be f32 [{b},{h},{sq}], "
                             f"got {t.dtype} {tuple(t.shape)}")


def _dims(q: torch.Tensor, k: torch.Tensor) -> Tuple[int, ...]:
    b, sq, h, d = q.shape
    return b, h, k.shape[2], sq, k.shape[1], d


def _suffix(q: torch.Tensor) -> str:
    return "bf16" if q.dtype == torch.bfloat16 else "f32"


def _stream(q: torch.Tensor) -> int:
    return torch.cuda.current_stream(q.device).cuda_stream


def flash_fwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, scale: Optional[float] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 (csrc/flash_fwd.cu) on contiguous CUDA tensors q [B,Sq,H,D],
    k/v [B,Skv,Hkv,D] of one dtype (bf16 or f32). Returns (out [B,Sq,H,D],
    lse [B,H,Sq] f32). Raises on anything the kernel does not take."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    _check_flash_args("flash_fwd_kernel", q, k, v)
    b, sq, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    name = f"flash_fwd_{_suffix(q)}"
    fn = native.function("flash_fwd", name, _FWD_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), *_dims(q, k), scale, int(causal), _stream(q))
    native.check(err, name)
    flash_fwd_kernel.launches += 1
    return out, lse


flash_fwd_kernel.launches = 0


def flash_bwd_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """Delta = rowsum(dO * O) in f32, [B,H,Sq]: the row term of dS, computed
    outside the kernels as ``_flash_bwd_core`` does."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_bwd_dq_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, lse: torch.Tensor,
                        delta: torch.Tensor, *, causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Launch K2 (csrc/flash_bwd.cu): dq [B,Sq,H,D] in q's dtype from q,
    dout [B,Sq,H,D], k/v [B,Skv,Hkv,D], K1's lse and ``flash_bwd_delta``
    (both f32 [B,H,Sq]). Raises on anything the kernel does not take."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    _check_bwd_args("flash_bwd_dq_kernel", q, k, v, dout, lse, delta)
    dq = torch.empty_like(q)
    name = f"flash_bwd_dq_{_suffix(q)}"
    fn = native.function("flash_bwd", name, _BWD_DQ_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *_dims(q, k),
             scale, int(causal), _stream(q))
    native.check(err, name)
    flash_bwd_dq_kernel.launches += 1
    return dq


flash_bwd_dq_kernel.launches = 0


def flash_bwd_dkv_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         dout: torch.Tensor, lse: torch.Tensor,
                         delta: torch.Tensor, *, causal: bool = True,
                         scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3 (csrc/flash_bwd.cu): (dk, dv) [B,Skv,Hkv,D] in k's dtype,
    summed over each query group inside the kernel. Same inputs as
    ``flash_bwd_dq_kernel``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    _check_bwd_args("flash_bwd_dkv_kernel", q, k, v, dout, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    name = f"flash_bwd_dkv_{_suffix(q)}"
    fn = native.function("flash_bwd", name, _BWD_DKV_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             *_dims(q, k), scale, int(causal), _stream(q))
    native.check(err, name)
    flash_bwd_dkv_kernel.launches += 1
    return dk, dv


flash_bwd_dkv_kernel.launches = 0


def kernel_head_dim(d: int, dtype: torch.dtype) -> int:
    """The head dim K1–K3 run a head dim of ``d`` at: in bf16 the next of
    ``_BF16_HEAD_DIMS``, in f32 the next multiple of 8; past 128, ``d``
    itself (which the kernels refuse)."""
    if d > 128:
        return d
    if dtype == torch.bfloat16:
        return next(dp for dp in _BF16_HEAD_DIMS if d <= dp)
    return -(-d // 8) * 8


def pad_head_dim(x: torch.Tensor, dp: int) -> torch.Tensor:
    """``x`` with zero columns appended to its last dim up to ``dp``. Zero
    columns of q and k add nothing to QKᵀ, and zero columns of v, dO give
    zero columns of the output and the gradients, so the softmax, LSE and
    Delta do not change."""
    d = x.shape[-1]
    return x if d == dp else torch.nn.functional.pad(x, (0, dp - d))


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, scale: Optional[float] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``FlashAttention``'s forward on CUDA tensors: K1 at
    ``kernel_head_dim``, on q, k and v padded with zero columns, the output
    sliced back to D. ``scale`` defaults to the true D's."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dp = kernel_head_dim(d, q.dtype)
    q, k, v = (pad_head_dim(t, dp).contiguous() for t in (q, k, v))
    out, lse = flash_fwd_kernel(q, k, v, causal=causal, scale=scale)
    return (out if dp == d else out[..., :d].contiguous()), lse


def flash_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                   *, causal: bool = True, scale: Optional[float] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``FlashAttention``'s backward on CUDA tensors: Delta from the true
    out and dO, then K2 and K3 at ``kernel_head_dim`` on q, k, v and dO
    padded with zero columns, dq, dk and dv sliced back to D."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dp = kernel_head_dim(d, q.dtype)
    dout = dout.contiguous()
    delta = flash_bwd_delta(out, dout)
    q, k, v, dout = (pad_head_dim(t, dp).contiguous()
                     for t in (q, k, v, dout))
    dq = flash_bwd_dq_kernel(q, k, v, dout, lse, delta, causal=causal,
                             scale=scale)
    dk, dv = flash_bwd_dkv_kernel(q, k, v, dout, lse, delta, causal=causal,
                                  scale=scale)
    if dp != d:
        dq, dk, dv = (t[..., :d].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward, the counterpart of the JAX
    package's ``_flash_core`` custom_vjp. On CUDA tensors the forward
    launches K1 and the backward K2 and K3 (``flash_fwd_cuda``,
    ``flash_bwd_cuda``); on CPU tensors both run their plain versions.
    There is no fallback between the two."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        if q.is_cuda:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            out, lse = flash_fwd_cuda(q, k, v, causal=causal, scale=scale)
        else:
            out, lse = flash_attention_fwd_plain(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale = ctx.causal, ctx.scale
        if not q.is_cuda:
            return (*flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                               causal, scale), None, None)
        return (*flash_bwd_cuda(q, k, v, out, lse, dout, causal=causal,
                                scale=scale), None, None)


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
    """Flash attention. q [B,Sq,H,D], k/v [B,Skv,Hkv,D] → [B,Sq,H,D],
    differentiable through ``FlashAttention``.

    CUDA tensors go through K1 (forward) and K2/K3 (backward), which index
    the kv head as h // (H/Hkv) instead of materializing the GQA repeat and
    use their own fixed tiles with masked ragged tails (a head dim up to
    128 they are not built for is zero-padded); ``block_q``/
    ``block_k`` are accepted for the JAX contract and do not change the
    result. CPU tensors go through ``flash_attention_fwd_plain`` and
    ``flash_attention_bwd_plain``."""
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block sizes must be positive, got "
                         f"({block_q},{block_k})")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return FlashAttention.apply(q, k, v, causal, scale)
