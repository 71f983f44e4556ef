"""Int8 weight quantization for serving. Port of ray_tpu/models/quant.py.

Scheme (the reference's): per-channel absmax int8 for every matrix-shaped
parameter (attention/MLP kernels, embeddings, the MoE router and experts);
vectors (norms) stay as they are. A quantized leaf of the flat state dict is
``{"__q__": int8, "s": bf16 scale}``. The scale groups as the flax kernel's
last axis does (models/convert.py has the layouts): one scale a head_dim
index shared by every head for q/k/v, one an output channel for o_proj and
the Dense kernels, one a hidden column for the embedding, one a last-axis
column shared by every expert for the MoE expert kernels.

The reference dequantizes inside its jitted step, where XLA fuses the
converts into the consuming products, so no bf16 tree is ever resident.
The port dequantizes at the point of use instead: ``WeightsAtUse`` hands
``LlamaModel`` one module's weights at a time (a decoder layer, the norm,
``lm_head``; the embedding's gathered rows only) through the transform, and
drops them after that module has run. ``LLMEngine`` does this for a tree
that holds quantized leaves.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.models.convert import (
    flax_path,
    is_qleaf,
    layout_kind,
    scale_to_torch,
    to_flax_layout,
    to_torch_layout,
)
from ray_tpu_torch.models.llama import LlamaModel
from ray_tpu_torch.utils.device import resolve_device


def as_tensor(x: Any, device=None) -> torch.Tensor:
    """A numpy array (bfloat16 ones included, as JAX hands them out) or a
    tensor -> a tensor on ``device``."""
    if isinstance(x, np.ndarray):
        x = np.ascontiguousarray(x)
        if not x.flags.writeable:  # e.g. a view of a JAX array
            x = x.copy()
        if x.dtype.name == "bfloat16":
            x = torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.as_tensor(x).to(device)


def tree_to(params: Dict[str, Any], device=None) -> Dict[str, Any]:
    """A flat state dict (quantized leaves included) as tensors on
    ``device``."""
    return {k: ({f: as_tensor(t, device) for f, t in v.items()}
                if is_qleaf(v) else as_tensor(v, device))
            for k, v in params.items()}


def _absmax_scale(name: str, w32: torch.Tensor, head_dim: int
                  ) -> torch.Tensor:
    """absmax over every axis of the flax layout but its last, in the torch
    layout of ``w32``."""
    kind = layout_kind(name)
    if kind == "qkv":  # [heads*head_dim, hidden]: one per head_dim index
        per_d = w32.abs().reshape(-1, head_dim, w32.shape[1]).amax(
            dim=(0, 2))
        return per_d.repeat(w32.shape[0] // head_dim)[:, None]
    if kind in ("o", "dense"):  # [out, in]: one per output channel
        return w32.abs().amax(dim=1, keepdim=True)
    return w32.abs().amax(dim=tuple(range(w32.dim() - 1)), keepdim=True)


def quantize_tree(params: Dict[str, Any], cfg, min_size: int = 4096,
                  device=None) -> Dict[str, Any]:
    """Quantize the matrix-shaped leaves (ndim >= 2, size >= min_size) of a
    flat Llama state dict (numpy arrays or tensors) laid out as
    models/convert.py gives it; ``cfg`` (a LlamaConfig) gives head_dim.
    Round half to even, clip to ±127, all against the f32 scale; the stored
    scale is bf16. Each leaf is moved to ``device`` (the card unless the
    caller names one) before it is quantized, and the result stays there."""
    device = resolve_device(device)

    def q(name, x):
        x = as_tensor(x, device)
        if x.dim() < 2 or x.numel() < min_size:
            return x
        xf = x.float()
        absmax = _absmax_scale(name, xf, cfg.head_dim)
        # Divide by a tensor, not a Python number: CUDA multiplies by the
        # reciprocal of a host scalar divisor, which rounds otherwise.
        scale = (absmax / absmax.new_tensor(127.0)).clamp_min(1e-8)
        qx = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
        return {"__q__": qx, "s": scale.to(torch.bfloat16)}

    return {name: q(name, x) for name, x in params.items()}


def dequantize_tree(qparams: Dict[str, Any], dtype=torch.bfloat16
                    ) -> Dict[str, Any]:
    """The inverse of ``quantize_tree``: each quantized leaf as int8 *
    scale in ``dtype``; other leaves as they are. One kernel a leaf: int8
    -> dtype is exact, so promoting the int8 operand inside the product
    gives the bits of ``q.to(dtype) * s.to(dtype)``."""
    return {k: v["__q__"] * v["s"].to(dtype) if is_qleaf(v) else v
            for k, v in qparams.items()}


def random_quantized_like(cfg, *, seed: int = 0, scale: float = 0.02,
                          min_size: int = 4096, device=None
                          ) -> Dict[str, Any]:
    """An int8 state dict for ``cfg``'s LlamaModel built directly on
    ``device`` (the card unless the caller names one), so a full-precision
    tree never exists: the reference's iota hash, leaf by leaf.

    Leaf i, numbered in the reference's order (jax's tree flatten of the
    flax params: sorted keys, so ``layers_10`` comes before ``layers_2``),
    holds ``(iota * (1103515245 + i) + 12345) % 255 - 127`` over its flax
    layout (int32 arithmetic that wraps, ``%`` with the divisor's sign),
    laid out for torch, with a bf16 scale of ``scale / 127``; leaves that
    are not quantized are bf16 ones. ``seed`` is unused, as in the
    reference. Throughput and memory runs only: real checkpoints go
    through quantize_tree."""
    device = resolve_device(device)
    shapes = dict(LlamaModel(cfg, device="meta").named_parameters())
    out: Dict[str, Any] = {}
    for i, name in enumerate(sorted(shapes, key=flax_path)):
        kind = layout_kind(name)
        fshape = tuple(to_flax_layout(kind, shapes[name], cfg.head_dim).shape)
        n = math.prod(fshape)
        if len(fshape) < 2 or n < min_size:
            out[name] = torch.ones(shapes[name].shape, dtype=torch.bfloat16,
                                   device=device)
            continue
        flat = torch.arange(n, dtype=torch.int32, device=device)
        flat.mul_(1103515245 + i).add_(12345).remainder_(255).sub_(127)
        qx = to_torch_layout(kind, flat.to(torch.int8).reshape(fshape))
        del flat
        s = torch.full((1,) * (len(fshape) - 1) + fshape[-1:],
                       scale / 127.0, dtype=torch.bfloat16, device=device)
        out[name] = {"__q__": qx.contiguous(),
                     "s": scale_to_torch(kind, s, fshape).contiguous()}
    return out


def quantized_bytes(qparams: Dict[str, Any]) -> int:
    """Resident device bytes of a (quantized) state dict. A q/k/v scale is
    stored for every head (``heads * head_dim`` bf16 values, the
    reference's ``head_dim``), so the port's count passes the reference's
    by ``(heads - 1) * head_dim * 2`` bytes a q/k/v weight."""
    total = 0
    for v in qparams.values():
        for t in (v.values() if is_qleaf(v) else (v,)):
            total += t.numel() * t.element_size()
    return total


def _rows(v: Any, rows: torch.Tensor) -> Any:
    """Rows ``rows`` of a leaf; a quantized leaf's [1, hidden] scale is the
    same for every row."""
    if not is_qleaf(v):
        return v[rows]
    s = v["s"]
    return {"__q__": v["__q__"][rows], "s": s if s.shape[0] == 1 else s[rows]}


class WeightsAtUse:
    """A flat state dict of tensors seen one module at a time through
    ``transform`` (a map over leaves, as dequantize_tree is).
    ``LlamaModel.forward(..., weights=this)`` asks for each module's
    parameters where it runs it:
    ``this("layers.3")`` gives layer 3's, with the module's own names;
    ``this("embed_tokens", rows=ids)`` gives the embedding's rows ``ids``
    only, gathered before the transform. The result is dropped once the
    module has run, so at most one module's transformed weights exist at a
    time. ``transform`` sees the module's leaves under their full names
    (``layers.3.self_attn.q_proj.weight``) and must return the same names:
    one that adds, drops or renames a leaf raises, since on the whole tree
    it would act otherwise. A transform that works elementwise on each
    leaf gives the bits of ``transform`` on the whole tree."""

    def __init__(self, params: Dict[str, Any], transform: Callable):
        self.transform = transform
        self.modules: Dict[str, Dict[str, Any]] = {}
        for name, v in params.items():
            parts = name.split(".")
            n = 2 if parts[0] == "layers" else 1
            self.modules.setdefault(".".join(parts[:n]), {})[name] = v

    def __call__(self, module: str, rows: Optional[torch.Tensor] = None
                 ) -> Dict[str, Any]:
        sub = self.modules[module]
        if rows is not None:
            sub = {k: _rows(v, rows) for k, v in sub.items()}
        out = self.transform(sub)
        if set(out) != set(sub):
            raise ValueError(
                f"param_transform on module {module!r} returned leaves "
                f"{sorted(set(out) ^ set(sub))} that differ from its input's:"
                " on a quantized tree the transform runs one module at a "
                "time and must map each leaf to one leaf of the same name")
        cut = len(module) + 1
        return {k[cut:]: v for k, v in out.items()}
