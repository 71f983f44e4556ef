"""Mixture-of-Experts MLP. Port of ray_tpu/models/moe.py.

A GShard/Switch-style dense-dispatch MoE, top-1 (switch) routing with a
capacity factor, as the reference computes it:
- router logits [B,S,E] in f32 (f32 weights, f32 input), softmax, argmax
  (the first maximum on ties) and the chosen probability as the gate;
- a token's place in its expert's buffer is its prefix count along S;
  tokens past the capacity C = max(1, int(cf * S / E)) are dropped (the
  MLP gives zero for them; the residual carries them on);
- one-hot dispatch [B,S,E,C] scatters tokens into per-expert buffers
  [B,E,C,H] and the gate-weighted combine gathers them back, both einsums
  in f32; the experts are one batched SwiGLU in ``dtype``.

Parameter names and layouts are the flax ones (models/convert.py): the
router is a Linear [E, hidden] kept in f32, the expert kernels
``gate_kernel``/``up_kernel`` [E, hidden, inter] and ``down_kernel``
[E, inter, hidden] are stored in ``param_dtype`` (default ``dtype``) and
cast to ``dtype`` at use. The reference keeps them in f32 and casts at use;
storing them already cast gives the same bits.

Over a mesh (``LlamaModel(cfg, mesh=)``) the layer holds one rank's shard,
as ``LLAMA_SHARDING`` places it: with ``ep`` the experts [e0, e1) of E
(expert parallelism, parallel/ep.py), with ``tp`` each expert's part of
the "mlp" dim (its gate/up columns, its down rows), and over "fsdp" each
expert kernel's "embed_fsdp" dim, gathered at use (``fsdp_dims``, filled
by ``parallel/fsdp.place``). The rank routes every token (the router is
replicated), runs its experts on their buffers, and its partial output is
summed in float32 over the expert and tensor groups.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models.llama import Linear, _AtUse
from ray_tpu_torch.models.quant import as_tensor
from ray_tpu_torch.ops.attention import exp_f32
from ray_tpu_torch.parallel.ep import ExpertParallel
from ray_tpu_torch.parallel.tp import TensorParallel


class MoEMlp(_AtUse, nn.Module):
    """Drop-in replacement for the dense SwiGLU Mlp. Its expert kernels
    come in ``dtype`` at use, gathered over the fsdp ranks where placed
    (``weight_at_use``)."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 num_experts: int, capacity_factor: float = 1.25,
                 dtype=torch.bfloat16, device=None, param_dtype=None,
                 tp: Optional[TensorParallel] = None,
                 ep: Optional[ExpertParallel] = None):
        super().__init__()
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.dtype = self.compute_dtype = dtype
        e, h, i = num_experts, hidden_size, intermediate_size
        e0, e1 = ep.part(e) if ep else (0, e)
        i0, i1 = tp.part(i) if tp else (0, i)
        self.experts = (e0, e1)
        # The axes whose ranks each compute a part of the output: their
        # partials are summed. The router's weight is replicated, but its
        # gradient on a rank only comes through that rank's experts (and
        # "mlp" columns), so it is summed over the same groups; and the
        # input enters through their copy-in before both the router and
        # the dispatch, so the layers below get the whole gradient.
        self.split = tuple(p for p, held, n in ((ep, e1 - e0, e),
                                                 (tp, i1 - i0, i))
                           if held < n)
        self.router = Linear(h, e, torch.float32, torch.float32, device)
        self.router.sum_grad = self.split
        self.fsdp_dims: Dict[str, int] = {}

        def kernel(fan_in, *shape):
            # flax's lecun_normal: variance 1 / fan_in (the middle axis)
            w = torch.empty(shape, dtype=param_dtype or dtype, device=device)
            if not w.is_meta:  # normal_ on meta imports torch._dynamo
                nn.init.normal_(w, 0.0, 1.0 / math.sqrt(fan_in))
            return nn.Parameter(w)

        self.gate_kernel = kernel(h, e1 - e0, h, i1 - i0)
        self.up_kernel = kernel(h, e1 - e0, h, i1 - i0)
        self.down_kernel = kernel(i, e1 - e0, i1 - i0, h)

    def capacity(self, seq_len: int) -> int:
        return max(1, int(self.capacity_factor * seq_len / self.num_experts))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, h = x.shape
        e, dt = self.num_experts, self.dtype
        e0, e1 = self.experts
        cap = self.capacity(s)
        for p in self.split:
            x = p.copy_in(x)
        probs = torch.softmax(self.router(x.float()), dim=-1)  # [B,S,E]
        expert_idx = probs.argmax(dim=-1)  # [B,S]
        gate = probs.gather(-1, expert_idx[..., None])[..., 0]  # [B,S]

        onehot = F.one_hot(expert_idx, e).float()  # [B,S,E]
        # Position of each token within its expert's buffer (per batch row).
        pos = onehot.cumsum(dim=1) * onehot - 1.0
        keep = (pos < cap) & (onehot > 0)
        pos = pos.clamp(0, cap - 1).long()
        dispatch = F.one_hot(pos, cap).float() * keep[..., None].float()
        combine = dispatch * gate[..., None, None]
        # This rank's experts.
        dispatch, combine = dispatch[:, :, e0:e1], combine[:, :, e0:e1]

        # Scatter tokens into expert buffers: [B,E,C,H].
        xin = torch.einsum("bsec,bsh->bech", dispatch, x.float()).to(dt)
        gate_act = torch.einsum("bech,ehi->beci", xin,
                                self.weight_at_use("gate_kernel"))
        up = torch.einsum("bech,ehi->beci", xin,
                          self.weight_at_use("up_kernel"))
        out = torch.einsum("beci,eih->bech", F.silu(gate_act) * up,
                           self.weight_at_use("down_kernel"))
        # Gather back to token order, weighted by the router gate.
        y = torch.einsum("bsec,bech->bsh", combine, out.float())
        for p in self.split:
            y = p.all_reduce(y)
        return y.to(dt)


def moe_reference(x, params, num_experts: int) -> torch.Tensor:
    """Oracle: route each token to its argmax expert with unlimited
    capacity and run that expert's SwiGLU on it, all in f32, expert by
    expert. ``params`` holds the flax names (``{"router": {"kernel": [H,
    E]}, "gate_kernel", "up_kernel", "down_kernel"}``) as arrays or
    tensors; computed on x's device."""
    def f32(a):
        return as_tensor(a, x.device).float()

    xs = f32(x)
    router = f32(params["router"]["kernel"])
    wg, wu, wd = (f32(params[k]) for k in ("gate_kernel", "up_kernel",
                                           "down_kernel"))
    tok = xs.reshape(-1, xs.shape[-1])
    p = torch.softmax(tok @ router, dim=-1)
    ei = p.argmax(dim=-1)
    out = torch.zeros_like(tok)
    for k in range(num_experts):
        sel = (ei == k).nonzero()[:, 0]
        t = tok[sel]
        g = t @ wg[k]
        act = g / (1.0 + exp_f32(-g)) * (t @ wu[k])
        out[sel] = (act @ wd[k]) * p[sel, k][:, None]
    return out.reshape(xs.shape)
