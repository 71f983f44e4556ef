"""Weights between the flax Llama (ray_tpu/models/llama.py) and the PyTorch
port (ray_tpu_torch/models/llama.py). numpy only.

flax layouts:
- ``DenseGeneral`` q/k/v kernels are [hidden, heads, head_dim];
- ``o_proj`` is [heads, head_dim, hidden];
- ``Dense`` kernels are [in, out];
- ``Embed`` is [vocab, hidden];
- RMSNorm ``scale`` is [hidden].
PyTorch ``Linear`` weights are [out, in].
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

_MLP = ("gate_proj", "up_proj", "down_proj")
_NORMS = ("input_layernorm", "post_attention_layernorm")


def _num_layers(flax_params) -> int:
    n = 0
    while f"layers_{n}" in flax_params:
        n += 1
    return n


def convert_params(flax_params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Nested flax params (arrays as numpy) -> a flat PyTorch state dict of
    numpy arrays."""
    a = np.asarray
    out = {"embed_tokens.weight": a(flax_params["embed_tokens"]["embedding"])}
    for i in range(_num_layers(flax_params)):
        layer = flax_params[f"layers_{i}"]
        pre = f"layers.{i}"
        attn = layer["self_attn"]
        for name in ("q_proj", "k_proj", "v_proj"):
            kern = a(attn[name]["kernel"])  # [hidden, heads, head_dim]
            out[f"{pre}.self_attn.{name}.weight"] = kern.reshape(
                kern.shape[0], -1).T
        kern = a(attn["o_proj"]["kernel"])  # [heads, head_dim, hidden]
        out[f"{pre}.self_attn.o_proj.weight"] = kern.reshape(
            -1, kern.shape[-1]).T
        for name in _MLP:
            out[f"{pre}.mlp.{name}.weight"] = a(layer["mlp"][name]["kernel"]).T
        for name in _NORMS:
            out[f"{pre}.{name}.weight"] = a(layer[name]["scale"])
    out["norm.weight"] = a(flax_params["norm"]["scale"])
    out["lm_head.weight"] = a(flax_params["lm_head"]["kernel"]).T
    return {k: np.ascontiguousarray(v) for k, v in out.items()}


def unconvert_params(state_dict: Dict[str, Any], num_heads: int,
                     num_kv_heads: int, head_dim: int) -> Dict[str, Any]:
    """The inverse of ``convert_params``: a state dict (numpy arrays) ->
    nested flax params."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    n_layers = 1 + max(int(k.split(".")[1]) for k in sd
                       if k.startswith("layers."))
    out: Dict[str, Any] = {
        "embed_tokens": {"embedding": sd["embed_tokens.weight"]},
        "norm": {"scale": sd["norm.weight"]},
        "lm_head": {"kernel": sd["lm_head.weight"].T},
    }
    heads = {"q_proj": num_heads, "k_proj": num_kv_heads,
             "v_proj": num_kv_heads}
    for i in range(n_layers):
        pre = f"layers.{i}"
        attn = {}
        for name, h in heads.items():
            w = sd[f"{pre}.self_attn.{name}.weight"]  # [h*d, hidden]
            attn[name] = {"kernel": w.T.reshape(w.shape[1], h, head_dim)}
        w = sd[f"{pre}.self_attn.o_proj.weight"]  # [hidden, h*d]
        attn["o_proj"] = {"kernel": w.T.reshape(num_heads, head_dim,
                                                w.shape[0])}
        layer = {"self_attn": attn,
                 "mlp": {name: {"kernel": sd[f"{pre}.mlp.{name}.weight"].T}
                         for name in _MLP}}
        for name in _NORMS:
            layer[name] = {"scale": sd[f"{pre}.{name}.weight"]}
        out[f"layers_{i}"] = layer
    return out
