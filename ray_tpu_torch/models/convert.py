"""Weights between the flax Llama (ray_tpu/models/llama.py) and the PyTorch
port (ray_tpu_torch/models/llama.py). numpy only.

flax layouts, and the "kind" of each torch name (``layout_kind``):
- ``DenseGeneral`` q/k/v kernels are [hidden, heads, head_dim] ("qkv");
- ``o_proj`` is [heads, head_dim, hidden] ("o");
- ``Dense`` kernels are [in, out] ("dense": the MLP, ``lm_head`` and the
  MoE router);
- ``Embed`` is [vocab, hidden], RMSNorm ``scale`` is [hidden], and the MoE
  expert kernels ``mlp/{gate,up}_kernel`` [E, hidden, inter] and
  ``mlp/down_kernel`` [E, inter, hidden] keep the flax layout ("same").
PyTorch ``Linear`` weights are [out, in].

A quantized leaf (models/quant.py) is ``{"__q__": int8, "s": scale}``. Its
int8 array converts like the weight. Its flax scale has the shape (1, ..., 1,
last) of the flax layout; the torch scale is that scale laid out the way
the weight is (broadcast over the heads for q/k/v), so ``q * s`` gives the
same elements in both layouts.

The RL networks (ray_tpu/rllib: ``Dense_i``, ``Conv_i`` and SAC's named
``q1_d0`` ... ``q2_out``, nested under ``policy``/``q`` in SAC's trees)
convert by ``convert_rl_params``: a flax path joined by dots names the
torch module, a Dense kernel [in, out] becomes a Linear weight [out, in]
and a Conv kernel HWIO an ``nn.Conv2d`` weight OIHW; biases stay.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np

Path = Tuple[str, ...]


def is_qleaf(x: Any) -> bool:
    return isinstance(x, dict) and "__q__" in x


def flax_path(name: str) -> Path:
    """The flax param path of a torch parameter name, e.g.
    ``layers.3.self_attn.q_proj.weight`` -> ``("layers_3", "self_attn",
    "q_proj", "kernel")``."""
    parts = name.split(".")
    head: Path = ()
    if parts[0] == "layers":
        head, parts = (f"layers_{parts[1]}",), parts[2:]
    if parts[-1] != "weight":  # MoE expert kernels: mlp.gate_kernel
        return head + tuple(parts)
    mod = parts[:-1]
    if mod == ["embed_tokens"]:
        leaf = "embedding"
    elif mod[-1].endswith("norm"):
        leaf = "scale"
    else:
        leaf = "kernel"
    return head + tuple(mod) + (leaf,)


def torch_name(path: Path) -> str:
    """The inverse of ``flax_path``."""
    parts = list(path)
    head = []
    if parts[0].startswith("layers_"):
        head, parts = ["layers", parts[0][len("layers_"):]], parts[1:]
    if parts[-1] in ("kernel", "scale", "embedding"):
        parts[-1] = "weight"
    return ".".join(head + parts)


def layout_kind(name: str) -> str:
    """How the torch parameter ``name`` is laid out against its flax
    kernel: "qkv", "o", "dense" (transposed) or "same"."""
    if name.endswith(("q_proj.weight", "k_proj.weight", "v_proj.weight")):
        return "qkv"
    if name.endswith("o_proj.weight"):
        return "o"
    return "dense" if flax_path(name)[-1] == "kernel" else "same"


def to_torch_layout(kind: str, x):
    """flax layout -> torch layout (numpy arrays or torch tensors)."""
    if kind == "qkv":
        return x.reshape(x.shape[0], -1).T
    if kind == "o":
        return x.reshape(-1, x.shape[-1]).T
    return x.T if kind == "dense" else x


def to_flax_layout(kind: str, x, head_dim: int):
    """torch layout -> flax layout (numpy arrays or torch tensors)."""
    if kind == "qkv":
        return x.T.reshape(x.shape[1], -1, head_dim)
    if kind == "o":
        return x.T.reshape(-1, head_dim, x.shape[0])
    return x.T if kind == "dense" else x


def scale_to_torch(kind: str, s, flax_shape):
    """A flax scale (1, ..., 1, last) -> the torch scale of the weight:
    [heads * head_dim, 1] (one scale a head_dim index, the same for every
    head) for q/k/v, [out, 1] for o_proj and the Dense kernels."""
    if kind == "qkv":
        shape = (1, flax_shape[1], flax_shape[2])
        s = (np.broadcast_to(s, shape) if isinstance(s, np.ndarray)
             else s.expand(shape))
    return to_torch_layout(kind, s)


def scale_to_flax(kind: str, s, head_dim: int):
    """The inverse of ``scale_to_torch`` (numpy). A q/k/v scale must be
    the same for every head."""
    if kind == "qkv":
        per_head = s.reshape(-1, head_dim)
        if not (per_head == per_head[:1]).all():
            raise ValueError("q/k/v scale differs between heads")
        return per_head[:1].reshape(1, 1, head_dim)
    if kind == "o":
        return s.reshape(1, 1, -1)
    return s.T if kind == "dense" else s


def _leaves(tree, prefix: Path = ()) -> Iterator[Tuple[Path, Any]]:
    for k, v in tree.items():
        if isinstance(v, dict) and not is_qleaf(v):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def convert_params(flax_params: Dict[str, Any]) -> Dict[str, Any]:
    """Nested flax params (arrays as numpy), plain or quantized, dense or
    MoE -> a flat PyTorch state dict of numpy arrays (quantized leaves as
    ``{"__q__", "s"}`` dicts of them)."""
    out: Dict[str, Any] = {}
    for path, v in _leaves(flax_params):
        name = torch_name(path)
        kind = layout_kind(name)
        if is_qleaf(v):
            q = np.asarray(v["__q__"])
            out[name] = {
                "__q__": np.ascontiguousarray(to_torch_layout(kind, q)),
                "s": np.ascontiguousarray(
                    scale_to_torch(kind, np.asarray(v["s"]), q.shape))}
        else:
            out[name] = np.ascontiguousarray(
                to_torch_layout(kind, np.asarray(v)))
    return out


def unconvert_params(state_dict: Dict[str, Any], head_dim: int
                     ) -> Dict[str, Any]:
    """The inverse of ``convert_params``: a state dict (numpy arrays,
    quantized leaves as dicts of them) -> nested flax params. The head
    counts follow from the weights' shapes and ``head_dim``."""
    out: Dict[str, Any] = {}
    for name, v in state_dict.items():
        kind = layout_kind(name)
        if is_qleaf(v):
            leaf = {"__q__": to_flax_layout(kind, np.asarray(v["__q__"]),
                                            head_dim),
                    "s": scale_to_flax(kind, np.asarray(v["s"]), head_dim)}
        else:
            leaf = to_flax_layout(kind, np.asarray(v), head_dim)
        *parents, last = flax_path(name)
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


def convert_rl_params(flax_params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A flax RL tree (numpy arrays) -> a flat PyTorch state dict of numpy
    arrays: ``{"Dense_0": {"kernel", "bias"}}`` -> ``Dense_0.weight``,
    ``Dense_0.bias``; ``{"policy": {"Dense_0": ...}}`` ->
    ``policy.Dense_0.weight``."""
    out: Dict[str, np.ndarray] = {}
    for path, v in _leaves(flax_params):
        v = np.asarray(v)
        if path[-1] == "kernel":
            path = path[:-1] + ("weight",)
            v = v.T if v.ndim == 2 else v.transpose(3, 2, 0, 1)
        out[".".join(path)] = np.ascontiguousarray(v)
    return out


def unconvert_rl_params(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of ``convert_rl_params`` (numpy arrays)."""
    out: Dict[str, Any] = {}
    for name, v in state_dict.items():
        v = np.asarray(v)
        *parents, last = name.split(".")
        if last == "weight":
            last = "kernel"
            v = v.T if v.ndim == 2 else v.transpose(2, 3, 1, 0)
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = np.ascontiguousarray(v)
    return out
