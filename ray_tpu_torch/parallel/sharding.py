"""Logical-axis sharding rules. Port of ray_tpu/parallel/sharding.py.

A spec is a plain tuple in place of a ``PartitionSpec``: one entry per
dimension (trailing replicated dims dropped), each None (replicated), a mesh
axis name, or a tuple of mesh axis names. ``ParamShardingRules`` maps the
port's parameter names (torch ``[out, in]`` layout) to logical axes, and
``shard_state_dict`` cuts rank r's shard out of a full state dict: the same
slices the JAX mesh gives device r of a tree sharded by the same rules.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

from ray_tpu_torch.models.convert import is_qleaf
from ray_tpu_torch.parallel.mesh import Mesh, mesh_shape

# A rule maps a logical axis name to one mesh axis, a tuple of mesh axes, or
# None (replicate).
Rules = Dict[str, Union[str, Tuple[str, ...], None]]
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

# The standard transformer ruleset: batch over (data, fsdp); sequence over
# seq; embed sharded over fsdp for ZeRO; heads/mlp over tensor.
DEFAULT_RULES: Rules = {
    "batch": ("data", "fsdp"),
    "seq": "seq",
    "embed": None,
    "embed_fsdp": "fsdp",
    "vocab": "tensor",
    "heads": "tensor",
    "kv_heads": "tensor",
    "head_dim": None,
    "mlp": "tensor",
    "expert": "expert",
    "stage": "stage",
}


def spec_for(logical_axes: Sequence[Optional[str]],
             rules: Optional[Rules] = None,
             mesh: Optional[Mesh] = None) -> Spec:
    """Spec from logical axis names, dropping axes whose mesh size is 1 (so
    one model definition runs on any mesh)."""
    rules = {**DEFAULT_RULES, **(rules or {})}
    sizes = mesh_shape(mesh) if mesh is not None else None
    out = []
    for name in logical_axes:
        mapped = rules.get(name) if name is not None else None
        if mapped is None:
            out.append(None)
            continue
        axes = (mapped,) if isinstance(mapped, str) else tuple(mapped)
        if sizes is not None:
            axes = tuple(a for a in axes if sizes.get(a, 1) > 1)
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(axes)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _drop_indivisible(spec: Spec, shape: Sequence[int], mesh: Mesh) -> Spec:
    """Replicate any dimension whose size a mapped mesh axis doesn't divide
    (e.g. 2 KV heads on tensor=4): sharding there would be an error, and
    replication is the correct degradation for small dims."""
    sizes = mesh_shape(mesh)
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(entry)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        total = 1
        kept = []
        for a in axes:
            n = sizes.get(a, 1)
            if shape[i] % (total * n) == 0:
                kept.append(a)
                total *= n
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


class ParamShardingRules:
    """Maps parameter names (dot-joined, as ``named_parameters`` gives them)
    to logical axis tuples, one per dim of the torch layout, via ordered
    regex patterns; first match wins.

    ``blocks`` (given per call, since it depends on the model's config)
    maps a logical axis to the size of one unit along a dim that the torch
    layout merges from two flax dims: a q/k/v weight's rows are [heads *
    head_dim], and with ``{"heads": head_dim}`` they split in whole heads,
    the mesh axis dividing the head count as it does in the flax layout."""

    def __init__(self, patterns: Sequence[Tuple[str, Tuple[Optional[str],
                                                            ...]]],
                 rules: Optional[Rules] = None):
        self._patterns = [(re.compile(p), axes) for p, axes in patterns]
        self._rules = rules

    def logical_axes(self, name: str, ndim: int) -> Tuple[Optional[str], ...]:
        for pattern, axes in self._patterns:
            if pattern.search(name):
                if len(axes) != ndim:
                    raise ValueError(
                        f"rule {pattern.pattern!r} has {len(axes)} axes but "
                        f"param {name} has ndim={ndim}")
                return axes
        return (None,) * ndim

    def spec(self, name: str, shape: Sequence[int], mesh: Mesh,
             blocks: Optional[Mapping[str, int]] = None) -> Spec:
        """The spec of one parameter of full shape ``shape``."""
        axes = self.logical_axes(name, len(shape))
        units = []
        for ax, n in zip(axes, shape):
            block = (blocks or {}).get(ax, 1)
            if n % block:
                raise ValueError(f"{name}: dim of {n} is not whole blocks "
                                 f"of {block} ({ax})")
            units.append(n // block)
        return _drop_indivisible(spec_for(axes, self._rules, mesh), units,
                                 mesh)


def keep_axes(spec: Spec, axes: Sequence[str]) -> Spec:
    """``spec`` with only the mesh axes in ``axes`` (the rest replicated),
    trailing replicated dims dropped."""
    out = []
    for entry in spec:
        kept = tuple(a for a in ((entry,) if isinstance(entry, str)
                                 else tuple(entry or ())) if a in axes)
        out.append(None if not kept else kept[0] if len(kept) == 1
                   else kept)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def shard_index(spec: Spec, shape: Sequence[int], mesh: Mesh,
                rank: int) -> Tuple[slice, ...]:
    """Rank ``rank``'s slice of an array of ``shape`` sharded by ``spec``.
    A dim mapped to several mesh axes is cut into their product of blocks,
    the first axis the slowest, as the JAX mesh cuts it."""
    sizes = mesh_shape(mesh)
    coords = mesh.coords(rank)
    index = []
    for i, n in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        if entry is None:
            index.append(slice(None))
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        parts = math.prod(sizes[a] for a in axes)
        block = 0
        for a in axes:
            block = block * sizes[a] + coords[a]
        step = n // parts
        index.append(slice(block * step, (block + 1) * step))
    return tuple(index)


def shard_state_dict(state: Mapping[str, Any], mesh: Mesh, rank: int,
                     rules: ParamShardingRules,
                     blocks: Optional[Mapping[str, int]] = None
                     ) -> Dict[str, Any]:
    """Rank ``rank``'s shard of a full state dict (numpy arrays or tensors;
    views where the slice allows): every leaf cut by its spec under
    ``rules`` on ``mesh``. Quantized leaves are not sharded (raises)."""
    out = {}
    for name, value in state.items():
        if is_qleaf(value):
            raise NotImplementedError(
                f"{name}: sharding a quantized leaf is not ported")
        shape = tuple(value.shape)
        spec = rules.spec(name, shape, mesh, blocks)
        out[name] = value[shard_index(spec, shape, mesh, rank)]
    return out
