"""Device mesh. Port of ray_tpu/parallel/mesh.py.

A ``Mesh`` is a plain object: the size of each canonical axis and one
``torch.device`` per rank, rank r at the row-major position r of the axis
sizes (the outer axes vary slowest, as in the JAX mesh's device array).
Nothing here starts a process; the process group is made inside the rank
processes (llm/_internal/tp.py, parallel/launch.py), and ``axis_group``
makes, inside a rank, the subgroup of the ranks on its line along an axis.

Canonical axes (order matters, outer to inner):
    "data"    pure data parallelism
    "fsdp"    ZeRO-style parameter/optimizer sharding
    "stage"   pipeline stages
    "expert"  MoE expert parallelism
    "seq"     sequence/context parallelism (ring attention)
    "tensor"  tensor parallelism (megatron-style)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXIS_ORDER = ("data", "fsdp", "stage", "expert", "seq", "tensor")


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]  # one size per axis name
    devices: Tuple[torch.device, ...]  # one per rank, row-major over shape

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis_size(self, name: str) -> int:
        return mesh_shape(self).get(name, 1)

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank ``rank``'s index along each axis."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        return dict(zip(self.axis_names, _unravel(rank, self.shape)))


def _unravel(rank: int, shape: Sequence[int]) -> List[int]:
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return out[::-1]


def create_mesh(
    shape: Optional[Dict[str, int]] = None,
    *,
    devices: Optional[Sequence[torch.device]] = None,
    allow_split_physical_axes: bool = True,
) -> Mesh:
    """Build a Mesh from an axis-size dict, e.g. {"data": 2, "tensor": 4}.

    Unspecified axes get size 1; a single -1 axis absorbs the remaining
    devices. ``devices`` defaults to every CUDA device (none raises: the
    port never falls back to the CPU on its own); a device may repeat, e.g.
    ranks that share one card. ``allow_split_physical_axes`` is accepted
    for the reference's signature: devices are laid out in the order given.
    """
    del allow_split_physical_axes
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass devices= (e.g. CPU devices) "
                "to build a mesh without one")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    shape = dict(shape or {})
    for ax in list(shape):
        if ax not in AXIS_ORDER:
            raise ValueError(f"unknown mesh axis {ax!r}; use {AXIS_ORDER}")
    sizes = {ax: shape.get(ax, 1) for ax in AXIS_ORDER}
    wildcard = [ax for ax, v in sizes.items() if v == -1]
    if len(wildcard) > 1:
        raise ValueError("at most one axis may be -1")
    fixed = math.prod(v for v in sizes.values() if v != -1)
    if wildcard:
        if n % fixed != 0:
            raise ValueError(f"{n} devices not divisible by {fixed}")
        sizes[wildcard[0]] = n // fixed
    elif fixed != n:
        raise ValueError(
            f"mesh shape {sizes} needs {fixed} devices but {n} are available")
    return Mesh(tuple(AXIS_ORDER), tuple(sizes[ax] for ax in AXIS_ORDER),
                tuple(devices))


def single_device_mesh() -> Mesh:
    return create_mesh({})


def mesh_shape(mesh: Mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def dp_axes(mesh: Mesh) -> List[str]:
    """Axes over which gradients are summed (data + fsdp)."""
    return [ax for ax in ("data", "fsdp") if mesh_shape(mesh).get(ax, 1) >= 1]


def axis_ranks(mesh: Mesh, axis: str, rank: int) -> List[int]:
    """The ranks on ``rank``'s line along ``axis`` (every other axis at
    ``rank``'s coordinate), in order of their coordinate on ``axis``."""
    names = list(mesh.axis_names)
    i = names.index(axis)
    coords = _unravel(rank, mesh.shape)
    out = []
    for c in range(mesh.shape[i]):
        coords[i] = c
        r = 0
        for n, x in zip(mesh.shape, coords):
            r = r * n + x
        out.append(r)
    return out


# Per mesh: the default group they were made under and this process's
# group along each axis. dist.new_group is collective over the world, so
# every rank makes every line's group, in the same order, once.
_groups: Dict[Mesh, Tuple[object, Dict[str, Optional[object]]]] = {}


def axis_group(mesh: Mesh, axis: str):
    """This rank's process group along ``axis`` of ``mesh``, for the
    ``group=`` of a collective: None (the default group) when the line is
    the whole world, as on a mesh of one axis.

    The first call for a mesh makes the groups of every axis above size 1
    and must come at the same point on every rank; later calls read them.
    The mesh must span the process group (``mesh.size`` ranks)."""
    world = dist.group.WORLD
    made = _groups.get(mesh)
    if made is None or made[0] is not world:
        if dist.get_world_size() != mesh.size:
            raise ValueError(f"a mesh of {mesh.size} ranks in a process "
                             f"group of {dist.get_world_size()}")
        rank = dist.get_rank()
        mine: Dict[str, Optional[object]] = {}
        for ax, n in zip(mesh.axis_names, mesh.shape):
            if n == 1:
                continue
            if n == mesh.size:
                mine[ax] = None
                continue
            lines = sorted({tuple(axis_ranks(mesh, ax, r))
                            for r in range(mesh.size)})
            for line in lines:
                g = dist.new_group(list(line))
                if rank in line:
                    mine[ax] = g
        made = _groups[mesh] = (world, mine)
    if mesh.axis_size(axis) == 1:
        raise ValueError(f"axis {axis!r} of the mesh has size 1")
    return made[1][axis]
