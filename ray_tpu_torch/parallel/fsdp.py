"""ZeRO-3 style sharding of parameters over the mesh's "fsdp" axis.

The reference has no such module: there the step is one XLA program, the
parameters carry their ``NamedSharding``, and XLA's partitioner inserts the
all-gather of each weight before its use and the reduce-scatter of its
gradient. The port runs one process per rank, so it does that work here:

- a parameter whose spec names "fsdp" on a dim is stored as this rank's
  part of that dim (``place``);
- at its use, ``FSDP.gather`` casts the part to the compute dtype and
  all-gathers the parts over the fsdp group (the ranks on this rank's line
  along "fsdp");
- in backward, the gradient of the whole is summed over the group and
  scattered (reduce-scatter, in float32): each rank's parameter gets the
  sum over the fsdp ranks of its part's gradient.

Both sides are one ``autograd.Function``. Called inside a region that
``torch.utils.checkpoint(use_reentrant=False)`` recomputes, the gathered
whole is not kept for backward: the recompute gathers it again.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import Mesh, axis_group


def fsdp_dim(spec) -> Optional[int]:
    """The dim of a spec that names the "fsdp" axis (None: replicated over
    it). A dim that names it with another axis is not ported (raises)."""
    for i, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        if "fsdp" in axes:
            if len(axes) > 1:
                raise NotImplementedError(
                    f"a dim sharded over {axes} is not ported; \"fsdp\" "
                    "must shard a dim alone")
            return i
    return None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, part, dim, dtype, group, size):
        ctx.args = (dim, part.dtype, group, size)
        x = part.to(dtype).movedim(dim, 0).contiguous()
        out = x.new_empty((size * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        dim, dtype, group, size = ctx.args
        g = g.to(torch.float32).movedim(dim, 0).contiguous()
        out = g.new_empty((g.shape[0] // size, *g.shape[1:]))
        dist.reduce_scatter_tensor(out, g, group=group)
        return out.movedim(0, dim).to(dtype), None, None, None, None


@dataclasses.dataclass(frozen=True)
class FSDP:
    size: int
    rank: int  # this rank's coordinate on the "fsdp" axis
    mesh: Mesh

    @property
    def group(self):
        return axis_group(self.mesh, "fsdp")

    def gather(self, part: torch.Tensor, dim: int, dtype) -> torch.Tensor:
        """The whole of a parameter stored as its part of ``dim``, in
        ``dtype``; its gradient is reduce-scattered back to the part."""
        return _Gather.apply(part, dim, dtype, self.group, self.size)

    def part(self, n: int):
        """[lo, hi) of the n entries of a dim that this rank holds."""
        if n % self.size:
            raise ValueError(f"a dim of {n} does not split over fsdp "
                             f"{self.size}")
        step = n // self.size
        return self.rank * step, (self.rank + 1) * step


def fsdp_of(mesh: Optional[Mesh], rank: int) -> Optional[FSDP]:
    """The fsdp rank of a mesh (None for no mesh or an fsdp axis of 1)."""
    if mesh is None or mesh.axis_size("fsdp") == 1:
        return None
    return FSDP(mesh.axis_size("fsdp"), mesh.coords(rank)["fsdp"], mesh)


@torch.no_grad()
def place(module: torch.nn.Module, name: str, dim: int,
          fsdp: FSDP) -> None:
    """Keep only this rank's part of ``dim`` of ``module``'s parameter
    ``name`` (the same Parameter object, its data replaced), and have the
    module gather it at use (its ``fsdp`` and ``fsdp_dims``)."""
    p = getattr(module, name)
    lo, hi = fsdp.part(p.shape[dim])
    p.data = p.data.narrow(dim, lo, hi - lo).clone()
    module.fsdp = fsdp
    module.fsdp_dims[name] = dim
