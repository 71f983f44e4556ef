"""The collectives of one rank along a model-parallel mesh axis, over the
ranks of its line along that axis (``mesh.axis_group``; the default group
when the mesh has no other axis): ``AxisParallel``, of which
``TensorParallel`` (megatron-style TP over "tensor") and ``ExpertParallel``
(parallel/ep.py, over "expert") are the two.

Which part of a dim a rank holds follows the sharding rules: a dim of n
units splits into ``size`` equal parts when ``size`` divides n and is
replicated otherwise, as ``sharding._drop_indivisible`` decides.

Partial sums (row-parallel products, the vocab-parallel embedding) are
added in float32 on every backend: each rank's partial is cast to float32,
all-reduced, and cast back to the activation dtype. So a bf16 model rounds
each rank's partial to bf16 once and the sum once.

Each collective has its gradient rule (megatron's f and g), so a training
step differentiates through them; without grad they compute what they
compute with it:
- ``all_reduce`` (g): sum forward, identity backward;
- ``copy_in`` (f): identity forward, the gradient summed (in float32)
  backward; it goes in front of a column-parallel product whose input every
  rank holds whole;
- ``gather_last``: the ranks' parts concatenated forward, this rank's part
  of the gradient backward (every rank computes the same loss from the
  gathered whole).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import Mesh, axis_group


def sum_f32(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of every rank's ``x`` over ``group``, added in float32, in x's
    dtype."""
    y = x.to(torch.float32, copy=True)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return sum_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def replicated_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of every rank's ``x`` over ``group``, added in float32, in x's
    dtype; the gradient passes through unchanged (every rank computes the
    same loss from the replicated sum)."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return sum_f32(x, group)
    return _Sum.apply(x, group)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return sum_f32(g, ctx.group), None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank):
        ctx.part = (x.shape[-1], rank)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        n, rank = ctx.part
        return g[..., rank * n:(rank + 1) * n], None, None, None


@dataclasses.dataclass(frozen=True)
class AxisParallel:
    size: int
    rank: int  # this rank's coordinate on the axis
    mesh: Mesh
    axis: ClassVar[str]

    @property
    def group(self):
        return axis_group(self.mesh, self.axis)

    def part(self, n: int) -> Tuple[int, int]:
        """[lo, hi) of the n units of a dim that this rank holds: its
        1/size of them, or all n when size does not divide n."""
        if n % self.size:
            return 0, n
        step = n // self.size
        return self.rank * step, (self.rank + 1) * step

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of every rank's ``x``, added in float32, in x's dtype; the
        gradient passes through unchanged."""
        return replicated_sum(x, self.group)

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` itself; its gradient is the sum of every rank's."""
        if not (torch.is_grad_enabled() and x.requires_grad):
            return x
        return _CopyIn.apply(x, self.group)


@dataclasses.dataclass(frozen=True)
class TensorParallel(AxisParallel):
    axis: ClassVar[str] = "tensor"

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along the last dim, in rank
        order; the gradient keeps this rank's part."""
        return _GatherLast.apply(x, self.group, self.size, self.rank)
