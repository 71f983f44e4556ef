"""The collectives of one tensor-parallel rank (megatron-style TP over the
mesh's "tensor" axis), over the rank process's default process group.

Which part of a dim a rank holds follows the sharding rules: a dim of n
units splits into ``size`` equal parts when ``size`` divides n and is
replicated otherwise, as ``sharding._drop_indivisible`` decides.

Partial sums (row-parallel products, the vocab-parallel embedding) are
added in float32 on every backend: each rank's partial is cast to float32,
all-reduced, and cast back to the activation dtype. So a bf16 model rounds
each rank's partial to bf16 once and the sum once.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    size: int
    rank: int

    def part(self, n: int) -> Tuple[int, int]:
        """[lo, hi) of the n units of a dim that this rank holds: its
        1/size of them, or all n when size does not divide n."""
        if n % self.size:
            return 0, n
        step = n // self.size
        return self.rank * step, (self.rank + 1) * step

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of every rank's ``x``, added in float32, in x's dtype."""
        y = x.to(torch.float32, copy=True)
        dist.all_reduce(y)
        return y.to(x.dtype)

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along the last dim, in rank
        order."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x)
        return torch.cat(parts, dim=-1)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank, in place."""
        dist.broadcast(x, src)
        return x
