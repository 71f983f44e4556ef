"""flax's conventions that the port's nets follow, so one init computes the
same thing in both packages: the lecun_normal kernel init of ``nn.Dense``
and ``nn.Conv``, and XLA's ``padding="SAME"``."""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

# flax's lecun_normal: a normal of variance 1/fan_in truncated at two
# standard deviations, its scale raised by the truncation's loss.
_TRUNC_STD = 0.87962566103423978


def lecun_normal(shape: Sequence[int], gen: torch.Generator) -> torch.Tensor:
    """A kernel of torch layout ``shape`` ([out, in] or OIHW, fan-in the
    product of all but the first dim), drawn on the CPU from ``gen``."""
    t = torch.zeros(shape)
    std = math.sqrt(1.0 / math.prod(shape[1:])) / _TRUNC_STD
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)
    return t


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax/XLA padding="SAME" along one dim: out = ceil(size / stride),
    the total pad split low total//2, high the rest (so a stride-2 3x3 conv
    over 10 pads (0, 1), where a symmetric pad of 1 would be wrong)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2
