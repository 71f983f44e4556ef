"""ResNet, the second model family. Port of ray_tpu/models/resnet.py (the
flax model of BASELINE config 5, population-based training of a ResNet).

Inputs are NHWC as in the reference; inside, activations are NCHW views of
channels-last memory (cuDNN's fast layout), so the permute costs no copy.
Parameters are f32 and cast to ``dtype`` at use, as flax's ``param_dtype``
f32 under a compute ``dtype``. Where flax differs from torch's defaults the
port follows flax:
- ``padding="SAME"`` splits an odd pad low ``total // 2`` (the 7x7/2 stem
  on 224 pads (2, 3), a 3x3/2 conv on 112 pads (0, 1)): explicit pads, not
  ``Conv2d(padding=k // 2)``;
- the max pool pads with -inf on the same rule;
- BatchNorm (``BatchNorm`` below) keeps flax's names (``scale``, ``bias``,
  ``mean``, ``var``), its momentum 0.99 on the old value and ε 1e-5, and
  updates ``var`` with the biased batch variance; its statistics and output
  are f32.

``forward(x, train=True)`` returns the logits and the updated batch
statistics (flax's ``mutable=["batch_stats"]``) without writing them;
``update_batch_stats`` writes them. ``forward(x, train=False)`` normalizes
with the running statistics and returns the logits.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.utils.device import resolve_device
from ray_tpu_torch.utils.flax_rules import lecun_normal, same_pads

Stats = Dict[str, torch.Tensor]


def _pads(x: torch.Tensor, k: int, s: int) -> Tuple[int, int, int, int]:
    """F.pad's (w_lo, w_hi, h_lo, h_hi) of flax's SAME for an NCHW x."""
    (hl, hh), (wl, wh) = same_pads(x.shape[2], k, s), same_pads(x.shape[3],
                                                                 k, s)
    return wl, wh, hl, hh


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """flax's ``max_pool(x, (3, 3), (2, 2), "SAME")`` of an NCHW x: pads
    of the SAME rule, filled with -inf."""
    return F.max_pool2d(F.pad(x, _pads(x, 3, 2), value=float("-inf")), 3, 2)


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """x in f32, or as it is if wider (a float64 model stays float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class SameConv2d(nn.Conv2d):
    """A bias-free flax ``nn.Conv`` with ``padding="SAME"``: f32 weight (OIHW)
    cast to the input's dtype. Symmetric pads go to the conv itself, an
    asymmetric one to ``F.pad`` first."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, device):
        super().__init__(cin, cout, k, stride, bias=False, device=device)

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        wl, wh, hl, hh = _pads(x, k, s)
        pad = (hl, wl)
        if (wl, hl) != (wh, hh):
            x, pad = F.pad(x, (wl, wh, hl, hh)), 0
        return F.conv2d(x, self.weight.to(x.dtype), None, s, pad)


class BatchNorm(nn.Module):
    """flax.linen.BatchNorm(dtype=float32) over an NCHW input's channels.
    Training: normalizes with the batch's mean and biased variance (taken
    in f32) and returns the running statistics it would store, ``0.99 *
    old + 0.01 * batch``; eval: normalizes with the running ones."""

    momentum = 0.99
    eps = 1e-5

    def __init__(self, channels: int, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))

    def forward(self, x, train: bool, updates: Dict[nn.Module, Tuple]):
        x = _at_least_f32(x)
        if not train:
            return F.batch_norm(x, self.mean, self.var, self.scale,
                                self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            m = self.momentum
            updates[self] = (m * self.mean + (1 - m) * mean,
                             m * self.var + (1 - m) * var)
        return F.batch_norm(x, None, None, self.scale, self.bias, True, 0.0,
                            self.eps)


class ResidualBlock(nn.Module):
    """Two 3x3 convs with BatchNorm; a 1x1 projection (``proj`` +
    ``bn_proj``) where the residual's shape changes."""

    def __init__(self, cin: int, channels: int, stride: int, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.conv1 = SameConv2d(cin, channels, 3, stride, device)
        self.bn1 = BatchNorm(channels, device)
        self.conv2 = SameConv2d(channels, channels, 3, 1, device)
        self.bn2 = BatchNorm(channels, device)
        if stride != 1 or cin != channels:
            self.proj = SameConv2d(cin, channels, 1, stride, device)
            self.bn_proj = BatchNorm(channels, device)

    def forward(self, x, train, updates):
        dt = self.dtype
        y = torch.relu(self.bn1(self.conv1(x), train, updates).to(dt))
        y = self.bn2(self.conv2(y), train, updates).to(dt)
        residual = x
        if hasattr(self, "proj"):
            residual = self.bn_proj(self.proj(x), train, updates).to(dt)
        return torch.relu(y + residual)


class ResNet(nn.Module):
    """Configurable-depth ResNet of basic blocks (stage_sizes=(2,2,2,2) ≈
    ResNet-18; (3,4,6,3) ≈ ResNet-34's topology). Parameters are created on
    ``device`` (the card unless the caller names one) and drawn by
    ``init_params``."""

    def __init__(self, num_classes: int,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2), width: int = 64,
                 dtype: torch.dtype = torch.bfloat16,
                 device: Optional[torch.device] = None):
        super().__init__()
        device = resolve_device(device)
        self.num_classes = num_classes
        self.stage_sizes = tuple(stage_sizes)
        self.width = width
        self.dtype = dtype
        self.stem = SameConv2d(3, width, 7, 2, device)
        self.stem_bn = BatchNorm(width, device)
        cin = width
        for i, n_blocks in enumerate(self.stage_sizes):
            channels = width * 2 ** i
            for b in range(n_blocks):
                stride = 2 if (b == 0 and i > 0) else 1
                self.add_module(f"stage{i}_block{b}", ResidualBlock(
                    cin, channels, stride, dtype, device))
                cin = channels
        self.classifier = nn.Linear(cin, num_classes, device=device)

    def blocks(self):
        return [getattr(self, f"stage{i}_block{b}")
                for i, n in enumerate(self.stage_sizes) for b in range(n)]

    def init_params(self, generator: torch.Generator) -> None:
        """flax's init: conv and classifier kernels lecun_normal (drawn on
        the CPU from ``generator``, in the order of ``named_parameters``),
        the classifier's bias and BN's shifts 0, BN's scales 1, running
        means 0 and variances 1."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("weight"):
                    p.copy_(lecun_normal(p.shape, generator))
                elif name.endswith("scale"):
                    p.fill_(1.0)
                else:
                    p.zero_()
            for name, b in self.named_buffers():
                b.fill_(1.0 if name.endswith("var") else 0.0)

    def forward(self, x: torch.Tensor, train: bool = True):
        """x: [B, H, W, 3] (NHWC). Training: (logits [B, classes] f32,
        the updated batch statistics by state-dict name); eval: logits."""
        updates: Dict[nn.Module, Tuple] = {}
        dt = self.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        x = torch.relu(self.stem_bn(self.stem(x), train, updates).to(dt))
        x = max_pool_same(x)
        for block in self.blocks():
            x = block(x, train, updates)
        # global average pool: an f32 sum, the mean in dtype (jnp.mean)
        x = _at_least_f32(x).mean(dim=(2, 3)).to(dt)
        logits = self.classifier(_at_least_f32(x))
        if not train:
            return logits
        stats: Stats = {}
        for name, m in self.named_modules():
            if m in updates:
                stats[f"{name}.mean"], stats[f"{name}.var"] = updates[m]
        return logits, stats

    def update_batch_stats(self, stats: Stats) -> None:
        """Writes statistics from a training forward into the buffers."""
        buffers = dict(self.named_buffers())
        if set(stats) != set(buffers):
            raise KeyError(f"batch stats {sorted(set(stats) ^ set(buffers))}"
                           " do not match the model's")
        with torch.no_grad():
            for name, v in stats.items():
                buffers[name].copy_(v)

    @staticmethod
    def tiny(num_classes: int = 10, device=None) -> "ResNet":
        """Test-sized: 8-wide, one block per stage, f32."""
        return ResNet(num_classes, (1, 1), 8, torch.float32, device)

    @staticmethod
    def resnet18(num_classes: int = 1000, device=None) -> "ResNet":
        return ResNet(num_classes, (2, 2, 2, 2), device=device)

    @staticmethod
    def resnet50ish(num_classes: int = 1000, device=None) -> "ResNet":
        # Basic-block depth matching ResNet-34/50 compute class.
        return ResNet(num_classes, (3, 4, 6, 3), device=device)
