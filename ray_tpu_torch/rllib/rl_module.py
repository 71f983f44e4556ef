"""RLModule: the neural policy/value container. Port of
ray_tpu/rllib/rl_module.py (reference: rllib/core/rl_module/rl_module.py).

As in the reference, the module is stateless: its nets are templates built
on the meta device, and weights travel as flat dicts of tensors named as
``models/convert.py::convert_rl_params`` names the flax tree
(``Dense_0.weight``, ``Conv_0.bias``). ``torch.func.functional_call``
applies them, so env runners and learners share one module and exchange
only weights. The module's ``device`` is where weights and observations
live; it is resolved once (the card unless the caller names another).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ray_tpu_torch.utils.device import resolve_device
from ray_tpu_torch.utils.flax_rules import lecun_normal, same_pads

Weights = Dict[str, torch.Tensor]


def init_weights(net: nn.Module, gen: torch.Generator,
                 device: torch.device) -> Weights:
    """Weights for ``net``'s parameters as flax initializes Dense and Conv:
    kernels lecun_normal over their fan-in, biases zero. Drawn on the CPU
    from ``gen``, so a seed gives the same weights on every device."""
    return {name: (torch.zeros(p.shape) if name.endswith("bias")
                   else lecun_normal(p.shape, gen)).to(device)
            for name, p in net.named_parameters()}


def clone_weights(weights: Any) -> Any:
    """A copy of a weights dict (nested dicts of tensors; other leaves, such
    as DQN's epsilon, as they are) that shares no storage with it."""
    if isinstance(weights, dict):
        return {k: clone_weights(v) for k, v in weights.items()}
    if isinstance(weights, torch.Tensor):
        return weights.detach().clone()
    return weights


def to_tensor(x, device: torch.device, dtype=np.float32) -> torch.Tensor:
    """A numpy array (or anything np.asarray takes) as a tensor on device."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(device)


def dense_stack(module: nn.Module, widths: Sequence[int]) -> None:
    """Registers ``Dense_i`` Linear layers between consecutive widths, as
    flax auto-names its Dense layers."""
    for i in range(len(widths) - 1):
        module.add_module(f"Dense_{i}", nn.Linear(widths[i], widths[i + 1]))


class ActorCriticNet(nn.Module):
    def __init__(self, obs_dim: int, num_actions: int,
                 hidden: Sequence[int] = (64, 64)):
        super().__init__()
        self.hidden = tuple(hidden)
        n = len(self.hidden)
        widths = (obs_dim,) + self.hidden
        dense_stack(self, widths)
        self.add_module(f"Dense_{n}", nn.Linear(widths[-1], num_actions))
        self.add_module(f"Dense_{n + 1}", nn.Linear(widths[-1], 1))

    def forward(self, obs):
        x = obs
        n = len(self.hidden)
        for i in range(n):
            x = torch.tanh(getattr(self, f"Dense_{i}")(x))
        logits = getattr(self, f"Dense_{n}")(x)
        value = getattr(self, f"Dense_{n + 1}")(x)[..., 0]
        return logits, value


class ConvActorCriticNet(nn.Module):
    """Pixel actor-critic: residual conv trunk over NHWC observations
    (norm-free residual blocks) -> dense head, as the reference's. Convs run
    in NCHW; the trunk's output goes back to NHWC before the flatten, so
    ``Dense_0`` takes the reference's (H, W, C) order and its weight
    converts like any Dense kernel."""

    def __init__(self, obs_shape: Sequence[int], num_actions: int,
                 channels: Sequence[int] = (16, 32, 32),
                 hidden: Sequence[int] = (256,)):
        super().__init__()
        self.channels = tuple(channels)
        self.hidden = tuple(hidden)
        h, w, c = obs_shape
        self._pads = []  # F.pad's (w_lo, w_hi, h_lo, h_hi) a conv, in order

        def conv(cin, cout, k, s):
            i = len(self._pads)
            self.add_module(f"Conv_{i}", nn.Conv2d(cin, cout, k, s))
            nonlocal h, w
            (hl, hh), (wl, wh) = same_pads(h, k, s), same_pads(w, k, s)
            self._pads.append((wl, wh, hl, hh))
            h, w = -(-h // s), -(-w // s)

        conv(c, self.channels[0], 8, 4)
        prev = self.channels[0]
        for ch in self.channels[1:]:
            conv(prev, ch, 3, 2)
            conv(ch, ch, 3, 1)
            conv(ch, ch, 3, 1)
            prev = ch
        n = len(self.hidden)
        widths = (h * w * prev,) + self.hidden
        dense_stack(self, widths)
        self.add_module(f"Dense_{n}", nn.Linear(widths[-1], num_actions))
        self.add_module(f"Dense_{n + 1}", nn.Linear(widths[-1], 1))

    def _conv(self, i, x):
        return getattr(self, f"Conv_{i}")(F.pad(x, self._pads[i]))

    def forward(self, obs):
        # frames in the weights' dtype (the reference casts them to f32)
        x = obs.to(self.Conv_0.weight.dtype).permute(0, 3, 1, 2)
        x = torch.relu(self._conv(0, x))
        for j in range(len(self.channels) - 1):
            down = self._conv(1 + 3 * j, x)
            y = torch.relu(self._conv(2 + 3 * j, down))
            x = torch.relu(down + self._conv(3 + 3 * j, y))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        n = len(self.hidden)
        for i in range(n):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
        logits = getattr(self, f"Dense_{n}")(x)
        value = getattr(self, f"Dense_{n + 1}")(x)[..., 0]
        return logits, value


class RLModule:
    """Discrete-action actor-critic module.

    obs_dim: int for flat observations (MLP trunk) or an (H, W, C) tuple
    for pixels (conv trunk, reference: the Atari CNN stack)."""

    def __init__(self, obs_dim, num_actions: int,
                 hidden: Sequence[int] = (64, 64),
                 conv_channels: Sequence[int] = (16, 32, 32),
                 device: Optional[Union[str, torch.device]] = None):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.conv_channels = tuple(conv_channels)
        self.device = resolve_device(device)
        with torch.device("meta"):
            if isinstance(obs_dim, (tuple, list)):
                self.net = ConvActorCriticNet(tuple(obs_dim), num_actions,
                                              self.conv_channels,
                                              tuple(hidden))
            else:
                self.net = ActorCriticNet(int(obs_dim), num_actions,
                                          tuple(hidden))
        # forward_inference calls, read by the throughput reading
        self.inference_calls = 0

    def init_params(self, seed: int) -> Weights:
        return init_weights(self.net, torch.Generator().manual_seed(seed),
                            self.device)

    def forward_train(self, weights: Weights, obs: torch.Tensor):
        """(logits [B, A], value [B]) of ``weights`` at ``obs``."""
        return functional_call(self.net, weights, (obs,))

    def forward_inference(self, weights: Weights, obs: np.ndarray,
                          generator: torch.Generator
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """A categorical draw from ``generator`` a row: numpy (action
        int32, its log-probability, the value)."""
        self.inference_calls += 1
        with torch.no_grad():
            logits, value = self.forward_train(
                weights, to_tensor(obs, self.device))
            logp_all = F.log_softmax(logits, dim=-1)
            action = torch.multinomial(logp_all.exp(), 1,
                                       generator=generator)
            logp = logp_all.gather(1, action)[:, 0]
        return (action[:, 0].int().cpu().numpy(), logp.cpu().numpy(),
                value.cpu().numpy())

    def __getstate__(self) -> Dict[str, Any]:
        return {"obs_dim": self.obs_dim, "num_actions": self.num_actions,
                "hidden": tuple(self.net.hidden),
                "conv_channels": self.conv_channels,
                "device": str(self.device)}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__init__(**state)
