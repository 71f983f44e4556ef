"""Training core: the single-device train step for the port's models.

Port of ray_tpu/train/step.py. The JAX step is a pure jitted function of
(params, opt_state); here the state holds the model and its optimizer,
which update in place, and PyTorch runs the step eagerly. As there, the
model computes in ``cfg.dtype`` (bf16) over f32 parameters
(``LlamaModel(..., param_dtype=torch.float32)``) and the loss is taken in
f32. The sharded step (``mesh=``/``param_rules=``) belongs to the
``parallel/`` slice and raises until it is ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models.llama import init_params
from ray_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class TrainState:
    """The step count, the model (its parameters) and the optimizer (its
    state: what optax keeps in ``opt_state``)."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy in f32. logits [B,S,V], labels
    [B,S]; with ``mask`` [B,S] the mean is over the unmasked positions."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels[..., None].long())[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def adamw(params: Iterable[torch.Tensor], lr: float, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> torch.optim.AdamW:
    """AdamW with optax.adamw's defaults, decay applied to every parameter
    as optax does without a mask (torch's own default decay is 1e-2)."""
    return torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


def _no_mesh(mesh, param_rules) -> None:
    if mesh is not None or param_rules is not None:
        raise NotImplementedError(
            "sharded training (mesh=/param_rules=) is not ported yet (the "
            "parallel/ slice)")


def make_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    *,
    mesh=None,
    param_rules=None,
) -> Callable[[TrainState, torch.Tensor, torch.Tensor],
              Tuple[TrainState, torch.Tensor]]:
    """A (state, input_ids, labels) -> (state, loss) step for ``model`` and
    ``optimizer``: forward, next-token loss (logits[:, :-1] against
    labels[:, 1:]), backward, one optimizer step. The state is updated in
    place and returned; the loss is detached and stays on the device."""
    _no_mesh(mesh, param_rules)

    def step(state: TrainState, input_ids: torch.Tensor,
             labels: torch.Tensor) -> Tuple[TrainState, torch.Tensor]:
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the state holds another model or optimizer "
                             "than this step was made for")
        optimizer.zero_grad(set_to_none=True)
        logits = model(input_ids)
        loss = cross_entropy_loss(logits[:, :-1], labels[:, 1:])
        loss.backward()
        optimizer.step()
        state.step += 1
        return state, loss.detach()

    return step


def init_train_state(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    sample_input: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    device=None,
    mesh=None,
    param_rules=None,
) -> TrainState:
    """The state at step 0. With ``generator`` the model's weights are
    drawn from it (``init_params``); otherwise they stay as they are.
    ``device`` is where the state must live (the card unless named): a
    model elsewhere, an optimizer over other tensors, or a ``sample_input``
    that is not a [B, S] batch of token ids raises."""
    _no_mesh(mesh, param_rules)
    device = resolve_device(device)
    params = list(model.parameters())
    if any(p.device.type != device.type for p in params):
        raise ValueError(f"the model's parameters are not on {device}")
    owned = {id(p) for p in params}
    if any(id(p) not in owned for grp in optimizer.param_groups
           for p in grp["params"]):
        raise ValueError("the optimizer holds tensors that are not the "
                         "model's parameters")
    if sample_input.dim() != 2 or sample_input.dtype.is_floating_point:
        raise ValueError(f"sample_input must be [B, S] token ids, got "
                         f"{sample_input.dtype} {tuple(sample_input.shape)}")
    if generator is not None:
        init_params(model, generator)
    return TrainState(0, model, optimizer)
