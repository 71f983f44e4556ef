"""Training core: the train step for the port's models, on one device or
sharded over a mesh (DP, FSDP, TP, SP and EP).

Port of ray_tpu/train/step.py. The JAX step is a pure jitted function of
(params, opt_state); here the state holds the model and its optimizer,
which update in place, and PyTorch runs the step eagerly. As there, the
model computes in ``cfg.dtype`` (bf16) over f32 parameters
(``LlamaModel(..., param_dtype=torch.float32)``) and the loss is taken in
f32.

Sharded (``mesh=``): the reference jits one SPMD program over global
arrays; the port runs the same step in each of ``mesh.size`` rank
processes, one per mesh device, inside a process group of that size
(parallel/launch.py starts them). Each rank holds its shard of the model
(``LlamaModel(cfg, mesh=mesh)``: its "tensor" part; ``init_train_state``
places its "fsdp" part by ``param_rules``) and a plain AdamW over its
shards, which equals the unsharded update since AdamW is elementwise. The
step takes the global batch and keeps this rank's rows by its ("data",
"fsdp") coordinates, data outer, as the reference shards "batch"; it
returns the global mean loss, the same on every rank.

Over a "seq" axis of n (sequence parallelism, ring attention) the rank
also keeps its block of S/n columns. The reference's loss is the mean over
all B·(S-1) next-token predictions, which cross the blocks' boundaries:
the rank predicts the labels of columns [start+1, end+1) of its rows (the
last block one fewer), takes its NLL sum over the global count
B_local·(S-1), and the seq ranks' sums add up to the rows' mean; the
parameters are replicated over "seq", so their gradients are summed over
it. Ranks along "stage" are replicas here (the reference's model does not
use that axis) and need no reduction.

Ranks along "expert" hold the same rows, as the reference shards "batch"
over ("data", "fsdp") only; they need no reduction either. Each holds its
experts (models/moe.py), whose gradients are its own; every other
gradient is already whole and the same on each of them, since the MoE
layer sums its partial output, its input's gradient and its router's
gradient over the expert group.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models.llama import init_params, place_params
from ray_tpu_torch.parallel.fsdp import fsdp_dim
from ray_tpu_torch.parallel.mesh import Mesh, axis_group
from ray_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class TrainState:
    """The step count, the model (its parameters) and the optimizer (its
    state: what optax keeps in ``opt_state``)."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each position's negative log-likelihood of its label, in f32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[..., None].long())[..., 0]


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy in f32. logits [B,S,V], labels
    [B,S]; with ``mask`` [B,S] the mean is over the unmasked positions."""
    nll = _nll(logits, labels)
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


def _mesh_of(model: nn.Module, mesh: Optional[Mesh]) -> Optional[Mesh]:
    """The mesh a step runs over: None for no mesh or one of a single
    rank; otherwise it must be the model's (built with ``mesh=``)."""
    if mesh is None or mesh.size == 1:
        mesh = None
    have = getattr(model, "mesh", None)
    if have is not None and have.size == 1:
        have = None
    if mesh != have:
        raise ValueError(f"the step's mesh {mesh} is not the model's "
                         f"{have}: build the model with "
                         "LlamaModel(cfg, mesh=mesh)")
    return mesh


def _rows(mesh: Mesh, rank: int, batch: torch.Tensor,
          shift: int = 0) -> torch.Tensor:
    """This rank's block of the global batch: rows block data * fsdp-size +
    fsdp of data-size * fsdp-size equal blocks (the reference's "batch" over
    ("data", "fsdp")), and columns [start + shift, end + shift) of block
    seq of seq-size equal column blocks [start, end), cut at the row's
    end."""
    d, f = mesh.axis_size("data"), mesh.axis_size("fsdp")
    n_seq = mesh.axis_size("seq")
    if batch.shape[0] % (d * f):
        raise ValueError(f"a batch of {batch.shape[0]} rows does not split "
                         f"over data {d} x fsdp {f}")
    if batch.shape[1] % n_seq:
        raise ValueError(f"a sequence of {batch.shape[1]} tokens does not "
                         f"split over seq {n_seq}")
    c = mesh.coords(rank)
    n = batch.shape[0] // (d * f)
    block = c["data"] * f + c["fsdp"]
    w = batch.shape[1] // n_seq
    start = c["seq"] * w + shift
    return batch[block * n:(block + 1) * n, start:start + w]


def _flat_sum(tensors, group) -> None:
    """All-reduce (sum) ``tensors`` in place over ``group``, as one flat
    buffer a dtype."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        i = 0
        for t in ts:
            t.copy_(flat[i:i + t.numel()].view_as(t))
            i += t.numel()


def _reduce_grads(model: nn.Module, mesh: Mesh) -> None:
    """Turn each rank's gradients into its shard of the gradient of the
    global mean loss: every gradient is summed over the seq ranks (each
    differentiated its part of its rows' mean); fsdp-placed parameters
    already hold the sum over the fsdp ranks (the reduce-scatter); every
    gradient is summed over the data ranks, one replicated over fsdp also
    over the fsdp ranks, and all are divided by data x fsdp (the loss is
    the mean of equal local means)."""
    d, f = mesh.axis_size("data"), mesh.axis_size("fsdp")
    for p in model.parameters():
        if p.grad is None:  # unused here, maybe not on another rank
            p.grad = torch.zeros_like(p)
    grads = {n: p.grad for n, p in model.named_parameters()}
    if mesh.axis_size("seq") > 1:
        _flat_sum(grads.values(), axis_group(mesh, "seq"))
    if d > 1:
        _flat_sum(grads.values(), axis_group(mesh, "data"))
    if f > 1:
        _flat_sum([g for n, g in grads.items()
                   if fsdp_dim(model.specs[n]) is None],
                  axis_group(mesh, "fsdp"))
    if d * f > 1:
        for g in grads.values():
            g.div_(d * f)


def _mean_loss(loss: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean of every (data, fsdp) rank's local mean loss, each the sum
    of its seq ranks' parts."""
    d, f = mesh.axis_size("data"), mesh.axis_size("fsdp")
    loss = loss.detach().clone()
    for ax, n in (("seq", mesh.axis_size("seq")), ("data", d), ("fsdp", f)):
        if n > 1:
            dist.all_reduce(loss, group=axis_group(mesh, ax))
    return loss / (d * f)


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
    place and returned; the loss is detached and stays on the device.

    With ``mesh`` (the model's), run in each rank process: the step takes
    the global batch and returns the global mean loss; after backward
    the gradients are reduced over the seq, data and fsdp ranks
    (``_reduce_grads``). ``param_rules`` must place the parameters as
    ``init_train_state`` placed them (checked at the first call)."""
    mesh = _mesh_of(model, mesh)
    checked = []

    def step(state: TrainState, input_ids: torch.Tensor,
             labels: torch.Tensor) -> Tuple[TrainState, torch.Tensor]:
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the state holds another model or optimizer "
                             "than this step was made for")
        seq = mesh is not None and mesh.axis_size("seq") > 1
        if mesh is not None:
            if not checked:
                place_params(model, param_rules)
                checked.append(True)
            count = (input_ids.shape[0] // (mesh.axis_size("data")
                                            * mesh.axis_size("fsdp"))
                     * (input_ids.shape[1] - 1))
            # Over "seq": the labels of this rank's predictions.
            labels = _rows(mesh, model.rank, labels, shift=int(seq))
            input_ids = _rows(mesh, model.rank, input_ids)
        optimizer.zero_grad(set_to_none=True)
        logits = model(input_ids)
        if seq:
            n = labels.shape[1]
            loss = _nll(logits[:, :n], labels).sum() / count
        else:
            loss = cross_entropy_loss(logits[:, :-1], labels[:, 1:])
        # The loss's graph keeps what its backward reads (the f32
        # log-softmax); the logits themselves (B·S·V in cfg.dtype: 1.05 GB
        # at the 8B widths) need not live through the backward.
        del logits
        loss.backward()
        if mesh is not None:
            _reduce_grads(model, mesh)
            loss = _mean_loss(loss, mesh)
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
    that is not a [B, S] batch of token ids raises.

    With ``mesh`` (the model's; run in each rank process) and
    ``param_rules``, the parameters are first placed by the rules: each
    keeps this rank's part of its "fsdp" dim (``place_params``); a
    generator then draws each full parameter and the rank keeps its slice,
    so every mesh holds the unsharded model's values. Without
    ``param_rules`` nothing is placed over fsdp, as the reference then
    replicates the state. ``param_rules`` without a mesh is ignored, as
    there."""
    mesh = _mesh_of(model, mesh)
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
    if mesh is not None:
        if optimizer.state:
            raise ValueError("the optimizer has stepped: place the "
                             "parameters before its first step")
        _rows(mesh, model.rank, sample_input)
        # Every rank, one order.
        for ax in ("data", "fsdp", "expert", "seq", "tensor"):
            if mesh.axis_size(ax) > 1:
                axis_group(mesh, ax)
        place_params(model, param_rules)
    if generator is not None:
        init_params(model, generator)
    return TrainState(0, model, optimizer)
