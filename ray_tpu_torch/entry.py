"""Entry points of the port (counterparts of __graft_entry__):

- entry(): the cacheless Llama forward, on one device;
- dryrun_multigpu(n): one sharded training step over an n-rank mesh, in n
  rank processes (``dryrun_multichip``'s training part);
- train_on_ranks(): the sharded train step run for a few steps in one rank
  process per mesh device, with what each rank saw (its losses, shards,
  gradients, kernel launches, peak memory).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch.models.llama import (
    LLAMA_SHARDING,
    LlamaConfig,
    LlamaModel,
    init_params,
    load_params,
    param_shards,
    shard_params,
)
from ray_tpu_torch.parallel.mesh import Mesh, create_mesh
from ray_tpu_torch.utils.device import resolve_device


def entry(device=None):
    """(fn, example_args): a Llama forward with flash attention (K1 on the
    card) on the tiny config, batch 2 × 256 tokens, seeded weights."""
    device = resolve_device(device)
    cfg = dataclasses.replace(LlamaConfig.tiny(), attention_impl="flash")
    model = LlamaModel(cfg, device=device)
    init_params(model, torch.Generator(device=device).manual_seed(0))
    ids = torch.zeros((2, 256), dtype=torch.int32, device=device)
    params = {k: v.detach() for k, v in model.named_parameters()}

    def forward(params, input_ids):
        with torch.no_grad():
            return torch.func.functional_call(model, params, (input_ids,))

    return forward, (params, ids)


def _kernels():
    from ray_tpu_torch.ops import attention as attn

    return {"flash_fwd": attn.flash_fwd_kernel,
            "flash_bwd_dq": attn.flash_bwd_dq_kernel,
            "flash_bwd_dkv": attn.flash_bwd_dkv_kernel}


def train_rank(mesh: Mesh, rank: int, cfg: LlamaConfig, ids: np.ndarray,
               steps: int, lr: float, seed: Optional[int] = None,
               state_dict: Optional[Mapping[str, np.ndarray]] = None,
               param_rules=LLAMA_SHARDING, want_params: bool = False,
               grads_of: Sequence[str] = ()) -> Dict[str, Any]:
    """One rank of ``train_on_ranks`` (run in a rank process of
    parallel/launch.py): the rank's shard of ``cfg`` with f32 parameters,
    AdamW, ``steps`` sharded steps on the global batch ``ids`` (its own
    labels). Weights from ``seed`` (every mesh draws the unsharded model's
    values) or from a full ``state_dict``."""
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step

    dev = mesh.devices[rank]
    model = LlamaModel(cfg, device=dev, param_dtype=torch.float32, mesh=mesh,
                       rank=rank)
    opt = adamw(model.parameters(), lr)
    batch = torch.from_numpy(np.asarray(ids)).long().to(dev)
    gen = (None if seed is None
           else torch.Generator(device=dev).manual_seed(seed))
    state = init_train_state(model, opt, batch, generator=gen, device=dev,
                             mesh=mesh, param_rules=param_rules)
    if state_dict is not None:
        load_params(model, shard_params(model, state_dict))
    step = make_train_step(model, opt, mesh=mesh, param_rules=param_rules)
    kernels = _kernels()
    for k in kernels.values():
        k.launches = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    losses, step_s, grads = [], [], {}
    params = dict(model.named_parameters())
    for i in range(steps):
        t = time.perf_counter()
        state, loss = step(state, batch, batch)
        losses.append(loss.item())  # waits for the step's last kernel
        step_s.append(time.perf_counter() - t)
        if i == 0:
            grads = {n: params[n].grad.float().cpu().numpy()
                     for n in grads_of}
    shards = param_shards(model)
    out = {"rank": rank, "device": str(dev), "losses": losses,
           "step_s": step_s, "grads": grads,
           "index": {n: shards[n][1] for n in grads_of},
           "launches": {n: k.launches for n, k in kernels.items()},
           "heads": model.layers[0].self_attn.heads,
           "kv_heads": model.layers[0].self_attn.kv_heads}
    if want_params:
        out["params"] = {n: p.detach().cpu().numpy()
                         for n, p in params.items()}
        out["index"] = {n: s[1] for n, s in shards.items()}
        out["shapes"] = {n: s[0] for n, s in shards.items()}
    if dev.type == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def train_runs(mesh: Mesh, rank: int,
               runs: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """``train_rank`` for each run in turn (its arguments, with its mesh
    "shape" over ``mesh``'s devices), in one rank process."""
    return [train_rank(create_mesh(run["shape"], devices=mesh.devices), rank,
                       **{k: v for k, v in run.items() if k != "shape"})
            for run in runs]


def train_job(runs: Sequence[Dict[str, Any]], *, device=None,
              backend: Optional[str] = None):
    """Start one rank process per device of the runs' meshes (all of one
    size, all on ``device``, the card unless named: ranks that share a card
    take gloo unless ``backend`` names another), each running
    ``train_runs``; the job's ``results()`` are, per rank, one
    ``train_rank`` result per run."""
    from ray_tpu_torch.parallel.launch import RankJob

    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    sizes = {math.prod(run["shape"].values()) for run in runs}
    if len(sizes) != 1:
        raise ValueError(f"runs over meshes of {sorted(sizes)} ranks")
    n = sizes.pop()
    if backend is None and device.type == "cuda" and n > 1:
        backend = "gloo"  # every rank on this one card: NCCL refuses
    mesh = create_mesh({"data": n}, devices=[device] * n)
    return RankJob("ray_tpu_torch.entry:train_runs", mesh,
                   {"runs": list(runs)}, backend)


def train_on_ranks(shape: Mapping[str, int], cfg: LlamaConfig,
                   ids: np.ndarray, steps: int, lr: float, *,
                   device=None, backend: Optional[str] = None,
                   timeout: Optional[float] = None,
                   **kwargs) -> List[Dict[str, Any]]:
    """``steps`` sharded train steps of ``cfg`` over a mesh of ``shape``
    (``train_job``); each rank's ``train_rank`` result, in rank order.
    ``kwargs`` go to ``train_rank``."""
    from ray_tpu_torch.parallel.launch import TIMEOUT_S

    run = dict(kwargs, shape=dict(shape), cfg=cfg, ids=np.asarray(ids),
               steps=steps, lr=lr)
    job = train_job([run], device=device, backend=backend)
    return [r[0] for r in job.results(timeout or TIMEOUT_S)]


def full_params(results: Sequence[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """The unsharded parameters from every rank's ``train_rank(...,
    want_params=True)`` result."""
    out = {}
    for res in results:
        for n, part in res["params"].items():
            if n not in out:
                out[n] = np.zeros(res["shapes"][n], part.dtype)
            out[n][res["index"][n]] = part
    return out


def mesh_shape_for(n: int) -> Dict[str, int]:
    """``__graft_entry__._mesh_shape_for``'s factoring of n devices without
    its "seq" axis (ring attention is not ported yet): "tensor" 2, then
    "fsdp" 2, the rest on "data"."""
    shape = {}
    rem = n
    for axis in ("tensor", "fsdp"):
        if rem % 2 == 0:
            shape[axis] = 2
            rem //= 2
    if rem > 1:
        shape["data"] = rem
    return shape


def dryrun_multigpu(n: int, device=None) -> float:
    """One sharded training step over an n-rank mesh (``mesh_shape_for``),
    each rank a process on ``device`` (the card unless named): the tiny
    config, a batch of max(4, 2n) × 128 seeded ids, AdamW at 1e-3, weights
    by LLAMA_SHARDING. Raises unless the loss is finite; returns it."""
    cfg = LlamaConfig.tiny()
    shape = mesh_shape_for(n)
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                            (max(4, 2 * n), 128))
    losses = [r["losses"][0] for r in train_on_ranks(
        shape, cfg, ids, 1, 1e-3, device=device, seed=0)]
    loss = losses[0]
    if not (math.isfinite(loss) and loss < 1e9 and len(set(losses)) == 1):
        raise RuntimeError(f"dryrun_multigpu({n}): bad losses {losses}")
    print(f"dryrun_multigpu({n}): mesh={shape} loss={loss:.4f}")
    return loss
