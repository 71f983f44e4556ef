"""Entry points of the port (counterparts of __graft_entry__):

- entry(): the cacheless Llama forward, on one device;
- dryrun_multigpu(n): one sharded training step over an n-rank mesh (ring
  attention over its "seq" axis), then a pipeline over a "stage" axis and
  a step of the MoE Llama over an "expert" axis, in n rank processes
  (``dryrun_multichip``'s training, PP and EP parts);
- train_on_ranks(): the sharded train step run for a few steps in one rank
  process per mesh device, with what each rank saw (its losses, shards,
  gradients, kernel launches, peak memory allocated and reserved);
- train_job(): rank processes that run several such runs in turn, each a
  train step (``train_rank``), ring attention (``ring_rank``) or a
  pipeline (``pipeline_rank``) over its own mesh;
- checkpoint_round_trip(): a train state saved, restored into a fresh one
  and stepped beside it (``train_rank(checkpoint=)``).
"""

from __future__ import annotations

import dataclasses
import math
import os
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


def _rank_state(mesh: Mesh, rank: int, cfg: LlamaConfig,
                batch: torch.Tensor, lr: float, seed: Optional[int],
                state_dict: Optional[Mapping[str, np.ndarray]],
                param_rules):
    """(state, step): the rank's shard of ``cfg`` with f32 parameters and
    AdamW at ``lr``, weights from ``seed`` or a full ``state_dict``."""
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step

    dev = mesh.devices[rank]
    model = LlamaModel(cfg, device=dev, param_dtype=torch.float32, mesh=mesh,
                       rank=rank)
    opt = adamw(model.parameters(), lr)
    gen = (None if seed is None
           else torch.Generator(device=dev).manual_seed(seed))
    state = init_train_state(model, opt, batch, generator=gen, device=dev,
                             mesh=mesh, param_rules=param_rules)
    if state_dict is not None:
        load_params(model, shard_params(model, state_dict))
    return state, make_train_step(model, opt, mesh=mesh,
                                  param_rules=param_rules)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _same_state(a, b) -> bool:
    """Every parameter and optimizer moment of two train states equal, bit
    for bit, and the same step."""
    pa, pb = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    if a.step != b.step or pa.keys() != pb.keys():
        return False
    for n in pa:
        sa, sb = a.optimizer.state[pa[n]], b.optimizer.state[pb[n]]
        if not torch.equal(pa[n], pb[n]) or sa.keys() != sb.keys():
            return False
        if not all(torch.equal(torch.as_tensor(sa[k]), torch.as_tensor(sb[k]))
                   for k in sa):
            return False
    return True


def checkpoint_round_trip(state, step, make_state, batch: torch.Tensor,
                          path: str) -> Dict[str, Any]:
    """Save ``state`` into ``path`` (``save_pytree``), restore it into a
    fresh state from ``make_state()`` (``load_pytree(target=)``), then
    take one more ``step`` on each (the fresh one through its own step).
    Returns both losses, whether every parameter and moment is then equal,
    the seconds of the save and of the load, the bytes of this rank's file
    and the K1-K3 launches of the two steps."""
    from ray_tpu_torch.train import load_pytree, save_pytree
    from ray_tpu_torch.train._checkpoint import state_file

    dev = batch.device
    _sync(dev)
    t = time.perf_counter()
    ckpt = save_pytree(state, path)
    _sync(dev)
    save_s = time.perf_counter() - t
    nbytes = os.path.getsize(os.path.join(path, state_file(state)))
    restored, restored_step = make_state()
    _sync(dev)
    t = time.perf_counter()
    load_pytree(ckpt, target=restored)
    _sync(dev)
    load_s = time.perf_counter() - t
    kernels = _kernels()
    before = {n: k.launches for n, k in kernels.items()}
    restored_at = restored.step
    _, loss = step(state, batch, batch)
    _, restored_loss = restored_step(restored, batch, batch)
    return {"loss": loss.item(), "restored_loss": restored_loss.item(),
            "restored_at_step": restored_at,
            "equal": bool(loss.item() == restored_loss.item()
                          and _same_state(state, restored)),
            "save_s": save_s, "load_s": load_s, "bytes": nbytes,
            "launches": {n: k.launches - before[n]
                         for n, k in kernels.items()}}


def train_rank(mesh: Mesh, rank: int, cfg: LlamaConfig, ids: np.ndarray,
               steps: int, lr: float, seed: Optional[int] = None,
               state_dict: Optional[Mapping[str, np.ndarray]] = None,
               param_rules=LLAMA_SHARDING, want_params: bool = False,
               grads_of: Sequence[str] = (),
               checkpoint: Optional[str] = None) -> Dict[str, Any]:
    """One rank of ``train_on_ranks`` (run in a rank process of
    parallel/launch.py, or in this one for a mesh of one device): the
    rank's shard of ``cfg`` with f32 parameters, AdamW, ``steps`` sharded
    steps on the global batch ``ids`` (its own labels). Weights from
    ``seed`` (every mesh draws the unsharded model's values) or from a full
    ``state_dict``. With ``checkpoint`` (a directory, the same on every
    rank): then ``checkpoint_round_trip`` into a state drawn from another
    seed, its result under "checkpoint"."""
    dev = mesh.devices[rank]
    batch = torch.from_numpy(np.asarray(ids)).long().to(dev)
    state, step = _rank_state(mesh, rank, cfg, batch, lr, seed, state_dict,
                              param_rules)
    model = state.model
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
    launches = {n: k.launches for n, k in kernels.items()}
    shards = param_shards(model)
    out = {"rank": rank, "device": str(dev), "losses": losses,
           "step_s": step_s, "grads": grads,
           "index": {n: shards[n][1] for n in grads_of},
           "launches": launches,
           "heads": model.layers[0].self_attn.heads,
           "kv_heads": model.layers[0].self_attn.kv_heads,
           "experts": getattr(model.layers[0].mlp, "experts", None)}
    if checkpoint is not None:
        out["checkpoint"] = checkpoint_round_trip(
            state, step, lambda: _rank_state(
                mesh, rank, cfg, batch, lr, (seed or 0) + 1, None,
                param_rules), batch, checkpoint)
    if want_params:
        out["params"] = {n: p.detach().cpu().numpy()
                         for n, p in params.items()}
        out["index"] = {n: s[1] for n, s in shards.items()}
        out["shapes"] = {n: s[0] for n, s in shards.items()}
    if dev.type == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        out["peak_reserved_gb"] = torch.cuda.max_memory_reserved(dev) / 1e9
    return out


def _tensor(x, dev) -> torch.Tensor:
    """A numpy array (or a tensor) as a tensor on ``dev``."""
    t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
    return t.to(dev)


def ring_inputs(b: int, s: int, h: int, hk: int, d: int, dtype, seed: int,
                device) -> List[torch.Tensor]:
    """Global q [b, s, h, d], k and v [b, s, hk, d], standard normal in
    ``dtype``, drawn from ``seed`` on ``device`` (each rank of a ring run
    draws the same and keeps its block)."""
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=device,
                        dtype=torch.float32).to(dtype)
            for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d))]


def _timed_ms(fn, dev, reps: int) -> List[float]:
    """Host milliseconds of ``fn()`` after a barrier over every rank,
    ``reps`` times, each ended by a device sync."""
    import torch.distributed as dist

    out = []
    for _ in range(reps):
        dist.barrier()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out.append((time.perf_counter() - t) * 1e3)
    return out


def ring_rank(mesh: Mesh, rank: int, qkv=None, spec=None, causal=True,
              reps: int = 0) -> Dict[str, Any]:
    """One rank of a ring-attention run: ``ring_attention`` on the rank's
    blocks (``block_index``) of the global q, k, v, given as ``qkv``
    (three arrays) or drawn by ``ring_inputs(**spec)``, and the gradients
    of ``out.float().sum()`` with respect to its q, k and v blocks. Returns
    them as float32 numpy arrays with the rank's index into the global q
    (``index``) and k/v (``kv_index``); with ``reps``, the milliseconds of
    the forward and of forward and backward, every rank timing together."""
    from ray_tpu_torch.parallel.ring import block_index, ring_attention

    dev = mesh.devices[rank]
    if qkv is None:
        qkv = ring_inputs(**spec, device=dev)
    full = [_tensor(x, dev) for x in qkv]
    index = [block_index(x.shape, mesh, rank) for x in full]
    q, k, v = [x[i].clone().requires_grad_() for x, i in zip(full, index)]

    def ring():
        return ring_attention(q, k, v, mesh=mesh, causal=causal, rank=rank)

    out = ring()
    grads = torch.autograd.grad(out.float().sum(), (q, k, v))
    res = {"rank": rank, "out": _numpy(out),
           **{f"d{n}": _numpy(g) for n, g in zip("qkv", grads)},
           "index": index[0], "kv_index": index[1]}
    if reps:
        def fwd():
            with torch.no_grad():
                ring()

        def fwd_bwd():
            torch.autograd.grad(ring().float().sum(), (q, k, v))

        res["fwd_ms"] = _timed_ms(fwd, dev, reps)
        res["fwd_bwd_ms"] = _timed_ms(fwd_bwd, dev, reps)
    return res


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A float32 numpy copy of a tensor."""
    return t.detach().float().cpu().numpy().copy()


def tanh_stage(params, x):
    """The reference dry run's pipeline stage: tanh(x @ w + b)."""
    w, b = params
    return torch.tanh(x @ w + b)


def pipeline_inputs(S: int, M: int, mb, h: int, seed: int, device
                    ) -> List[torch.Tensor]:
    """Stage weights ws [S, h, h] (std 1/sqrt(h)), biases bs [S, h] (std
    0.1) and microbatches xs [M, *mb, h] (standard normal), f32, drawn from
    ``seed`` on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    mb = (mb,) if isinstance(mb, int) else tuple(mb)
    draw = lambda *shape: torch.randn(shape, generator=g, device=device)
    return [draw(S, h, h) / math.sqrt(h), draw(S, h) * 0.1,
            draw(M, *mb, h)]


def pipeline_rank(mesh: Mesh, rank: int, inputs=None, spec=None,
                  grads: bool = True, reps: int = 0) -> Dict[str, Any]:
    """One rank of a pipeline run: ``pipeline_apply(tanh_stage, (ws, bs),
    xs)`` over the mesh's "stage" axis, on ``inputs`` (ws, bs, xs arrays)
    or ``pipeline_inputs(**spec)``, and with ``grads`` the gradients of
    ``out.sum()``: the rank's stage slice of ws and bs and, on stage 0,
    xs's. Returns the rank's whole output and those as numpy arrays; with
    ``reps``, the milliseconds of the forward, every rank timing
    together."""
    from ray_tpu_torch.parallel.pipeline import pipeline_apply

    dev = mesh.devices[rank]
    if inputs is None:
        inputs = pipeline_inputs(**spec, device=dev)
    ws, bs, xs = [_tensor(x, dev).requires_grad_(grads) for x in inputs]
    out = pipeline_apply(tanh_stage, (ws, bs), xs, mesh=mesh, rank=rank)
    stage = mesh.coords(rank)["stage"]
    res = {"rank": rank, "stage": stage, "out": _numpy(out)}
    if grads:
        dw, db, dx = torch.autograd.grad(out.sum(), (ws, bs, xs))
        res["dw"], res["db"] = _numpy(dw[stage]), _numpy(db[stage])
        res["dx"] = _numpy(dx) if stage == 0 else None
    if reps:
        def fwd():
            with torch.no_grad():
                pipeline_apply(tanh_stage, (ws, bs), xs, mesh=mesh,
                               rank=rank)

        res["fwd_ms"] = _timed_ms(fwd, dev, reps)
    return res


# What a run of train_job runs, by its "fn".
RUNS = {"train": train_rank, "ring": ring_rank, "pipeline": pipeline_rank}


def train_runs(mesh: Mesh, rank: int,
               runs: Sequence[Dict[str, Any]]) -> List[Any]:
    """For each run in turn, in one rank process: ``RUNS[run["fn"]]``
    (``train_rank`` without one) with the run's other arguments, over its
    mesh "shape" on ``mesh``'s devices. Each result (a dict) also holds
    the run's start as a Unix time (``run_at``) and its seconds
    (``run_s``)."""
    out = []
    for run in runs:
        at = time.time()
        t = time.perf_counter()
        res = RUNS[run.get("fn", "train")](
            create_mesh(run["shape"], devices=mesh.devices), rank,
            **{k: v for k, v in run.items() if k not in ("shape", "fn")})
        res.update(run_at=at, run_s=time.perf_counter() - t)
        out.append(res)
    return out


def train_job(runs: Sequence[Dict[str, Any]], *, device=None,
              backend: Optional[str] = None):
    """Start one rank process per device of the runs' meshes (all of one
    size, all on ``device``, the card unless named: ranks that share a card
    take gloo unless ``backend`` names another), each running
    ``train_runs``; the job's ``results()`` are, per rank, one result per
    run (``train_rank``'s, ``ring_rank``'s or ``pipeline_rank``'s)."""
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
    """``__graft_entry__._mesh_shape_for``'s factoring of n devices: "seq"
    2, then "tensor" 2, then "fsdp" 2, as n allows, the rest on "data"."""
    shape = {}
    rem = n
    for axis in ("seq", "tensor", "fsdp"):
        if rem % 2 == 0:
            shape[axis] = 2
            rem //= 2
    if rem > 1:
        shape["data"] = rem
    return shape


def _dryrun_ids(n: int) -> np.ndarray:
    """The dry run's batch: max(4, 2n) × 128 seeded ids of the tiny
    vocabulary."""
    return np.random.default_rng(1).integers(
        0, LlamaConfig.tiny().vocab_size, (max(4, 2 * n), 128))


def dryrun_ep_run(n: int) -> Dict[str, Any]:
    """The EP part of the dry run of an even n, a run of ``train_job``:
    one step of the tiny config with 2 experts (plain attention) over
    {"expert": 2, "data": n/2}, the dry run's batch, AdamW at 1e-3, seed
    0, weights by LLAMA_SHARDING."""
    cfg = dataclasses.replace(LlamaConfig.tiny(), num_experts=2)
    return {"shape": {"expert": 2, "data": n // 2}, "cfg": cfg,
            "ids": _dryrun_ids(n), "steps": 1, "lr": 1e-3, "seed": 0}


def check_loss(what: str, losses: Sequence[float]) -> float:
    """The loss every rank reported; raises unless it is finite and the
    same on every rank."""
    loss = losses[0]
    if not (math.isfinite(loss) and loss < 1e9 and len(set(losses)) == 1):
        raise RuntimeError(f"{what}: bad losses {list(losses)}")
    return loss


def dryrun_multigpu(n: int, device=None) -> float:
    """``dryrun_multichip``'s training, PP and EP parts, each rank a
    process on ``device`` (the card unless named). One sharded training
    step over an n-rank mesh (``mesh_shape_for``; ring attention where its
    "seq" axis is above 1): the tiny config, a batch of max(4, 2n) × 128
    seeded ids, AdamW at 1e-3, weights by LLAMA_SHARDING. Then, for an even
    n, on a rank job of its own, ``pipeline_apply`` of tanh(x @ w + b) over
    {"stage": 2, "data": n/2} (h 16, ws 0.1, bs 0, xs ones [4, 2, 16]) and
    one step of the tiny MoE Llama over {"expert": 2, "data": n/2}
    (``dryrun_ep_run``). Raises unless each loss is finite and the same on
    every rank and the pipeline's output has xs's shape; returns the first
    step's loss."""
    shape = mesh_shape_for(n)
    cfg = dataclasses.replace(
        LlamaConfig.tiny(),
        attention_impl="ring" if shape.get("seq", 1) > 1 else "reference")
    loss = check_loss(f"dryrun_multigpu({n})", [
        r["losses"][0] for r in train_on_ranks(
            shape, cfg, _dryrun_ids(n), 1, 1e-3, device=device, seed=0)])
    print(f"dryrun_multigpu({n}): mesh={shape} loss={loss:.4f}")
    if n % 2 == 0:
        h = 16
        inputs = [np.full((2, h, h), 0.1, np.float32),
                  np.zeros((2, h), np.float32),
                  np.ones((4, 2, h), np.float32)]
        pp = {"stage": 2, "data": n // 2}
        job = train_job([{"fn": "pipeline", "shape": pp, "inputs": inputs,
                          "grads": False}, dryrun_ep_run(n)], device=device)
        res = job.results()
        shapes = {r[0]["out"].shape for r in res}
        if shapes != {inputs[2].shape}:
            raise RuntimeError(f"dryrun_multigpu({n}): pipeline output "
                               f"shapes {shapes}, want {inputs[2].shape}")
        print(f"dryrun_multigpu({n}): PP mesh {{'stage': 2}} ok")
        moe_loss = check_loss(f"dryrun_multigpu({n}) EP",
                              [r[1]["losses"][0] for r in res])
        print(f"dryrun_multigpu({n}): EP mesh {{'expert': 2}} "
              f"moe_loss={moe_loss:.4f}")
    return loss
