"""Pipeline parallelism: GPipe-style microbatch pipelining over the mesh's
"stage" axis. Port of ray_tpu/parallel/pipeline.py.

The reference is one ``shard_map`` program scanned over M + S - 1 ticks:
at every tick each stage applies its slice of the stacked stage parameters
to its activation buffer and ``ppermute`` rotates the results one stage
forward. The port runs the same schedule in each rank process (one per
mesh rank; parallel/launch.py), with ring.py's ``ppermute`` between the
ranks of a line along "stage".

Every rank builds the same autograd graph, whatever its stage: stage 0
picks its next microbatch with ``torch.where`` over the rotated activation,
as the reference's ``jnp.where``, so the rotation's backward (a collective)
runs on every rank, in the same order. The output is summed over the stage
ranks with an identity backward (tp.py's all-reduce): every rank holds the
same replicated output and computes the same loss from it, so summing the
cotangent as well would scale every gradient by S.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import Mesh, axis_group
from ray_tpu_torch.parallel.ring import ppermute
from ray_tpu_torch.parallel.tp import replicated_sum


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    microbatches: torch.Tensor,
    *,
    mesh: Mesh,
    axis: str = "stage",
    rank: Optional[int] = None,
) -> torch.Tensor:
    """Apply S stages as a pipeline over M microbatches, in each rank
    process of ``mesh``.

    stage_fn(params_for_one_stage, x) -> y with y.shape == x.shape;
    stage_params: a tree (dicts, lists, tuples) of tensors with a leading
    stage axis of size S, of which the rank uses its own stage's slice;
    microbatches: [M, mb, ...], the same on every rank. Returns [M, mb, ...]
    = stage_{S-1}(...stage_0(x)...) on every rank. ``rank`` defaults to
    this process's rank in its process group."""
    rank = dist.get_rank() if rank is None else rank
    S = mesh.axis_size(axis)
    M = microbatches.shape[0]
    idx = mesh.coords(rank)[axis]
    p = _tree_map(lambda a: a[idx], stage_params)
    first = torch.tensor(idx == 0, device=microbatches.device)
    buf = microbatches[0]
    ys = []
    for t in range(M + S - 1):
        y = stage_fn(p, buf)
        ys.append(y)
        if t == M + S - 2:
            break  # the last tick's rotation feeds no stage
        from_prev = ppermute(y, mesh, axis, rank=rank)
        buf = torch.where(first, microbatches[min(t + 1, M - 1)], from_prev)
    # Stage S-1 produced microbatch m's output at tick m + S - 1.
    outs = torch.stack(ys[S - 1:S - 1 + M])
    outs = outs * float(idx == S - 1)
    if S == 1:
        return outs
    return replicated_sum(outs, axis_group(mesh, axis))
