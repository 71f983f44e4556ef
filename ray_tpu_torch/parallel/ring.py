"""Ring attention: exact attention over a sequence split across the mesh's
"seq" axis, K/V blocks rotating one rank along the axis a step. Port of
ray_tpu/parallel/ring.py.

The reference runs one ``shard_map`` program: each device holds Q/K/V of
its sequence block and passes its K/V block to its ring neighbour with
``jax.lax.ppermute``. The port runs one process per mesh rank (a process
group of ``mesh.size``; parallel/launch.py), so a rank calls
``ring_attention`` on the blocks it holds and ``ppermute`` moves the K/V
block between the ranks of its line along the axis.

``ppermute`` carries several tensors in one call, as one autograd node
whose backward is the reverse rotation: K and V rotate together, so every
rank runs the backward's collectives in the same order. Its transport is an
``all_gather_into_tensor`` over the axis's process group of which the rank
keeps its neighbour's part; that one route works for CPU tensors and, over
gloo, for CUDA tensors of ranks that share a card
(tests/torch_gloo_cuda_probe.py: gloo's send/recv refuse CUDA tensors).

Causality: with the Q block at ring position r and the K/V block that
started at position j held at step s (j = (r - s) mod n): j < r attends
fully, j == r is causal within the block, j > r is masked. The rank keeps
its own block at step 0, so the running max is finite before any masked
block arrives: a masked block then contributes probabilities exp(-1e30 -
m) = 0. Its update still runs, as in the reference: every block a rank
receives must reach its loss, or the backward of the rotations that brought
it would run on some ranks and not on others. The reference expands GQA
K/V before the ring; the port rotates the blocks at their kv heads and
expands each at its update, the same values with a 1/group of the bytes to
move.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ray_tpu_torch.ops.attention import (
    NEG_INF,
    _gqa_expand,
    block_attn_finish,
    block_attn_init,
    block_attn_update,
)
from ray_tpu_torch.parallel.mesh import Mesh, axis_group

Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]


def _rotate(xs: Sequence[torch.Tensor], mesh: Mesh, axis: str, shift: int,
            rank: int) -> Tuple[torch.Tensor, ...]:
    """Each x of the rank ``shift`` places before this one on its line
    along ``axis`` (cyclic): one all-gather of every x, flattened into one
    buffer, over the axis's group, of which this rank keeps that part."""
    n = mesh.axis_size(axis)
    i = mesh.coords(rank)[axis]
    if len({x.dtype for x in xs}) != 1:
        raise ValueError(f"ppermute carries tensors of one dtype, got "
                         f"{sorted({str(x.dtype) for x in xs})}")
    flat = torch.cat([x.reshape(-1) for x in xs])
    out = flat.new_empty(n * flat.numel())
    # The group's ranks are the line's in the order of their coordinate.
    dist.all_gather_into_tensor(out, flat, group=axis_group(mesh, axis))
    part = out.view(n, -1)[(i - shift) % n]
    got, at = [], 0
    for x in xs:
        got.append(part[at:at + x.numel()].view_as(x))
        at += x.numel()
    return tuple(got)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, shift, rank, *xs):
        ctx.args = (mesh, axis, shift, rank)
        return _rotate(xs, mesh, axis, shift, rank)

    @staticmethod
    def backward(ctx, *gs):
        mesh, axis, shift, rank = ctx.args
        return (None,) * 4 + _rotate(gs, mesh, axis, -shift, rank)


def ppermute(x: Tensors, mesh: Mesh, axis: str, shift: int = 1,
             rank: Optional[int] = None) -> Tensors:
    """``jax.lax.ppermute(x, axis, [(i, (i + shift) % n)])``: each rank
    sends ``x`` to the rank ``shift`` places after it on its line along
    ``axis`` and returns what the rank ``shift`` places before it sent.
    ``x`` is a tensor or a sequence of tensors of one dtype, moved in one
    call; the gradient is the reverse rotation. ``rank`` defaults to this
    process's rank in its process group (a group of ``mesh.size``). On an
    axis of size 1 it returns ``x``."""
    if mesh.axis_size(axis) == 1:
        return x
    rank = dist.get_rank() if rank is None else rank
    one = torch.is_tensor(x)
    got = _PPermute.apply(mesh, axis, shift, rank, *((x,) if one else x))
    return got[0] if one else got


def block_index(shape: Sequence[int], mesh: Mesh,
                rank: int) -> Tuple[slice, ...]:
    """The index of rank ``rank``'s block of a global [B, S, H, D] array
    under the reference's ring spec P(("data", "fsdp"), "seq", "tensor",
    None): its rows (block data * fsdp-size + fsdp), its sequence block and
    its heads. A dim its axes do not divide raises."""
    c = mesh.coords(rank)
    f = mesh.axis_size("fsdp")
    out = []
    for dim, n, i in ((0, mesh.axis_size("data") * f, c["data"] * f
                       + c["fsdp"]),
                      (1, mesh.axis_size("seq"), c["seq"]),
                      (2, mesh.axis_size("tensor"), c["tensor"])):
        if shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"into {n}")
        w = shape[dim] // n
        out.append(slice(i * w, (i + 1) * w))
    return tuple(out)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: Mesh,
    axis_name: str = "seq",
    causal: bool = True,
    scale: Optional[float] = None,
    rank: Optional[int] = None,
) -> torch.Tensor:
    """Exact attention with the sequence split over ``axis_name``, run in
    each rank process on the blocks the rank holds: q [B_local, S/n,
    H_local, D], k/v [B_local, S/n, Hkv_local, D] (the global arrays at
    ``block_index``). Returns this rank's block of the output, in q's dtype;
    the math is f32 (ops/attention.py's blockwise update). ``rank``
    defaults to this process's rank in its process group."""
    rank = dist.get_rank() if rank is None else rank
    n = mesh.axis_size(axis_name)
    r = mesh.coords(rank)[axis_name]
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s_local = q.shape[1]
    if causal:
        ids = torch.arange(s_local, device=q.device)
        intra = torch.where(ids[None, :] <= ids[:, None], 0.0, NEG_INF)
        masked = torch.full_like(intra, NEG_INF)
    m, l, o = block_attn_init(q)
    k_blk, v_blk = k, v
    for s in range(n):
        j = (r - s) % n  # the position the held block started at
        mask = None  # full: j < r, or not causal
        if causal and j >= r:
            mask = intra if j == r else masked
        ke, ve = _gqa_expand(k_blk, v_blk, q.shape[2])
        m, l, o = block_attn_update(q, ke, ve, m, l, o, scale=scale,
                                    mask=mask)
        if s < n - 1:
            k_blk, v_blk = ppermute((k_blk, v_blk), mesh, axis_name,
                                    rank=rank)
    return block_attn_finish(l, o, q.dtype)
