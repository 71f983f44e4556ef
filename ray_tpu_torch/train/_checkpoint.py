"""Checkpoints. Port of ray_tpu/train/_checkpoint.py.

``Checkpoint`` (a directory handle) and ``CheckpointManager`` (top-K by
score) are host Python, copied from the reference (reference:
train/_checkpoint.py:56 — a directory on fsspec/pyarrow storage; here
local/NFS paths).

``save_pytree``/``load_pytree`` are the counterparts of the reference's
orbax pair. A tree of dicts, lists and tuples of tensors, numpy arrays and
Python or numpy scalars is written with ``torch.save`` into one file under
the directory; ``torch.save`` copies one tensor at a time from its device,
so no host copy of the whole tree is built. Numpy arrays and scalars travel
as tensors tagged ``NumpyLeaf`` and come back as numpy, since
``torch.load(weights_only=True)`` refuses numpy objects. A port
``TrainState`` is saved as the reference saves its state: ``step``,
``params`` (the model's state dict) and ``opt_state`` (the optimizer's
state dict), with the model's parameter names in the optimizer's order.

A state over a mesh (``LlamaModel(cfg, mesh=)``, one rank process a mesh
device) is saved by every rank: each writes its own part,
``rank_<rank>.pt``, with the mesh's shape and world size beside it; rank 0
alone clears an existing directory, with a barrier on each side. Each rank
restores its own part. The reference's orbax reshards on restore; the port
does not yet, so a restore at another mesh shape raises.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import uuid
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.train.step import TrainState


class Checkpoint:
    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def as_directory(self) -> str:
        return self.path

    def to_directory(self, dest: Optional[str] = None) -> str:
        dest = dest or os.path.join(tempfile.gettempdir(),
                                    f"ckpt_{uuid.uuid4().hex[:8]}")
        if os.path.abspath(dest) != self.path:
            shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    def __repr__(self):
        return f"Checkpoint({self.path})"

    def __reduce__(self):
        return (Checkpoint, (self.path,))


class CheckpointManager:
    """Keeps top-K checkpoints by score (reference:
    v2/_internal/execution/checkpoint/checkpoint_manager.py)."""

    def __init__(self, storage_path: str, num_to_keep: Optional[int] = None,
                 score_attribute: Optional[str] = None, score_order: str = "max"):
        self.storage_path = storage_path
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        self._entries: list = []  # (score, index, path, metrics)
        os.makedirs(storage_path, exist_ok=True)
        # Resume numbering past any checkpoints already in storage so a rerun
        # with the same name/path never collides with (or nests into) them.
        existing = [d for d in os.listdir(storage_path)
                    if d.startswith("checkpoint_")]
        self._index = max(
            (int(d.rsplit("_", 1)[1]) for d in existing
             if d.rsplit("_", 1)[1].isdigit()), default=0)

    def register(self, source_dir: str,
                 metrics: Dict[str, Any], move: bool = False) -> Checkpoint:
        self._index += 1
        dest = os.path.join(self.storage_path,
                            f"checkpoint_{self._index:06d}")
        if move:
            if os.path.isdir(dest):  # stale leftover; never nest into it
                shutil.rmtree(dest, ignore_errors=True)
            shutil.move(source_dir, dest)
        else:
            shutil.copytree(source_dir, dest, dirs_exist_ok=True)
        score = None
        if self.score_attribute is not None:
            score = metrics.get(self.score_attribute)
        self._entries.append((score, self._index, dest, dict(metrics)))
        self._evict()
        return Checkpoint(dest)

    def _evict(self) -> None:
        if self.num_to_keep is None or len(self._entries) <= self.num_to_keep:
            return
        if self.score_attribute is None:
            ordered = sorted(self._entries, key=lambda e: e[1])  # oldest first
        else:
            sign = 1 if self.score_order == "max" else -1
            ordered = sorted(
                self._entries,
                key=lambda e: (sign * e[0] if e[0] is not None else float("-inf")))
        while len(self._entries) > self.num_to_keep:
            victim = ordered.pop(0)
            self._entries.remove(victim)
            shutil.rmtree(victim[2], ignore_errors=True)

    @property
    def latest(self) -> Optional[Checkpoint]:
        if not self._entries:
            return None
        return Checkpoint(max(self._entries, key=lambda e: e[1])[2])

    @property
    def best(self) -> Optional[Checkpoint]:
        if not self._entries:
            return None
        if self.score_attribute is None:
            return self.latest
        sign = 1 if self.score_order == "max" else -1
        scored = [e for e in self._entries if e[0] is not None]
        if not scored:
            return self.latest
        return Checkpoint(max(scored, key=lambda e: sign * e[0])[2])


# ---------------------------------------------------------------------------
# Trees and train states (the reference's orbax pair).
# ---------------------------------------------------------------------------
FILE = "pytree.pt"


def rank_file(rank: int) -> str:
    return f"rank_{rank:05d}.pt"


def state_file(state: TrainState) -> str:
    """The file of a checkpoint that holds ``state``'s part: the rank's
    over a mesh, else the one file."""
    return FILE if _state_mesh(state) is None else rank_file(
        state.model.rank)


class NumpyLeaf:
    """A numpy array (``scalar`` False) or numpy scalar in a saved tree,
    held as a tensor of its dtype."""

    __slots__ = ("tensor", "scalar")

    def __init__(self, tensor: torch.Tensor, scalar: bool):
        self.tensor = tensor
        self.scalar = scalar

    def __reduce__(self):
        return (NumpyLeaf, (self.tensor, self.scalar))

    def value(self):
        a = self.tensor.numpy()
        return a[()] if self.scalar else a


_SCALARS = (bool, int, float, complex, str, type(None))


def _pack(x, where: str = "tree"):
    """``x`` as torch.save with weights_only=True can read back."""
    if isinstance(x, dict):
        return {k: _pack(v, f"{where}.{k}") for k, v in x.items()}
    if type(x) in (list, tuple):
        return type(x)(_pack(v, f"{where}[{i}]") for i, v in enumerate(x))
    if isinstance(x, torch.Tensor):
        x = x.detach()
        # A view would write its whole storage: save its own copy.
        whole = (x.is_contiguous() and x.storage_offset() == 0
                 and x.untyped_storage().nbytes()
                 == x.numel() * x.element_size())
        return x if whole else x.clone()
    if isinstance(x, (np.ndarray, np.generic)):
        try:
            return NumpyLeaf(torch.from_numpy(np.array(x)),
                             isinstance(x, np.generic))
        except TypeError as e:
            raise TypeError(f"{where}: numpy dtype {x.dtype} cannot be "
                            "saved") from e
    if isinstance(x, _SCALARS):
        return x
    raise TypeError(f"{where}: cannot save a {type(x).__name__} (trees of "
                    "dicts, lists and tuples of tensors, numpy arrays and "
                    "scalars)")


def _unpack(x):
    if isinstance(x, dict):
        return {k: _unpack(v) for k, v in x.items()}
    if type(x) in (list, tuple):
        return type(x)(_unpack(v) for v in x)
    if isinstance(x, NumpyLeaf):
        return x.value()
    return x


def _read(file: str) -> Dict[str, Any]:
    """A saved payload, its tensors on the CPU, memory-mapped."""
    with torch.serialization.safe_globals([NumpyLeaf]):
        return torch.load(file, map_location="cpu", weights_only=True,
                          mmap=True)


def _state_mesh(state: TrainState):
    """The state's mesh (its model's), or None without one or for one of a
    single rank."""
    mesh = getattr(state.model, "mesh", None)
    return mesh if mesh is not None and mesh.size > 1 else None


def _mesh_shape(mesh) -> Dict[str, int]:
    if mesh is None:
        return {}
    return {n: s for n, s in zip(mesh.axis_names, mesh.shape) if s > 1}


def _param_names(state: TrainState) -> List[str]:
    """The model's parameter names in the optimizer's order (its state
    dict's keys are positions in it)."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    out = []
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            if id(p) not in names:
                raise ValueError("the optimizer holds tensors that are not "
                                 "the model's parameters")
            out.append(names[id(p)])
    return out


def _state_payload(state: TrainState) -> Dict[str, Any]:
    mesh = _state_mesh(state)
    return {"kind": "train_state", "step": int(state.step),
            "params": _pack(state.model.state_dict()),
            "opt_state": _pack(state.optimizer.state_dict()),
            "param_names": _param_names(state),
            "mesh": _mesh_shape(mesh),
            "world_size": 1 if mesh is None else mesh.size}


def save_pytree(pytree, path: str) -> Checkpoint:
    """Write a tree or a ``TrainState`` into the directory ``path``
    (replacing what was there) and return a Checkpoint over it. Pairs with
    ``load_pytree``. For a state over a mesh, call it in every rank
    process: each writes its own part."""
    path = os.path.abspath(path)
    if isinstance(pytree, TrainState):
        payload = _state_payload(pytree)
        mesh = _state_mesh(pytree)
    else:
        payload = {"kind": "tree", "tree": _pack(pytree), "mesh": {},
                   "world_size": 1}
        mesh = None
    if mesh is None:
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        os.makedirs(path)
        torch.save(payload, os.path.join(path, FILE))
        return Checkpoint(path)
    if not dist.is_initialized() or dist.get_world_size() != mesh.size:
        raise ValueError(f"a state over a mesh of {mesh.size} ranks is "
                         "saved in each of its rank processes, inside their "
                         "process group")
    rank = pytree.model.rank
    if rank == 0 and os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
    dist.barrier()
    os.makedirs(path, exist_ok=True)
    torch.save(dict(payload, rank=rank),
               os.path.join(path, state_file(pytree)))
    dist.barrier()
    return Checkpoint(path)


def _check_state(state: TrainState, payload: Dict[str, Any]) -> None:
    """Raises unless ``payload`` (a saved state) fits ``state`` whole: the
    same mesh, parameter names, shapes and dtypes, optimizer groups and
    moment shapes."""
    if payload.get("kind") != "train_state":
        raise ValueError("the checkpoint holds a tree, not a train state")
    mesh = _state_mesh(state)
    want = (_mesh_shape(mesh), 1 if mesh is None else mesh.size)
    have = (payload["mesh"], payload["world_size"])
    if want != have:
        raise ValueError(
            f"the checkpoint was saved over the mesh {have[0] or 'none'} "
            f"({have[1]} ranks); restoring it over {want[0] or 'none'} "
            f"({want[1]} ranks) needs resharding, which is not ported")
    sd, saved = state.model.state_dict(), payload["params"]
    if set(sd) != set(saved):
        raise ValueError(
            f"parameter names differ: missing {sorted(set(sd) - set(saved))}"
            f", unexpected {sorted(set(saved) - set(sd))}")
    for n, t in sd.items():
        s = saved[n]
        if s.shape != t.shape or s.dtype != t.dtype:
            raise ValueError(f"{n}: saved {s.dtype} {tuple(s.shape)}, the "
                             f"model holds {t.dtype} {tuple(t.shape)}")
    names = _param_names(state)
    if names != payload["param_names"]:
        raise ValueError("the optimizer holds the parameters in another "
                         "order than the saved one")
    osd = payload["opt_state"]
    sizes = [len(g["params"]) for g in state.optimizer.param_groups]
    if sizes != [len(g["params"]) for g in osd["param_groups"]]:
        raise ValueError(f"optimizer groups of {sizes} parameters; saved "
                         f"{[len(g['params']) for g in osd['param_groups']]}")
    shapes = [tuple(sd[n].shape) for n in names]
    for i, entry in osd["state"].items():
        for k, v in entry.items():
            if (isinstance(v, torch.Tensor) and v.dim()
                    and tuple(v.shape) != shapes[i]):
                raise ValueError(f"{names[i]}: saved {k} of shape "
                                 f"{tuple(v.shape)}, the parameter is "
                                 f"{shapes[i]}")


def _restore_state(state: TrainState, payload: Dict[str, Any]
                   ) -> TrainState:
    _check_state(state, payload)
    saved = payload["params"]
    with torch.no_grad():
        for n, t in state.model.state_dict().items():
            t.copy_(saved[n])
    # casts each moment to its parameter's device and dtype
    state.optimizer.load_state_dict(payload["opt_state"])
    state.step = payload["step"]
    return state


def _restore_tree(target, saved):
    """``target``'s structure with its tensors overwritten in place by the
    saved ones and every other leaf the saved value; nothing is copied
    unless the whole tree fits."""
    copies = []

    def walk(t, s, where):
        if isinstance(t, dict):
            if not isinstance(s, dict) or set(t) != set(s):
                raise ValueError(f"{where}: the saved keys differ")
            return {k: walk(t[k], s[k], f"{where}.{k}") for k in t}
        if type(t) in (list, tuple):
            if type(s) is not type(t) or len(s) != len(t):
                raise ValueError(f"{where}: saved {type(s).__name__} does "
                                 f"not match {type(t).__name__} of {len(t)}")
            return type(t)(walk(a, b, f"{where}[{i}]")
                           for i, (a, b) in enumerate(zip(t, s)))
        if isinstance(t, torch.Tensor):
            if (not isinstance(s, torch.Tensor) or s.shape != t.shape
                    or s.dtype != t.dtype):
                raise ValueError(f"{where}: the saved leaf does not match "
                                 f"{t.dtype} {tuple(t.shape)}")
            copies.append((t, s))
            return t
        return _unpack(s)

    out = walk(target, saved, "tree")
    with torch.no_grad():
        for t, s in copies:
            t.copy_(s)
    return out


def load_pytree(checkpoint: Checkpoint, target=None):
    """Restore what ``save_pytree`` wrote. With no ``target``: the saved
    tree (a train state as its ``{"step", "params", "opt_state"}``), its
    tensors on the CPU. With a ``TrainState`` target: its model and
    optimizer restored in place, on their devices, and its step set;
    returns the target (in each rank process for a state over a mesh, each
    from its own part, at the saved mesh only). With another tree: its
    tensors overwritten in place, the rest as saved."""
    path = checkpoint.as_directory()
    if isinstance(target, TrainState):
        name = state_file(target)
        file = os.path.join(path, name)
        if not os.path.exists(file):
            found = sorted(f for f in os.listdir(path) if f.endswith(".pt"))
            raise ValueError(f"{path} holds no {name} (it holds {found}): "
                             "saved over another mesh")
        return _restore_state(target, _read(file))
    file = os.path.join(path, FILE)
    if not os.path.exists(file):
        if not dist.is_initialized():
            raise ValueError(f"{path} holds a state saved over a mesh: load "
                             "it in each rank process")
        file = os.path.join(path, rank_file(dist.get_rank()))
    payload = _read(file)
    if payload["kind"] == "train_state":
        tree = {k: payload[k] for k in ("step", "params", "opt_state")}
    else:
        tree = payload["tree"]
    if target is None:
        return _unpack(tree)
    return _restore_tree(target, tree)
