"""Serving over a mesh (tensor and expert parallel): the engine's device
half in one process per mesh rank. The rank processes are started by
``TPRunner`` (the caller's side) and run tp_rank.py as their entry point:

    python -m ray_tpu_torch.llm._internal.tp_rank RANK FD

where FD is the rank's end of a socket pair to the caller. Each rank joins a
process group (a FileStore rendezvous in a fresh temporary directory; NCCL
when every rank has its own card, gloo on the CPU or when ranks share a
card), builds its shard of the model (models/llama.py, ``mesh=``) and its
shard of the paged KV cache, and runs a ``ModelRunner`` (runner.py) over
them. The caller sends every rank the same commands, in order; each rank
answers each command, in order; rank 0's answers carry the sampled tokens.

Messages are pickles of plain Python and numpy objects only, written by
this module on both sides. A rank that exits or answers with an error, and
a command that takes longer than ``REPLY_TIMEOUT_S``, fail the runner: it
stops every rank and raises, then and on every later call.
"""

from __future__ import annotations

import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from multiprocessing.connection import Connection
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

# A command's answer must arrive within this (the longest is the first
# prefill or forward of a large model, which also builds kernels).
REPLY_TIMEOUT_S = 900.0
# Rank start-up: imports, the process group, the weights.
START_TIMEOUT_S = 900.0
STOP_TIMEOUT_S = 30.0
POLL_S = 0.05


class RankError(RuntimeError):
    """A serving rank exited, failed a command, or did not answer
    in time."""


def resolve_backend(devices: Sequence[torch.device],
                    backend: Optional[str]) -> str:
    """The process-group backend for ranks on ``devices``: gloo on the CPU;
    NCCL when every rank has its own card. Ranks that share a card need
    gloo named explicitly, since NCCL refuses two ranks on one device."""
    types = {d.type for d in devices}
    if types == {"cpu"}:
        if backend not in (None, "gloo"):
            raise ValueError(f"CPU ranks take the gloo backend, not "
                             f"{backend!r}")
        return "gloo"
    if types != {"cuda"}:
        raise ValueError(f"TP ranks must all be CPU or all CUDA devices, "
                         f"got {[str(d) for d in devices]}")
    shared = len({d.index for d in devices}) < len(devices)
    if backend is None:
        if shared:
            raise ValueError(
                f"TP ranks share a card ({[str(d) for d in devices]}): NCCL "
                "refuses two ranks on one device; name the gloo backend "
                "(tp_backend='gloo') to run them over host memory")
        return "nccl"
    if backend == "nccl" and shared:
        raise ValueError("NCCL refuses two ranks on one device; use gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown TP backend {backend!r}")
    return backend


def rank_env(threads: int) -> Dict[str, str]:
    """The environment of a rank process: this package importable, gloo on
    the loopback device (the ranks share one host), ``threads`` OpenMP
    threads, and PyTorch's CUDA allocator growing expandable segments:
    ranks that share a card each keep what their caching allocator
    reserved, and four MoE training ranks at the 8B widths (19.1 GB a rank
    at peak) ran out of the card's 79 GiB with 3.28 GiB a rank reserved
    but unallocated."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    env["OMP_NUM_THREADS"] = str(threads)
    return env


def wire(t: Optional[torch.Tensor]):
    """A tensor as a numpy array for a message (bf16 as its int16 bits)."""
    if t is None:
        return None
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return ("bfloat16", t.view(torch.int16).numpy())
    return (None, t.numpy())


def unwire(x) -> Optional[torch.Tensor]:
    if x is None:
        return None
    dtype, arr = x
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


class Pending:
    """A command's answers from every rank, read on first ``get``."""

    def __init__(self, runner: "TPRunner", seq: int):
        self._runner = runner
        self._seq = seq
        self._value: Any = None
        self._done = False

    def all(self) -> List[Any]:
        """Every rank's answer, in rank order."""
        if not self._done:
            self._value = self._runner._wait(self._seq)
            self._done = True
        return self._value

    def get(self) -> Any:
        """Rank 0's answer."""
        return self.all()[0]


class _Chain:
    """A handle of the device outputs (last tokens, lengths) of a decode
    window, which live in the ranks."""


class TPRunner:
    """The caller's side of the rank processes: the ``ModelRunner``
    interface the engine calls, each call sent to every rank.

    ``params`` is a full state dict (host arrays; each rank keeps its slice)
    or ``SeededParams``. ``mesh`` gives one device per rank; each rank
    builds its shard of the model over the mesh's "tensor" and "expert"
    axes (the engine checks that it has no other).
    Calls may come from several threads (the engine's, and a caller's
    ``forward`` or ``counters``): a lock keeps each command's sending and
    each wait for answers whole.
    """

    def __init__(self, model_cfg, params, cfg, cache_cfg, mesh,
                 backend: Optional[str] = None):
        self.size = mesh.size
        self.backend = resolve_backend(mesh.devices, backend)
        self._failed: Optional[BaseException] = None
        self._procs: List[subprocess.Popen] = []
        self._conns: List[Connection] = []
        self._sent = 0  # commands sent (the start-up message is 0)
        self._read = []  # per rank: the last command answered
        self._answers: Dict[int, List[Any]] = {}
        self._waited: set = set()  # commands whose answers are kept
        self._chain = None
        self._lock = threading.RLock()
        self._dir = tempfile.mkdtemp(prefix="ray_tpu_torch_tp_")
        spec = {"model_cfg": model_cfg, "params": params, "cfg": cfg,
                "cache_cfg": cache_cfg, "mesh": mesh,
                "backend": self.backend,
                "store": os.path.join(self._dir, "store"),
                "threads": max(1, torch.get_num_threads() // self.size)}
        env = rank_env(spec["threads"])
        try:
            blob = pickle.dumps(spec, protocol=pickle.HIGHEST_PROTOCOL)
            for rank in range(self.size):
                mine, theirs = socket.socketpair()
                with theirs:
                    self._procs.append(subprocess.Popen(
                        [sys.executable, "-m",
                         "ray_tpu_torch.llm._internal.tp_rank", str(rank),
                         str(theirs.fileno())],
                        pass_fds=(theirs.fileno(),), env=env))
                self._conns.append(Connection(mine.detach()))
                self._read.append(-1)
            for conn in self._conns:
                conn.send_bytes(blob)
            self._waited.add(0)
            self.info = self._wait(0, START_TIMEOUT_S)
        except BaseException:
            self.close()
            raise

    # ------------------------------------------------------------------
    # The ModelRunner interface
    # ------------------------------------------------------------------
    def seed(self, slot: int, seed: int) -> None:
        self._send("seed", keep=False, slot=slot, seed=seed)

    def prefill(self, ids, rows, starts, true_lens, temps, top_ps, top_ks,
                slots, lidx, rich: bool, want_lp: bool):
        """Sends the prefill; returns (a pending answer whose ``get`` is
        rank 0's (tokens, logprobs) on the host, None)."""
        seq = self._send("prefill", ids=ids, rows=rows, starts=starts,
                         true_lens=true_lens, temps=temps, top_ps=top_ps,
                         top_ks=top_ks, slots=slots, lidx=lidx, rich=rich,
                         want_lp=want_lp)
        return Pending(self, seq), None

    def decode_window(self, last_tokens, page_table, seq_lens, active,
                      temps, top_ps, top_ks, lora_idx, rich: bool,
                      want_lp: bool):
        """Sends a decode window; returns (a pending answer whose ``get`` is
        rank 0's (tokens [K,B], logprobs) on the host, a handle of the
        ranks' final last tokens, the same for the lengths, None). Handles
        of the window sent last chain the next one."""
        if isinstance(last_tokens, _Chain):
            if last_tokens is not self._chain:
                raise ValueError("a decode window chains only from the "
                                 "window sent last")
            last_tokens = seq_lens = None
        seq = self._send("decode_window", last_tokens=last_tokens,
                         page_table=page_table, seq_lens=seq_lens,
                         active=active, temps=temps, top_ps=top_ps,
                         top_ks=top_ks, lora_idx=lora_idx, rich=rich,
                         want_lp=want_lp)
        self._chain = _Chain()
        return Pending(self, seq), self._chain, self._chain, None

    def forward(self, ids) -> torch.Tensor:
        """The cacheless forward's full logits [B, S, V] of ids [B, S] (a
        host tensor): every rank runs its shard, rank 0 writes the gathered
        logits to a file in the rendezvous directory, read here and
        removed."""
        ids = np.asarray(ids.cpu() if torch.is_tensor(ids) else ids)
        dtype, path = Pending(self, self._send("forward", ids=ids)).get()
        try:
            return unwire((dtype, np.load(path)))
        finally:
            os.remove(path)

    def counters(self, reset: bool = False) -> List[Dict[str, Any]]:
        """Each rank's kernel launch counts (K1 ``flash_fwd``, K4
        ``paged_decode``), its device and its peak device memory in GB;
        ``reset`` zeroes the counts and the peak after reading them."""
        return Pending(self, self._send("counters", reset=reset)).all()

    # ------------------------------------------------------------------
    def _send(self, name: str, keep: bool = True, **kwargs) -> int:
        """Send command ``name`` to every rank; its answers are kept for a
        ``_wait`` when ``keep``, else only checked."""
        blob = pickle.dumps((name, kwargs), protocol=pickle.HIGHEST_PROTOCOL)
        with self._lock:
            self._check()
            self._drain()
            self._sent += 1
            seq = self._sent
            if keep:
                self._waited.add(seq)
            try:
                for conn in self._conns:
                    conn.send_bytes(blob)
            except OSError as e:
                self._fail(RankError(f"sending {name} to the ranks: {e}"))
            return seq

    def _drain(self) -> None:
        """Read the answers already there, so that no rank blocks writing
        answers while this side writes commands."""
        for r, conn in enumerate(self._conns):
            while self._read[r] < self._sent and conn.poll(0):
                self._read_one(r)

    def _wait(self, seq: int, timeout: float = REPLY_TIMEOUT_S) -> List[Any]:
        with self._lock:
            self._check()
            deadline = time.monotonic() + timeout
            for r, conn in enumerate(self._conns):
                while self._read[r] < seq:
                    while not conn.poll(POLL_S):
                        self._check_alive()
                        if time.monotonic() > deadline:
                            self._fail(RankError(
                                f"serving rank {r} did not answer "
                                f"command {seq} within {timeout:.0f} s"))
                    self._read_one(r)
            self._waited.discard(seq)
            return self._answers.pop(seq)

    def _read_one(self, r: int) -> None:
        try:
            seq, ok, payload = pickle.loads(self._conns[r].recv_bytes())
        except (EOFError, OSError):
            self._check_alive(wait=STOP_TIMEOUT_S)
            self._fail(RankError(f"serving rank {r} closed its "
                                 "connection"))
        self._read[r] = seq
        if not ok:
            self._fail(RankError(
                f"serving rank {r} failed command {seq}:\n{payload}"))
        if seq in self._waited:
            self._answers.setdefault(seq, [None] * self.size)[r] = payload

    def _check_alive(self, wait: float = 0.0) -> None:
        deadline = time.monotonic() + wait
        while True:
            for r, p in enumerate(self._procs):
                if p.poll() is not None:
                    self._fail(RankError(
                        f"serving rank {r} exited with code "
                        f"{p.returncode}"))
            if time.monotonic() >= deadline:
                return
            time.sleep(POLL_S)

    def _check(self) -> None:
        if self._failed is not None:
            raise RankError(f"the serving ranks failed: "
                            f"{self._failed}") from self._failed

    def _fail(self, exc: BaseException):
        self._failed = exc
        self._stop(graceful=False)
        raise exc

    # ------------------------------------------------------------------
    def close(self) -> None:
        """Stop the ranks (each destroys its process group and exits),
        within ``STOP_TIMEOUT_S``, then kill any left; remove the
        rendezvous directory. Idempotent."""
        with self._lock:
            self._stop(graceful=self._failed is None)

    def _stop(self, graceful: bool) -> None:
        if graceful:
            blob = pickle.dumps(("stop", {}))
            for conn, p in zip(self._conns, self._procs):
                if p.poll() is None:
                    try:
                        conn.send_bytes(blob)
                    except OSError:
                        pass
        deadline = time.monotonic() + (STOP_TIMEOUT_S if graceful else 0)
        for p in self._procs:
            try:
                p.wait(max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
        for p in self._procs:
            if p.poll() is None:
                p.kill()
                p.wait(STOP_TIMEOUT_S)
        for conn in self._conns:
            conn.close()
        self._conns, self._procs = [], []
        shutil.rmtree(self._dir, ignore_errors=True)
