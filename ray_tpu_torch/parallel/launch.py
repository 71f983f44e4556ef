"""Rank processes for a program that runs over a whole mesh (a sharded
train step): one process per mesh device, all running one function.

The reference runs such a program as one XLA executable over the mesh's
devices; the port starts ``mesh.size`` processes instead:

    python -m ray_tpu_torch.parallel.launch RANK FD

where FD is the rank's end of a socket pair to the caller. Each rank joins
a process group of ``mesh.size`` (a FileStore rendezvous in a fresh
temporary directory; the backend as ``llm/_internal/tp.py``'s
``resolve_backend`` picks it: gloo on the CPU or when ranks share a card),
calls ``target(mesh=mesh, rank=rank, **kwargs)``, sends back what it
returns, destroys the group and exits. Ranks that share a card each get an
even share of its free memory for their caching allocators
(``card_shares``). The job's spec (target, kwargs,
mesh) and each rank's answer are pickles in the rendezvous directory; the
socket carries their paths. So starting a job does not wait for the ranks
to start, and an answer of hundreds of MB is not streamed through a
socket. Both hold plain Python and numpy objects written by this module.

A rank that exits, fails, or does not answer within the timeout fails the
job: every rank is stopped and the caller raises, with the traceback of
every rank that failed (the peers of a rank that dies fail in their next
collective). The error ends with one line a failed rank: those that
exited without an answer, then the others in the order they failed, so
that the end of a log names the first cause. After ``close()`` no rank process and no
rendezvous directory is left.
"""

from __future__ import annotations

import datetime
import importlib
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from collections import Counter
from multiprocessing.connection import Connection
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.llm._internal.tp import RankError, rank_env, resolve_backend
from ray_tpu_torch.parallel.mesh import Mesh

# A job's answer must arrive within this unless the caller gives another.
TIMEOUT_S = 900.0
# What a rank's CUDA context, libraries and kernels take on its card
# outside the caching allocator (the main process of chip_smoke.py: 0.89
# GB on the H100).
CONTEXT_GB = 1.0
# A failed rank's answer.
_FAILED = object()
STOP_TIMEOUT_S = 30.0
POLL_S = 0.05


class RankJob:
    """``target`` ("module:function") run in one process per rank of
    ``mesh``, started at construction; ``results()`` waits for them."""

    def __init__(self, target: str, mesh: Mesh,
                 kwargs: Optional[Dict[str, Any]] = None,
                 backend: Optional[str] = None):
        self.mesh = mesh
        self.backend = resolve_backend(mesh.devices, backend)
        self._procs: List[subprocess.Popen] = []
        self._conns: List[Connection] = []
        # rank: (traceback, Unix time of its failure)
        self._tracebacks: Dict[int, Tuple[str, float]] = {}
        self._dir = tempfile.mkdtemp(prefix="ray_tpu_torch_ranks_")
        threads = max(1, torch.get_num_threads() // mesh.size)
        spec = {"target": target, "kwargs": kwargs or {}, "mesh": mesh,
                "backend": self.backend, "threads": threads,
                "store": os.path.join(self._dir, "store"),
                "card_shares": card_shares(mesh.devices)}
        try:
            path = os.path.join(self._dir, "spec.pkl")
            with open(path, "wb") as f:
                pickle.dump(spec, f, protocol=pickle.HIGHEST_PROTOCOL)
            env = rank_env(threads)
            for rank in range(mesh.size):
                mine, theirs = socket.socketpair()
                with theirs:
                    self._procs.append(subprocess.Popen(
                        [sys.executable, "-m", __name__, str(rank),
                         str(theirs.fileno())],
                        pass_fds=(theirs.fileno(),), env=env))
                self._conns.append(Connection(mine.detach()))
            for conn in self._conns:
                conn.send_bytes(path.encode())
        except BaseException:
            self.close()
            raise

    def results(self, timeout: float = TIMEOUT_S) -> List[Any]:
        """Every rank's result, in rank order; then the ranks are gone."""
        done = False
        try:
            deadline = time.monotonic() + timeout
            out = []
            for r, conn in enumerate(self._conns):
                while not conn.poll(POLL_S):
                    for q, p in enumerate(self._procs):
                        if p.poll() is not None and p.returncode != 0:
                            raise self._failure(f"rank {q} exited with "
                                                f"code {p.returncode}")
                    if time.monotonic() > deadline:
                        raise RankError(f"rank {r} did not answer within "
                                        f"{timeout:.0f} s")
                out.append(self._answer(r))
                if out[-1] is _FAILED:
                    raise self._failure(f"rank {r} failed")
            done = True
            return out
        finally:
            self.close(graceful=done)

    def _answer(self, r: int) -> Any:
        """Rank r's result; ``_FAILED`` (its traceback kept) when it
        failed."""
        conn = self._conns[r]
        try:
            if not conn.poll(0):
                return None
            with open(conn.recv_bytes().decode(), "rb") as f:
                ok, payload, at = pickle.load(f)
        except (EOFError, OSError):
            raise RankError(f"rank {r} closed its connection")
        if not ok:
            self._tracebacks[r] = (payload, at)
            return _FAILED
        return payload

    def _failure(self, what: str) -> RankError:
        """A RankError naming ``what`` with the traceback of every rank
        that has failed once the others had ``STOP_TIMEOUT_S`` to exit."""
        deadline = time.monotonic() + STOP_TIMEOUT_S
        while (any(p.poll() is None for p in self._procs)
               and time.monotonic() < deadline):
            time.sleep(POLL_S)
        for r, conn in enumerate(self._conns):
            if r not in self._tracebacks and not conn.closed:
                try:
                    self._answer(r)
                except RankError:
                    pass
        tbs = sorted(self._tracebacks.items())
        lines = [f"rank {r}: exit code {p.returncode}, no answer"
                 for r, p in enumerate(self._procs)
                 if r not in self._tracebacks and p.returncode]
        t0 = min([at for _, at in self._tracebacks.values()], default=0.0)
        lines += [f"rank {r} at +{at - t0:.3f} s: "
                  f"{(tb.strip().splitlines() or [''])[-1]}"
                  for r, (tb, at) in sorted(tbs, key=lambda x: x[1][1])]
        return RankError(what + "".join(
            f"\nrank {r} failed:\n{tb}" for r, (tb, _) in tbs)
            + "\nfailed ranks, those with no answer first, then in the "
            "order they failed:\n" + "\n".join(lines))

    def close(self, graceful: bool = False) -> None:
        """Kill the ranks (``graceful``: those still there after
        ``STOP_TIMEOUT_S``), remove the rendezvous directory. Idempotent."""
        deadline = time.monotonic() + (STOP_TIMEOUT_S if graceful else 0)
        for conn in self._conns:
            conn.close()
        for p in self._procs:
            try:
                p.wait(max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
        for p in self._procs:
            if p.poll() is None:
                p.kill()
                p.wait(STOP_TIMEOUT_S)
        self._conns, self._procs = [], []
        shutil.rmtree(self._dir, ignore_errors=True)


def _card(device: torch.device) -> int:
    return (torch.cuda.current_device() if device.index is None
            else device.index)


def card_shares(devices) -> Dict[int, float]:
    """For each card that several of ``devices`` name: the fraction of its
    memory that the caching allocator of each rank on it may hold, its free
    memory less ``CONTEXT_GB`` a rank, split evenly. An allocator at its
    share frees its cached blocks and retries before it fails, so one
    rank's cache does not take memory that another rank needs: four ranks
    of the MoE step at the 8B widths held 18.04 GB each at peak but
    reserved up to 20.05 GB, 79.2 GB together of the H100's 85.0."""
    counts = Counter(_card(d) for d in devices if d.type == "cuda")
    shares = {}
    for card, n in counts.items():
        if n > 1:
            free, total = torch.cuda.mem_get_info(card)
            shares[card] = max(0.0, free - n * CONTEXT_GB * 1e9) / n / total
    return shares


def run_ranks(target: str, mesh: Mesh,
              kwargs: Optional[Dict[str, Any]] = None,
              backend: Optional[str] = None,
              timeout: float = TIMEOUT_S) -> List[Any]:
    """``target(mesh=mesh, rank=r, **kwargs)`` in each rank process r of
    ``mesh``; their results in rank order."""
    return RankJob(target, mesh, kwargs, backend).results(timeout)


def rank_main(rank: int, fd: int) -> int:
    # torch names all_gather_into_tensor and reduce_scatter_tensor
    # deprecated; the names that replace them are not in every torch this
    # port runs on.
    warnings.filterwarnings("ignore", category=FutureWarning,
                            module="torch.distributed")
    conn = Connection(fd)
    try:
        try:
            spec_path = conn.recv_bytes().decode()
            with open(spec_path, "rb") as f:
                spec = pickle.load(f)
        except (EOFError, OSError):
            return 1  # the caller is gone
        try:
            mesh = spec["mesh"]
            device = mesh.devices[rank]
            torch.set_num_threads(spec["threads"])
            if device.type == "cuda":
                torch.cuda.set_device(device)
                share = spec["card_shares"].get(_card(device))
                if share:
                    torch.cuda.set_per_process_memory_fraction(share)
            dist.init_process_group(
                spec["backend"],
                store=dist.FileStore(spec["store"], mesh.size), rank=rank,
                world_size=mesh.size,
                timeout=datetime.timedelta(seconds=TIMEOUT_S))
            module, _, name = spec["target"].partition(":")
            fn = getattr(importlib.import_module(module), name)
            result = (True, fn(mesh=mesh, rank=rank, **spec["kwargs"]),
                      time.time())
        except Exception:
            result = (False, traceback.format_exc(), time.time())
        path = os.path.join(os.path.dirname(spec_path), f"answer{rank}.pkl")
        with open(path, "wb") as f:
            pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)
        conn.send_bytes(path.encode())
        return 0 if result[0] else 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        conn.close()


if __name__ == "__main__":
    sys.exit(rank_main(int(sys.argv[1]), int(sys.argv[2])))
