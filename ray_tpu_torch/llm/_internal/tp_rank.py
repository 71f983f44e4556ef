"""The entry point of a serving rank process (started by ``TPRunner``,
llm/_internal/tp.py):

    python -m ray_tpu_torch.llm._internal.tp_rank RANK FD

FD is the rank's end of a socket pair to the caller. The rank joins the
process group, builds its shard of the model and of the paged KV cache,
answers ``info``, then runs the caller's commands in order, answering each;
"stop", or the caller's end closing, ends it. A command that raises is
answered with its traceback and ends the rank, since a failed collective
leaves the group unusable. The group is destroyed on the way out.
"""

from __future__ import annotations

import datetime
import os
import pickle
import sys
import traceback
from multiprocessing.connection import Connection
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.llm._internal.paged import paged_attention_decode_kernel
from ray_tpu_torch.llm._internal.runner import ModelRunner, to_host
from ray_tpu_torch.llm._internal.tp import REPLY_TIMEOUT_S, wire
from ray_tpu_torch.models.llama import LlamaModel
from ray_tpu_torch.ops.attention import flash_fwd_kernel


class _Rank:
    """One rank's commands, over its ``ModelRunner``."""

    def __init__(self, rank: int, spec: Dict[str, Any]):
        mesh = spec["mesh"]
        self.rank = rank
        self.dir = os.path.dirname(spec["store"])
        self.device = mesh.devices[rank]
        torch.set_num_threads(spec["threads"])
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        dist.init_process_group(
            spec["backend"], store=dist.FileStore(spec["store"], mesh.size),
            rank=rank, world_size=mesh.size,
            timeout=datetime.timedelta(seconds=REPLY_TIMEOUT_S))
        model = LlamaModel(spec["model_cfg"], device=self.device, mesh=mesh,
                           rank=rank)
        self.runner = ModelRunner(model, spec["params"], spec["cfg"],
                                  spec["cache_cfg"], device=self.device)
        self._chain = None

    def info(self) -> Dict[str, Any]:
        model = self.runner.model
        return {"rank": self.rank, "device": str(self.device),
                "kv_heads": model.kv_heads,
                "heads": model.layers[0].self_attn.heads,
                "experts": getattr(model.layers[0].mlp, "experts", None)}

    def seed(self, slot, seed):
        self.runner.seed(slot, seed)

    def prefill(self, **kw):
        toks, lp = self.runner.prefill(**kw)
        return None if toks is None else to_host(toks, lp)

    def decode_window(self, last_tokens, seq_lens, **kw):
        if last_tokens is None:
            last_tokens, seq_lens = self._chain
        out, toks, lens, lps = self.runner.decode_window(
            last_tokens=last_tokens, seq_lens=seq_lens, **kw)
        self._chain = (toks, lens)
        return None if out is None else to_host(out, lps)

    def forward(self, ids):
        """Rank 0's logits as (dtype, the path of a .npy file in the
        rendezvous directory); None on the other ranks. Logits of a wave
        ([8, 176, 128256] bf16: 361 MB) cross a socket at a few MB/s on
        the card's host, a file in seconds."""
        logits = self.runner.forward(ids)
        if not self.runner.samples:
            return None
        dtype, arr = wire(logits)
        path = os.path.join(self.dir, f"forward{self.rank}.npy")
        np.save(path, arr)
        return dtype, path

    def counters(self, reset):
        k4, k1 = paged_attention_decode_kernel, flash_fwd_kernel
        out = {"rank": self.rank, "device": str(self.device),
               "paged_decode": k4.launches, "flash_fwd": k1.launches}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            out["peak_gb"] = torch.cuda.max_memory_allocated(
                self.device) / 1e9
        if reset:
            k4.launches = k1.launches = 0
            if self.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(self.device)
        return out


def rank_main(rank: int, fd: int) -> int:
    conn = Connection(fd)
    seq = 0

    def answer(ok, payload):
        conn.send_bytes(pickle.dumps((seq, ok, payload),
                                     protocol=pickle.HIGHEST_PROTOCOL))

    try:
        try:
            handler = _Rank(rank, pickle.loads(conn.recv_bytes()))
            answer(True, handler.info())
        except Exception:
            answer(False, traceback.format_exc())
            return 1
        while True:
            try:
                name, kwargs = pickle.loads(conn.recv_bytes())
            except (EOFError, OSError):
                return 0  # the caller is gone
            seq += 1
            if name == "stop":
                return 0
            try:
                with torch.no_grad():
                    result = getattr(handler, name)(**kwargs)
            except Exception:
                # A failed collective leaves the group unusable: stop.
                answer(False, traceback.format_exc())
                return 1
            answer(True, result)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        conn.close()


if __name__ == "__main__":
    sys.exit(rank_main(int(sys.argv[1]), int(sys.argv[2])))
