"""Which collectives take CUDA tensors when two ranks share one card (not a
pytest file; run on a machine with a GPU):

    python3 tests/torch_gloo_cuda_probe.py

Starts two rank processes on cuda:0, once with gloo and once with NCCL, and
tries all_reduce, broadcast, all_gather, all_gather_into_tensor,
reduce_scatter_tensor and reduce_scatter in f32, bf16, f16, int32 and
int64, and the same all_reduce and all_gather_into_tensor over a group
made with new_group. Rank 0 prints one line per backend: each
call's result, or the error it raised. NCCL refuses two ranks on one
device; this is why tensor-parallel ranks that share a card take gloo
(llm/_internal/tp.py).
"""

import json
import os
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist

DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int32,
          torch.int64)


def rank_main(rank, n, store, backend):
    torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.FileStore(store, n),
                            rank=rank, world_size=n)
    dev = torch.device("cuda", 0)
    group = dist.new_group(list(range(n)))
    res = {}
    for dt in DTYPES:
        name = str(dt).split(".")[-1]

        def all_reduce(dt=dt):
            x = torch.full((5,), rank + 1, dtype=dt, device=dev)
            dist.all_reduce(x)
            return x.float().tolist()

        def broadcast(dt=dt):
            x = torch.full((3,), rank + 7, dtype=dt, device=dev)
            dist.broadcast(x, 0)
            return x.float().tolist()

        def all_gather(dt=dt):
            xs = [torch.empty(2, dtype=dt, device=dev) for _ in range(n)]
            dist.all_gather(xs, torch.full((2,), rank, dtype=dt, device=dev))
            return [t.float().tolist() for t in xs]

        def all_gather_into_tensor(dt=dt):
            out = torch.empty(2 * n, dtype=dt, device=dev)
            dist.all_gather_into_tensor(
                out, torch.full((2,), rank, dtype=dt, device=dev))
            return out.float().tolist()

        def reduce_scatter_tensor(dt=dt):
            out = torch.empty(2, dtype=dt, device=dev)
            dist.reduce_scatter_tensor(out, torch.arange(
                2 * n, dtype=dt, device=dev) + rank)
            return out.float().tolist()

        def reduce_scatter(dt=dt):
            out = torch.empty(2, dtype=dt, device=dev)
            dist.reduce_scatter(out, [torch.full((2,), r + rank, dtype=dt,
                                                 device=dev)
                                      for r in range(n)])
            return out.float().tolist()

        def group_all_reduce(dt=dt):
            x = torch.full((5,), rank + 1, dtype=dt, device=dev)
            dist.all_reduce(x, group=group)
            return x.float().tolist()

        def group_all_gather_into_tensor(dt=dt):
            out = torch.empty(2 * n, dtype=dt, device=dev)
            dist.all_gather_into_tensor(
                out, torch.full((2,), rank, dtype=dt, device=dev),
                group=group)
            return out.float().tolist()

        for fn in (all_reduce, broadcast, all_gather, all_gather_into_tensor,
                   reduce_scatter_tensor, reduce_scatter, group_all_reduce,
                   group_all_gather_into_tensor):
            try:
                out = fn()
                torch.cuda.synchronize()
                res[f"{fn.__name__}_{name}"] = ["ok", out]
            except Exception as e:  # the probe's answer, not a failure
                res[f"{fn.__name__}_{name}"] = [
                    "error", f"{type(e).__name__}: {str(e)[:160]}"]
    dist.destroy_process_group()
    if rank == 0:
        print("PROBE", backend, json.dumps(res), flush=True)


def main():
    print(sys.version, torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo"}
    for backend in ("gloo", "nccl"):
        with tempfile.TemporaryDirectory() as d:
            procs = [subprocess.Popen(
                [sys.executable, __file__, str(r), "2",
                 os.path.join(d, "store"), backend], env=env)
                for r in range(2)]
            for p in procs:
                try:
                    p.wait(timeout=90)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            print(backend, "exit codes", [p.returncode for p in procs],
                  flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                  sys.argv[4])
    else:
        main()
