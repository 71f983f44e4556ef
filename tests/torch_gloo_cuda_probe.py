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

Then, with gloo only, the point-to-point calls a rotation of blocks
between ranks could use: send/recv, isend/irecv and batch_isend_irecv (also
over a new_group), each rank swapping a tensor with the other: all on CPU
tensors in one pair of processes (the control), then each on CUDA tensors
of f32 and of bf16 in a pair of its own, since one that cannot send a CUDA
tensor kills its process (gloo's TCP pair writes from the device pointer:
"writev ... Bad address"). Rank 0 prints one "P2P" line a call and each
pair's exit codes follow. Last, the milliseconds of swapping a 16 MiB bf16
CUDA block: by all_gather_into_tensor, and through pinned CPU copies by
batch_isend_irecv. ring.py's ppermute takes all_gather_into_tensor, the
one route that works on CUDA and CPU tensors alike.
"""

import datetime
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int32,
          torch.int64)


def rank_main(rank, n, store, backend):
    torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.FileStore(store, n),
                            rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=30))
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


def p2p_main(rank, n, store, case):
    """Each rank swaps a tensor with the other (n = 2) by one
    point-to-point call: ``case`` is "cpu" (every call on CPU tensors),
    "<call>-<dtype>" (that call on CUDA tensors), or "rotate" (the
    timings). Rank 0 prints each result as it returns."""
    dist.init_process_group("gloo", store=dist.FileStore(store, n),
                            rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=30))
    group = dist.new_group(list(range(n)))
    peer = 1 - rank
    cuda = torch.device("cuda", 0)
    torch.cuda.set_device(0)
    if case == "rotate":
        rotate_timing(rank, peer, cuda)
    else:
        cases = ([("cpu", dt) for dt in P2P_DTYPES] if case == "cpu" else
                 [(cuda, getattr(torch, case.split("-")[1]))])
        calls = P2P_CALLS if case == "cpu" else [case.split("-")[0]]
        for call in calls:
            for dev, dt in cases:
                name = f"{call}_{torch.device(dev).type}_" \
                       f"{str(dt).split('.')[-1]}"
                x = torch.full((4,), rank + 1, dtype=dt, device=dev)
                y = torch.zeros(4, dtype=dt, device=dev)
                try:
                    p2p(call, x, y, rank, peer, group)
                    torch.cuda.synchronize()
                    got = y.float().tolist()
                    res = ["ok" if got == [peer + 1.0] * 4 else "wrong", got]
                except Exception as e:  # the probe's answer, not a failure
                    res = ["error", f"{type(e).__name__}: {str(e)[:160]}"]
                if rank == 0:
                    print("P2P", name, json.dumps(res), flush=True)
    dist.destroy_process_group()


P2P_CALLS = ("send_recv", "isend_irecv", "batch_isend_irecv",
             "group_batch_isend_irecv")
P2P_DTYPES = (torch.float32, torch.bfloat16)


def p2p(call, x, y, rank, peer, group):
    """Send x to ``peer`` and receive its x into y, by ``call``."""
    if call == "send_recv":
        if rank == 0:
            dist.send(x, peer)
            dist.recv(y, peer)
        else:
            dist.recv(y, peer)
            dist.send(x, peer)
        return
    if call == "isend_irecv":
        reqs = [dist.isend(x, peer), dist.irecv(y, peer)]
    else:
        g = group if call == "group_batch_isend_irecv" else None
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer, g),
                                       dist.P2POp(dist.irecv, y, peer, g)])
    for r in reqs:
        r.wait()


def rotate_timing(rank, peer, cuda):
    """Milliseconds of swapping a 16 MiB bf16 CUDA block between the two
    ranks: all_gather_into_tensor on the CUDA tensors, and
    batch_isend_irecv through pinned CPU copies."""
    blk = torch.full((8 << 20,), rank, dtype=torch.bfloat16, device=cuda)
    out = torch.empty(2 * blk.numel(), dtype=blk.dtype, device=cuda)
    host = torch.empty(blk.numel(), dtype=blk.dtype, pin_memory=True)
    back = torch.empty_like(host)

    def by_gather():
        dist.all_gather_into_tensor(out, blk)
        return out[peer * blk.numel():(peer + 1) * blk.numel()].clone()

    def by_host_p2p():
        host.copy_(blk)
        p2p("batch_isend_irecv", host, back, rank, peer, None)
        return back.to(cuda)

    timing = {}
    for fn in (by_gather, by_host_p2p):
        try:
            ms = []
            for _ in range(6):
                dist.barrier()
                torch.cuda.synchronize()
                t = time.perf_counter()
                got = fn()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
            timing[fn.__name__] = {"ok": bool((got == peer).all()),
                                   "ms": ms[1:]}
        except Exception as e:  # the probe's answer, not a failure
            timing[fn.__name__] = f"{type(e).__name__}: {str(e)[:160]}"
    if rank == 0:
        print("ROTATE_16MiB", json.dumps(timing), flush=True)


def run_pair(args, env, timeout):
    """Two rank processes of this file with ``args`` after the rank; their
    exit codes (a process still there after ``timeout`` s is killed)."""
    with tempfile.TemporaryDirectory() as d:
        procs = [subprocess.Popen(
            [sys.executable, __file__, str(r), "2",
             os.path.join(d, "store"), *args], env=env) for r in range(2)]
        for p in procs:
            try:
                p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        return [p.returncode for p in procs]


def main():
    print(sys.version, torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo"}
    for backend in ("gloo", "nccl"):
        print(backend, "exit codes", run_pair([backend], env, 90),
              flush=True)
    # A point-to-point call that takes a CUDA tensor it cannot send kills
    # its process: one pair a case.
    cases = ["cpu"] + [f"{c}-{str(dt).split('.')[-1]}" for c in P2P_CALLS
                       for dt in P2P_DTYPES] + ["rotate"]
    for case in cases:
        print("p2p", case, "exit codes",
              run_pair(["gloo-p2p", case], env, 90), flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[4] == "gloo-p2p":
        p2p_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                 sys.argv[5])
    elif len(sys.argv) > 1:
        rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                  sys.argv[4])
    else:
        main()
