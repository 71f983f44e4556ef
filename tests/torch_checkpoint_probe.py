"""Where the time of chip_smoke.py's train_8b_checkpoint and
rllib_offline_gridworld goes, on one NVIDIA GPU (not a pytest file).

    python3 tests/torch_checkpoint_probe.py

Save: the tensors of train_8b_checkpoint's state (the Llama-3-8B widths at
1 layer: each f32 parameter and its two AdamW moments, 15.2 GB) written
with torch.save under tempfile.gettempdir() as save_pytree writes them,
with torch's two save switches (the CRC-32 of each record; a pinned
buffer for each device-to-host copy) off and on, each timed once; beside
them the device-to-host copies alone (pageable, one tensor at a time) and
a plain write of host bytes of the same size. Load: the file read back
with mmap into the device's tensors, as load_pytree reads it (warm: the
file was just written). The switches are set for this process only and
restored.

Offline: one CQL train() pass at batch 64 (12 updates) on the reference
test's data under torch.profiler, after a warm pass: the wall time, the
device's busy share, and the host operators and kernels that took the
most time.

One JSON line a measurement; the line before the last is the card's name
and power limit from nvidia-smi.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
GB = 1e9


def emit(obj):
    print(json.dumps(obj), flush=True)


def state_tensors(dev):
    """f32 tensors of train_8b_checkpoint's state shapes on ``dev``."""
    import dataclasses

    from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=1)
    shapes = {n: p.shape for n, p in
              LlamaModel(cfg, device="meta").named_parameters()}
    return {f"{part}.{n}": torch.ones(s, dtype=torch.float32, device=dev)
            for part in ("param", "exp_avg", "exp_avg_sq")
            for n, s in shapes.items()}


def save_rates(dev, root):
    from torch.utils.serialization import config

    tree = state_tensors(dev)
    nbytes = sum(t.numel() * t.element_size() for t in tree.values())
    torch.cuda.synchronize()
    t = time.perf_counter()
    for v in tree.values():
        v.cpu()
    s = time.perf_counter() - t
    emit({"what": "d2h_pageable_one_at_a_time", "gb": nbytes / GB, "s": s,
          "gb_per_s": nbytes / GB / s})
    path = os.path.join(root, "probe.pt")
    old = (config.save.compute_crc32, config.save.use_pinned_memory_for_d2h)
    try:
        for crc, pinned in ((True, False), (False, False), (True, True),
                            (False, True)):
            config.save.compute_crc32 = crc
            config.save.use_pinned_memory_for_d2h = pinned
            t = time.perf_counter()
            torch.save(tree, path)
            s = time.perf_counter() - t
            emit({"what": "torch_save", "crc32": crc, "pinned_d2h": pinned,
                  "gb": os.path.getsize(path) / GB, "s": s,
                  "gb_per_s": os.path.getsize(path) / GB / s})
            if (crc, pinned) != (False, True):
                os.remove(path)
    finally:
        config.save.compute_crc32, config.save.use_pinned_memory_for_d2h = old
    t = time.perf_counter()
    loaded = torch.load(path, map_location="cpu", weights_only=True,
                        mmap=True)
    for n, v in tree.items():
        v.copy_(loaded[n])
    torch.cuda.synchronize()
    s = time.perf_counter() - t
    emit({"what": "load_mmap_into_device_warm", "gb": nbytes / GB, "s": s,
          "gb_per_s": nbytes / GB / s})
    del loaded
    os.remove(path)
    block = np.ones(1 << 28, np.float32)  # 1.07 GB
    n = int(np.ceil(nbytes / block.nbytes))
    raw = os.path.join(root, "probe.raw")
    t = time.perf_counter()
    with open(raw, "wb") as f:
        for _ in range(n):
            block.tofile(f)
    s = time.perf_counter() - t
    emit({"what": "plain_write_host_bytes", "gb": n * block.nbytes / GB,
          "s": s, "gb_per_s": n * block.nbytes / GB / s})
    os.remove(raw)


def offline_profile(dev):
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from ray_tpu_torch.rllib import bc as tbc
    from ray_tpu_torch.rllib import cql as tcql

    _, cql = chip_smoke.offline_configs(tbc, tcql,
                                        chip_smoke.offline_dataset())
    algo = cql.build(device=dev)
    algo.train()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        r = algo.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    emit(chip_smoke.profile_summary("cql_pass_profile", prof, wall,
                                    updates=r["num_batches"],
                                    ms_per_update=1e3 * wall
                                    / r["num_batches"]))


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    root = tempfile.mkdtemp(prefix="ray_tpu_torch_probe_")
    try:
        emit({"dir": root, "free_gb": shutil.disk_usage(root).free / GB})
        save_rates(dev, root)
        offline_profile(dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
