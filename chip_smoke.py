#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ray_tpu_torch/csrc with nvcc, holds each
kernel against its plain PyTorch version on the card, checks the tiny f32
engine against a full-recompute oracle, then serves Llama-3-8B (all 32
layers, bf16, seeded random weights) through LLMServer and teacher-forces
the answers through the cacheless flash forward. Each phase prints one JSON
line; the line before the last repeats the card's name and power limit
from nvidia-smi, and the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Exits non-zero, with no result, when CUDA is absent or the port's package
is not beside this file, and when any check fails.
"""

import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): bytes/s of HBM3 and
# flop/s for bf16 tensor cores and for plain f32 (the f32 paths use no
# tensor cores: TF32 is off).
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Limits (atol, rtol) of allclose, kernel against its plain version on the
# same inputs. f32: the order of f32 sums only, held to the JAX tests' 2e-5.
# bf16: both sides round the output to bf16, so rtol covers one ulp of |out|
# (2^-8..2^-7 of it); K1 also rounds P to bf16 before P·V, as the Pallas
# kernel does, hence its 2e-2. atol is a few bf16 ulps of the typical |out|
# of a long row (~0.03 for K1's S=2048 rows, ~0.1 for K4's decode rows), so
# an off-by-one in a mask (a change of ~1/S of a row) fails. Every case
# prints limit_used = max |out - ref| / (atol + rtol |ref|), which must not
# pass 1.
TOL = {("K1", torch.bfloat16): (4e-3, 2e-2),
       ("K1", torch.float32): (2e-5, 2e-5),
       ("K4", torch.bfloat16): (2e-3, 1e-2),
       ("K4", torch.float32): (2e-5, 2e-5)}
LSE_TOL = 1e-3
# Teacher-forced check at 8B: a generated token's logit in the cacheless
# flash forward is within this of its row's maximum. The decode path (K4,
# batch-8 products) and the cacheless path (K1, batch-1408 products) round
# activations to bf16 at different places through 32 layers; 0.25 is 8
# bf16 ulps of a logit in [4, 8).
TEACHER_TOL = 0.25

failures = []


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(ok, what):
    if not ok:
        failures.append(what)


# Device cycles of the spin queued ahead of a timed loop (~50 ms at the
# H100's 1.98 GHz): long enough for the host to queue every timed call
# behind it.
SPIN_CYCLES = 100_000_000


def cuda_ms(fn, arg_sets, iters=20, warmup=3):
    """Mean device ms per call, cycling through arg_sets (copies of the
    inputs whose touched bytes together pass twice the 50 MB L2, so no
    call finds its inputs in L2). A spin kernel queued first holds the
    card while the host queues all the calls, so they run back to back and
    the host's time between launches is not counted."""
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def copies(tensors, touched):
    """Enough copies of the tensors that the bytes one call touches in
    each (``touched``) add up past twice the 50 MB L2."""
    n = max(1, math.ceil(100e6 / max(touched, 1)))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def limit_used(out, ref, atol, rtol):
    """max |out - ref| / (atol + rtol |ref|): allclose passes iff <= 1."""
    out, ref = out.float(), ref.float()
    return ((out - ref).abs() / (atol + rtol * ref.abs())).max().item()


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
def k1_case(attn, label, b, s, h, hkv, d, dtype, causal, seed, dev,
            time_it=True):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
               for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))
    out, lse = attn.flash_fwd_kernel(q, k, v, causal=causal)
    ref, ref_lse = attn.flash_attention_fwd_plain(q, k, v, causal)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    atol, rtol = TOL["K1", dtype]
    used = limit_used(out, ref, atol, rtol)
    ok = (used <= 1 and lse_err <= LSE_TOL
          and bool(torch.isfinite(out).all()))
    check(ok, f"K1 {label}")
    row = {"phase": "k1_check", "case": label, "shape": [b, s, h, hkv, d],
           "dtype": str(dtype).split(".")[-1], "causal": causal,
           "max_abs_err": err, "lse_max_abs_err": lse_err, "atol": atol,
           "rtol": rtol, "limit_used": used, "ok": ok}
    if time_it:
        pairs = s * (s + 1) // 2 if causal else s * s
        flops = 4 * b * h * d * pairs
        io = nbytes(q, k, v, out, lse)
        sets = copies((q, k, v), io)
        row["ms"] = cuda_ms(
            lambda q, k, v: attn.flash_fwd_kernel(q, k, v, causal=causal),
            sets)
        row["plain_ms"] = cuda_ms(
            lambda q, k, v: attn.flash_attention_fwd_plain(q, k, v, causal),
            sets, iters=5)
        row["library_ms"] = cuda_ms(lambda q, k, v: _sdpa(q, k, v, causal),
                                    sets)
        row["bound_ms"], row["bound_by"] = bound(io, flops, dtype)
        row["tflops"] = flops / row["ms"] / 1e9
    emit(row)
    return row


def _sdpa(q, k, v, causal):
    """The yardstick: PyTorch's fused attention on the same inputs."""
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal, enable_gqa=True).transpose(1, 2)


def k4_inputs(dev, dtype, seq_lens, seed, B=8, H=32, HK=8, D=128, PS=64,
              MP=8):
    """The 8B engine's decode shapes; the page table is a permutation."""
    g = torch.Generator(device=dev).manual_seed(seed)
    P = B * MP + 1
    q = torch.randn((B, 1, H, D), generator=g, device=dev).to(dtype)
    kp = torch.randn((HK, P, PS, D), generator=g, device=dev).to(dtype)
    vp = torch.randn((HK, P, PS, D), generator=g, device=dev).to(dtype)
    perm = np.random.default_rng(seed).permutation(P)[:B * MP]
    pt = torch.tensor(perm.reshape(B, MP), dtype=torch.int32, device=dev)
    lens = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
    return q, kp, vp, pt, lens


def k4_case(paged, label, dtype, seq_lens, seed, dev):
    q, kp, vp, pt, lens = k4_inputs(dev, dtype, seq_lens, seed)
    out = paged.paged_attention_decode_kernel(q, kp, vp, pt, lens)
    ref = paged.paged_decode_plain(q, kp, vp, pt, lens)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    atol, rtol = TOL["K4", dtype]
    used = limit_used(out, ref, atol, rtol)
    ok = used <= 1 and bool(torch.isfinite(out).all())
    check(ok, f"K4 {label}")
    B, _, H, D = q.shape
    HK, PS, MP = kp.shape[0], kp.shape[2], pt.shape[1]
    tokens = sum(min(n, MP * PS) for n in seq_lens)
    # Each real token's K and V row of every kv head, read once.
    kv_bytes = 2 * tokens * HK * D * kp.element_size()
    io = nbytes(q, out, pt, lens) + kv_bytes
    flops = 4 * tokens * H * D
    # The kernel reads only the real pages, so the copies are counted by
    # those bytes, not by the whole pools.
    sets = copies((q, kp, vp, pt, lens), io)
    row = {"phase": "k4_check", "case": label,
           "shape": {"B": B, "H": H, "HK": HK, "D": D, "ps": PS, "MP": MP},
           "seq_lens": list(seq_lens), "dtype": str(dtype).split(".")[-1],
           "max_abs_err": err, "atol": atol, "rtol": rtol,
           "limit_used": used, "ok": ok, "copies": len(sets),
           "ms": cuda_ms(paged.paged_attention_decode_kernel, sets),
           "plain_ms": cuda_ms(paged.paged_decode_plain, sets, iters=5),
           "library_ms": None}
    row["bound_ms"], row["bound_by"] = bound(io, flops, dtype)
    row["gbps"] = io / row["ms"] / 1e6
    emit(row)
    return row


# ---------------------------------------------------------------------------
def tiny_engine_phase(dev):
    """Tiny f32 engine on the card: greedy tokens equal a full-recompute
    oracle exactly (tests/test_llm_engine.py:50-78)."""
    from ray_tpu_torch.llm import EngineConfig, LLMEngine, Request
    from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel, init_params

    model = LlamaModel(LlamaConfig.tiny(vocab_size=128), device=dev)
    init_params(model, torch.Generator(device=dev).manual_seed(0))
    prompts = {"a": [1, 2, 3], "b": [9, 8, 7, 6, 5], "c": [100, 3],
               "d": [11, 22, 33, 44]}
    expect = {}
    with torch.no_grad():
        for rid, p in prompts.items():
            ids = list(p)
            for _ in range(6):
                nxt = int(model(torch.tensor([ids], device=dev))[0, -1]
                          .argmax())
                ids.append(nxt)
            expect[rid] = ids[len(p):]
    eng = LLMEngine(model, None, EngineConfig(
        max_seqs=2, page_size=4, max_pages_per_seq=16), device=dev)
    for rid, p in prompts.items():
        eng.add_request(Request(rid, p, max_tokens=6))
    got = {}
    while eng.has_work():
        for so in eng.step():
            got.setdefault(so.request_id, []).append(so.token)
    ok = got == expect
    check(ok, "tiny engine vs oracle")
    emit({"phase": "tiny_engine", "tokens": got, "oracle": expect, "ok": ok})


def entry_phase(dev):
    """entry(): the tiny flash forward (K1, f32) against the same weights
    through plain attention."""
    import dataclasses

    from ray_tpu_torch.entry import entry
    from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel, load_params

    fn, (params, ids) = entry()
    ids = torch.randint(0, 512, ids.shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    out = fn(params, ids)
    ref_model = LlamaModel(dataclasses.replace(
        LlamaConfig.tiny(), attention_impl="reference"), device=dev)
    load_params(ref_model, params)
    with torch.no_grad():
        ref = ref_model(ids)
    err = (out - ref).abs().max().item()
    ok = err <= 1e-4 and bool(torch.isfinite(out).all())
    check(ok, "entry flash vs reference")
    emit({"phase": "entry", "shape": list(out.shape), "max_abs_err": err,
          "tol": 1e-4, "ok": ok})


def serve_8b_phase(dev, attn, paged):
    """Llama-3-8B width, 32 layers, bf16: waves of 8 requests of 128 prompt
    tokens, 48 new tokens each; one warm wave, then three measured ones,
    each checked by a teacher-forced cacheless forward (K1) over prompt +
    answer."""
    from ray_tpu_torch.llm import LLMServer

    n_req, prompt_len, max_tokens, K, n_waves = 8, 128, 48, 8, 3
    t0 = time.perf_counter()
    srv = LLMServer({"model": "llama3-8b", "seed": 0, "engine_config": {
        "max_seqs": 8, "page_size": 64, "max_pages_per_seq": 8,
        "decode_steps": K}}, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg = srv.model.cfg
    rng = np.random.default_rng(0)

    def wave():
        prompts = [rng.integers(0, cfg.vocab_size, prompt_len).tolist()
                   for _ in range(n_req)]
        res = [None] * n_req

        def go(i):
            res[i] = srv.generate_all(prompts[i], max_tokens=max_tokens)

        threads = [threading.Thread(target=go, args=(i,))
                   for i in range(n_req)]
        t = time.perf_counter()
        # The whole wave reaches the engine in one admission: the engine
        # thread waits until all n_req requests are queued.
        with srv.paused():
            for th in threads:
                th.start()
            while srv.stats()["pending"] < n_req:
                if time.perf_counter() - t > 60:
                    raise RuntimeError("requests did not reach the server")
                time.sleep(0.001)
        for th in threads:
            th.join(600)
        return prompts, res, time.perf_counter() - t

    try:
        wave()  # warm: first launches, allocator growth
        attn.flash_fwd_kernel.launches = 0
        paged.paged_attention_decode_kernel.launches = 0
        torch.cuda.reset_peak_memory_stats()
        waves = [wave() for _ in range(n_waves)]
        k4_serving = paged.paged_attention_decode_kernel.launches
        gaps, finite = [], True
        for prompts, res, _ in waves:
            ids = torch.tensor([p + r["tokens"]
                                for p, r in zip(prompts, res)], device=dev)
            with torch.no_grad():
                logits = srv.model(ids).float()
            finite = finite and bool(torch.isfinite(logits).all())
            for b, r in enumerate(res):
                for i, tok in enumerate(r["tokens"]):
                    row = logits[b, prompt_len - 1 + i]
                    gaps.append((row.max() - row[tok]).item())
        torch.cuda.synchronize()
        k1_forward = attn.flash_fwd_kernel.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        srv.shutdown()
        profile = profile_engine(srv.engine, [
            rng.integers(0, cfg.vocab_size, prompt_len).tolist()
            for _ in range(n_req)], max_tokens)
    finally:
        srv.shutdown()
    ok_tokens = all(len(r["tokens"]) == max_tokens
                    for _, res, _ in waves for r in res)
    ok_gap = max(gaps) <= TEACHER_TOL and finite
    # Each wave is one admission: the prefill gives each request its first
    # token, then ceil((max_tokens - 1) / K) windows of K steps give the
    # rest, one K4 launch per layer and step. A wave split in two needs one
    # window more, and fails here.
    k4_expected = (n_waves * cfg.num_layers * K
                   * math.ceil((max_tokens - 1) / K))
    ok_launch = (k4_serving == k4_expected
                 and k1_forward == n_waves * cfg.num_layers)
    check(ok_tokens and ok_gap and ok_launch, "8B serving")
    walls = [w for _, _, w in waves]
    tps = [sum(len(r["tokens"]) for r in res) / w for _, res, w in waves]
    ttft_mean = [float(np.mean([r["ttft_s"] for r in res]))
                 for _, res, _ in waves]
    ttft_max = [max(r["ttft_s"] for r in res) for _, res, _ in waves]
    emit({"phase": "serve_8b", "layers": cfg.num_layers, "dtype": "bfloat16",
          "requests": n_req, "prompt_tokens": prompt_len,
          "max_tokens": max_tokens, "decode_steps": K, "waves": n_waves,
          "setup_s": setup_s, "wall_s": walls,
          "tokens_per_s": tps, "tokens_per_s_median": float(np.median(tps)),
          "ttft_mean_s": ttft_mean, "ttft_max_s": ttft_max,
          "ttft_mean_s_median": float(np.median(ttft_mean)),
          "peak_mem_gb": peak_gb,
          "teacher_max_gap": max(gaps), "teacher_tol": TEACHER_TOL,
          "launches": {"paged_decode": k4_serving, "flash_fwd": k1_forward},
          "paged_decode_expected": k4_expected,
          "ok": ok_tokens and ok_gap and ok_launch})
    emit(profile)
    return {"flash_fwd": k1_forward, "paged_decode": k4_serving,
            "decode_seq_len": prompt_len + max_tokens,
            "forward_shape": list(ids.shape)}


def profile_engine(engine, prompts, max_tokens):
    """One more wave through the server's engine, stepped from this thread
    (the server's thread is stopped) under torch.profiler: the device's
    busy share of the wave's wall time and the operators that take the
    most device and host time. The profiler slows the host, so this wall
    time is not the measured one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.llm import Request

    for i, p in enumerate(prompts):
        engine.add_request(Request(f"prof{i}", p, max_tokens=max_tokens))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        steps = 0
        while engine.has_work():
            engine.step()
            steps += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    ev = prof.key_averages()
    # Kernel rows only: an operator's row repeats its kernels' device time.
    kernels = [e for e in ev if e.device_type != DeviceType.CPU]
    ops = [e for e in ev if e.device_type == DeviceType.CPU]
    dev_us = sum(e.self_device_time_total for e in kernels)

    def top(rows, key):
        rows = sorted(rows, key=lambda e: getattr(e, key), reverse=True)[:10]
        return [[e.key[:60], e.count, getattr(e, key) / 1e3] for e in rows]

    return {"phase": "serve_8b_profile", "wall_s": wall,
            "engine_steps": steps,
            "kernel_launches": sum(e.count for e in kernels),
            "device_busy_s": dev_us / 1e6,
            "device_busy_share": dev_us / 1e6 / wall,
            "top_kernels_ms": top(kernels, "self_device_time_total"),
            "top_host_ops_ms": top(ops, "self_cpu_time_total")}


# ---------------------------------------------------------------------------
def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from ray_tpu_torch import native
    from ray_tpu_torch.llm._internal import paged
    from ray_tpu_torch.ops import attention as attn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    native.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {n: [ln.split(":", 1)[-1].strip()
                        for ln in log.splitlines() if "Used" in ln]
                    for n, log in native.build_logs.items()}})

    # K1 against flash_attention_fwd_plain.
    for causal in (True, False):
        k1_case(attn, f"8b_bf16_{'causal' if causal else 'full'}", 1, 2048,
                32, 8, 128, torch.bfloat16, causal, 0, dev)
    k1_case(attn, "small_f32_causal", 2, 256, 4, 2, 64, torch.float32, True,
            1, dev)
    k1_case(attn, "ragged_f32_full", 1, 200, 4, 1, 32, torch.float32, False,
            2, dev, time_it=False)
    k1_case(attn, "ragged_bf16_d64", 2, 200, 8, 2, 64, torch.bfloat16, True,
            3, dev, time_it=False)
    k1_case(attn, "ragged_bf16_d32", 1, 77, 4, 2, 32, torch.bfloat16, True,
            4, dev, time_it=False)

    # K4 against paged_decode_plain.
    lens = [1, 63, 64, 65, 130, 200, 511, 512]
    for dtype in (torch.bfloat16, torch.float32):
        k4_case(paged, f"8b_{str(dtype).split('.')[-1]}", dtype, lens, 5,
                dev)

    tiny_engine_phase(dev)
    entry_phase(dev)
    main_path = serve_8b_phase(dev, attn, paged)

    # Both kernels at the shapes the main path gave them.
    b, s = main_path["forward_shape"]
    k1 = k1_case(attn, "main_path_forward", b, s, 32, 8, 128,
                 torch.bfloat16, True, 6, dev)
    k4 = k4_case(paged, "main_path_decode", torch.bfloat16,
                 [main_path["decode_seq_len"]] * 8, 7, dev)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    emit({"kernels": [
        {"name": "flash_fwd", "route": "cuda",
         "source": "ray_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "ray_tpu/ops/attention.py:105",
         "launches": main_path["flash_fwd"], **{k: k1[k] for k in keys}},
        {"name": "paged_decode", "route": "cuda",
         "source": "ray_tpu_torch/csrc/paged_decode.cu",
         "replaces": "ray_tpu/llm/_internal/paged.py:115",
         "launches": main_path["paged_decode"], **{k: k4[k] for k in keys}},
    ]})
    if failures:
        print(f"chip_smoke: FAILED: {failures}", file=sys.stderr)
        return 1
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
