#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ray_tpu_torch/csrc with nvcc, holds each
kernel against its plain PyTorch version on the card, checks the tiny f32
engine against a full-recompute oracle and the tiny f32 train step with
flash attention (K1, K2, K3) against the same step with plain attention,
serves Llama-3-8B (all 32 layers, bf16, seeded random weights) through
LLMServer and teacher-forces the answers through the cacheless flash
forward, then trains at the Llama-3-8B widths (8 of 32 layers, bf16 compute
over f32 parameters, AdamW) through the flash forward and backward kernels.
Each phase prints one JSON line; the line before the last repeats the
card's name and power limit from nvidia-smi, and the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Exits non-zero, with no result, when CUDA is absent or the port's package
is not beside this file, and when any check fails.
"""

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
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
# pass 1. K2/K3 (gradients, bf16): rtol 2e-2 covers one bf16 ulp of |grad|
# and the rounding of P and dS to bf16 before their products, as the Pallas
# kernels round them; atol is about one ulp of a gradient element near 2.
# Every causal case also holds the kernels, at the same limits, against the
# gradients of a causal mask off by one key, which must fail
# (off_by_one_limit_used > 1).
TOL = {("K1", torch.bfloat16): (4e-3, 2e-2),
       ("K1", torch.float32): (2e-5, 2e-5),
       ("K2", torch.bfloat16): (1e-2, 2e-2),
       ("K2", torch.float32): (2e-5, 2e-5),
       ("K3", torch.bfloat16): (1e-2, 2e-2),
       ("K3", torch.float32): (2e-5, 2e-5),
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
# Host clock at the start of main(): each phase line carries the seconds
# since then ("t_s"), so the run's time can be split by phase.
start = {"t": time.perf_counter()}


def emit(obj):
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - start["t"]}
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


def ptxas_report(log):
    """"kernel<D>: registers, shared memory" for each entry function in
    nvcc's -Xptxas -v output."""
    rows, name = [], "?"
    types = {"f": "<f32>", "13__nv_bfloat16": "<bf16>"}
    for ln in log.splitlines():
        # The last flash_/paged_ name in the mangled symbol is the kernel's
        # (the first is the anonymous namespace's, named after the file).
        m = re.search(r"Compiling entry function '.*((?:flash|paged)_[a-z0-9_]+)"
                      r"(?:I(?:Li(\d+)|(f|13__nv_bfloat16))E)?", ln)
        if m:
            name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else
                                 types.get(m.group(3), ""))
        elif "Used" in ln:
            rows.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    return rows


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


def k2k3_case(attn, label, b, s, h, hkv, d, dtype, causal, seed, dev,
              time_it=True):
    """K2 (dQ) and K3 (dK, dV) against flash_attention_bwd_plain on the same
    inputs, with K1's out and lse and the same Delta."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(dtype)
                   for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d),
                                 (b, s, h, d)))
    out, lse = attn.flash_fwd_kernel(q, k, v, causal=causal)
    delta = attn.flash_bwd_delta(out, do)
    dq = attn.flash_bwd_dq_kernel(q, k, v, do, lse, delta, causal=causal)
    dk, dv = attn.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, causal=causal)
    refs = attn.flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
    # Deterministic gradients: a second launch on the same inputs gives
    # the same bits (no atomics, a fixed order of every sum).
    again = (attn.flash_bwd_dq_kernel(q, k, v, do, lse, delta, causal=causal),
             *attn.flash_bwd_dkv_kernel(q, k, v, do, lse, delta,
                                        causal=causal))
    torch.cuda.synchronize()
    row = {"phase": "k2k3_check", "case": label, "shape": [b, s, h, hkv, d],
           "dtype": str(dtype).split(".")[-1], "causal": causal,
           "bitwise_repeat": all(torch.equal(x, y)
                                 for x, y in zip((dq, dk, dv), again))}
    ok = row["bitwise_repeat"]
    del again
    for name, kern, got, ref in (("dq", "K2", dq, refs[0]),
                                 ("dk", "K3", dk, refs[1]),
                                 ("dv", "K3", dv, refs[2])):
        atol, rtol = TOL[kern, dtype]
        used = limit_used(got, ref, atol, rtol)
        ok = ok and used <= 1 and bool(torch.isfinite(got).all())
        row[name] = {"max_abs_err": (got.float() - ref.float()).abs().max()
                     .item(), "max_abs_ref": ref.float().abs().max().item(),
                     "atol": atol, "rtol": rtol, "limit_used": used}
    if causal:
        qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
        shifted = torch.autograd.grad(
            attn.attention_reference(qf, kf, vf, causal=True, q_offset=1),
            (qf, kf, vf), do.float())
        row["off_by_one_limit_used"] = min(
            limit_used(got, ref, *TOL[kern, dtype])
            for kern, got, ref in (("K2", dq, shifted[0]),
                                   ("K3", dk, shifted[1]),
                                   ("K3", dv, shifted[2])))
        ok = ok and row["off_by_one_limit_used"] > 1
        del qf, kf, vf, shifted
    check(ok, f"K2/K3 {label}")
    row["ok"] = ok
    if time_it:
        pairs = s * (s + 1) // 2 if causal else s * s
        io_dq = nbytes(q, k, v, do, lse, delta, dq)
        io_dkv = nbytes(q, k, v, do, lse, delta, dk, dv)
        sets = copies((q, k, v, out, do, lse, delta), io_dkv)
        row["dq_ms"] = cuda_ms(
            lambda q, k, v, o, do, lse, dl: attn.flash_bwd_dq_kernel(
                q, k, v, do, lse, dl, causal=causal), sets)
        row["dkv_ms"] = cuda_ms(
            lambda q, k, v, o, do, lse, dl: attn.flash_bwd_dkv_kernel(
                q, k, v, do, lse, dl, causal=causal), sets)
        # Delta sits outside the pair but inside SDPA's backward, so the
        # pair is read against the library as K2 + K3 + Delta.
        row["delta_ms"] = cuda_ms(
            lambda q, k, v, o, do, lse, dl: attn.flash_bwd_delta(o, do),
            sets)
        row["pair_delta_ms"] = row["dq_ms"] + row["dkv_ms"] + row["delta_ms"]
        # The plain version computes dQ, dK and dV together.
        row["plain_ms"] = cuda_ms(
            lambda q, k, v, o, do, lse, dl: attn.flash_attention_bwd_plain(
                q, k, v, o, lse, do, causal), sets, iters=3, warmup=1)
        row["library_ms"] = _sdpa_bwd_ms(sets, causal)
        row["dq_bound_ms"], row["dq_bound_by"] = bound(
            io_dq, 6 * b * h * d * pairs, dtype)
        row["dkv_bound_ms"], row["dkv_bound_by"] = bound(
            io_dkv, 8 * b * h * d * pairs, dtype)
        row["dq_tflops"] = 6 * b * h * d * pairs / row["dq_ms"] / 1e9
        row["dkv_tflops"] = 8 * b * h * d * pairs / row["dkv_ms"] / 1e9
    emit(row)
    return row


def _sdpa_bwd_ms(sets, causal):
    """The yardstick of the K2 + K3 pair, never called by the port:
    PyTorch's fused attention forward and backward (torch.autograd.grad,
    GQA by enable_gqa) less its forward alone, on the same inputs."""
    def fwd_bwd(q, k, v, o, do, lse, dl):
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                             enable_gqa=True)
        return torch.autograd.grad(out, (qt, kt, vt), do.transpose(1, 2))

    both = cuda_ms(fwd_bwd, sets)
    fwd = cuda_ms(lambda q, k, v, *_: _sdpa(q, k, v, causal), sets)
    return both - fwd


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


def serve_8b_phase(dev, wrappers):
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
        zero_counts(wrappers)
        torch.cuda.reset_peak_memory_stats()
        waves = [wave() for _ in range(n_waves)]
        k4_serving = wrappers["paged_decode"].launches
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
        launches = read_counts(wrappers)
        k1_forward = launches["flash_fwd"]
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
                 and k1_forward == n_waves * cfg.num_layers
                 and launches["flash_bwd_dq"] == 0
                 and launches["flash_bwd_dkv"] == 0)
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
          "launches": launches,
          "paged_decode_expected": k4_expected,
          "ok": ok_tokens and ok_gap and ok_launch})
    emit(profile)
    return {**launches, "decode_seq_len": prompt_len + max_tokens,
            "forward_shape": list(ids.shape)}


def profile_engine(engine, prompts, max_tokens):
    """One more wave through the server's engine, stepped from this thread
    (the server's thread is stopped) under torch.profiler: the device's
    busy share of the wave's wall time and the operators that take the
    most device and host time. The profiler slows the host, so this wall
    time is not the measured one."""
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
    return profile_summary("serve_8b_profile", prof, wall,
                           engine_steps=steps)


def profile_summary(phase, prof, wall, **extra):
    """The device's busy share of ``wall`` and the kernels and host
    operators that took the most time in a torch.profiler window."""
    from torch.autograd import DeviceType

    ev = prof.key_averages()
    # Kernel rows only: an operator's row, and a range a library annotates
    # on the device (AdamW's "Optimizer.step"), repeat their kernels' time.
    kernels = [e for e in ev if e.device_type != DeviceType.CPU
               and not getattr(e, "is_user_annotation", False)]
    ops = [e for e in ev if e.device_type == DeviceType.CPU]
    dev_us = sum(e.self_device_time_total for e in kernels)

    def top(rows, key):
        rows = sorted(rows, key=lambda e: getattr(e, key), reverse=True)[:10]
        return [[e.key[:60], e.count, getattr(e, key) / 1e3] for e in rows]

    return {"phase": phase, "wall_s": wall, **extra,
            "kernel_launches": sum(e.count for e in kernels),
            "device_busy_s": dev_us / 1e6,
            "device_busy_share": dev_us / 1e6 / wall,
            "top_kernels_ms": top(kernels, "self_device_time_total"),
            "top_host_ops_ms": top(ops, "self_cpu_time_total")}


# ---------------------------------------------------------------------------
def zero_counts(wrappers):
    for w in wrappers.values():
        w.launches = 0


def read_counts(wrappers):
    return {name: w.launches for name, w in wrappers.items()}


@contextlib.contextmanager
def attention_impl(model, impl):
    """Run the model's attention through ``impl`` ("flash" or "reference")
    inside the block, on the same weights."""
    old = model.cfg
    new = dataclasses.replace(old, attention_impl=impl)
    mods = [m for m in model.modules() if getattr(m, "cfg", None) is old]
    for m in mods:
        m.cfg = new
    try:
        yield
    finally:
        for m in mods:
            m.cfg = old


# The tiny train step on the card is held to what the CPU test holds the
# port's step to against JAX's (tests/test_torch_train_step.py): loss within
# 1e-5 relative, weights within a tenth of the learning rate.
TINY_LOSS_RTOL = 1e-5
TINY_PARAM_ATOL = 1e-4


def train_tiny_phase(dev, wrappers):
    """The tiny f32 train step, 3 AdamW steps at lr 1e-3 on 2 x 64 tokens:
    flash attention (K1, K2 and K3 on their f32 paths) against plain
    attention from the same seeded weights."""
    from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step

    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, 512, (2, 64))).to(dev)
    runs = {}
    for impl in ("reference", "flash"):
        cfg = dataclasses.replace(LlamaConfig.tiny(), attention_impl=impl)
        model = LlamaModel(cfg, device=dev, param_dtype=torch.float32)
        opt = adamw(model.parameters(), 1e-3)
        state = init_train_state(model, opt, ids, device=dev,
                                 generator=torch.Generator(
                                     device=dev).manual_seed(3))
        step = make_train_step(model, opt)
        zero_counts(wrappers)
        losses = [step(state, ids, ids)[1].item() for _ in range(3)]
        runs[impl] = (losses, dict(model.named_parameters()),
                      read_counts(wrappers))
    (ref_losses, ref_p, ref_n), (losses, p, n) = runs["reference"], \
        runs["flash"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    param_err = max((p[k] - ref_p[k]).abs().max().item() for k in p)
    layers = LlamaConfig.tiny().num_layers
    want = {"flash_fwd": 3 * layers, "flash_bwd_dq": 3 * layers,
            "flash_bwd_dkv": 3 * layers, "paged_decode": 0}
    ok = (loss_rel <= TINY_LOSS_RTOL and param_err <= TINY_PARAM_ATOL
          and n == want and not any(ref_n.values())
          and all(math.isfinite(x) for x in losses))
    check(ok, "tiny train step flash vs reference")
    emit({"phase": "train_tiny", "losses": losses, "ref_losses": ref_losses,
          "loss_max_rel_err": loss_rel, "loss_rtol": TINY_LOSS_RTOL,
          "param_max_abs_err": param_err, "param_atol": TINY_PARAM_ATOL,
          "launches": n, "launches_expected": want, "ok": ok})


# Llama-3-8B widths cut to 8 of 32 layers: f32 weights, gradients and two
# AdamW moments take 16 B a parameter, 45 GB at 8 layers (2.79 B
# parameters) and 128 GB at 32, more than the card's 80 GB.
TRAIN_LAYERS = 8
# One step from the same weights and batch with flash and with plain
# attention: the losses agree within this (about 0.1 % of a loss near
# ln(128256) = 11.8; the two differ only by where attention rounds to
# bf16), and every q/k/v projection's weight gradient has a cosine
# similarity of at least TRAIN_COS.
TRAIN_LOSS_TOL = 1e-2
TRAIN_COS = 0.99
# H100 SXM bf16 dense peak (NVIDIA data sheet, at 700 W).
PEAK_BF16 = 989e12


def train_8b_phase(dev, wrappers):
    """Training at the Llama-3-8B widths: bf16 compute over f32 parameters,
    remat on, AdamW at lr 3e-4 (ray_tpu/benchmarks/model_bench.py:105),
    batch 2 x 2048 seeded token ids repeated every step; a correctness step
    against plain attention, 2 warm steps, 5 measured, one profiled."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from ray_tpu_torch.train import (adamw, cross_entropy_loss,
                                     init_train_state, make_train_step)

    B, S, lr, n_warm, n_steps = 2, 2048, 3e-4, 2, 5
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              num_layers=TRAIN_LAYERS)
    assert (cfg.dtype == torch.bfloat16 and cfg.remat
            and cfg.attention_impl == "flash")
    t0 = time.perf_counter()
    model = LlamaModel(cfg, device=dev, param_dtype=torch.float32)
    opt = adamw(model.parameters(), lr)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S))).to(dev)
    state = init_train_state(model, opt, ids, device=dev,
                             generator=torch.Generator(
                                 device=dev).manual_seed(0))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def loss_and_qkv_grads():
        loss = cross_entropy_loss(model(ids)[:, :-1], ids[:, 1:])
        loss.backward()
        grads = {f"layers.{i}.{n}": getattr(layer.self_attn, n).weight.grad
                 for i, layer in enumerate(model.layers)
                 for n in ("q_proj", "k_proj", "v_proj")}
        model.zero_grad(set_to_none=True)
        return loss.item(), grads

    flash_loss, flash_g = loss_and_qkv_grads()
    with attention_impl(model, "reference"):
        ref_loss, ref_g = loss_and_qkv_grads()
    cos = {n: F.cosine_similarity(flash_g[n].flatten().double(),
                                  ref_g[n].flatten().double(), dim=0).item()
           for n in flash_g}
    del flash_g, ref_g

    step = make_train_step(model, opt)
    losses = [step(state, ids, ids)[1].item() for _ in range(n_warm)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s, per_step = [], []
    zero_counts(wrappers)
    for _ in range(n_steps):
        before = read_counts(wrappers)
        t = time.perf_counter()
        state, loss = step(state, ids, ids)
        losses.append(loss.item())  # waits for the step's last kernel
        step_s.append(time.perf_counter() - t)
        after = read_counts(wrappers)
        per_step.append({k: after[k] - before[k] for k in after})
    launches = read_counts(wrappers)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(state, ids, ids)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    summary = profile_summary("train_8b_profile", prof, wall)

    n_params = sum(p.numel() for p in model.parameters())
    n_dense = n_params - model.embed_tokens.weight.numel()
    tokens = B * S
    flops = (6 * n_dense * tokens + 6 * cfg.num_layers * B * cfg.num_heads
             * S * S * cfg.head_dim)
    med = float(np.median(step_s))
    L = cfg.num_layers
    want = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
            "paged_decode": 0}
    ok_launch = all(n == want for n in per_step)
    ok_loss = (abs(flash_loss - ref_loss) <= TRAIN_LOSS_TOL
               and min(cos.values()) >= TRAIN_COS
               and all(math.isfinite(x) for x in losses)
               and losses[-1] < losses[0])
    ok = ok_launch and ok_loss
    check(ok, "8B training")
    emit({"phase": "train_8b", "layers": L, "of_layers": 32,
          "dtype": "bfloat16", "param_dtype": "float32", "remat": cfg.remat,
          "batch": B, "seq_len": S, "lr": lr, "params": n_params,
          "params_without_embedding": n_dense, "setup_s": setup_s,
          "step_s": step_s, "step_s_median": med,
          "tokens_per_s": tokens / med, "flop_per_step": flops,
          "mfu": flops / med / PEAK_BF16, "bound_s": flops / PEAK_BF16,
          "peak_mem_gb": peak_gb, "losses": losses,
          "flash_loss": flash_loss, "reference_loss": ref_loss,
          "loss_tol": TRAIN_LOSS_TOL, "qkv_grad_cos_min": min(cos.values()),
          "qkv_grad_cos": cos, "cos_min_required": TRAIN_COS,
          "launches": launches, "launches_per_step": per_step,
          "launches_per_step_expected": want, "ok": ok})
    emit(summary)
    return launches


# ---------------------------------------------------------------------------
def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    start["t"] = time.perf_counter()
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
          "ptxas": {n: ptxas_report(log)
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

    # K2 and K3 against flash_attention_bwd_plain.
    for causal in (True, False):
        k2k3_case(attn, f"8b_bf16_{'causal' if causal else 'full'}", 1, 2048,
                  32, 8, 128, torch.bfloat16, causal, 10, dev)
    k2k3_case(attn, "small_f32_causal", 2, 256, 4, 2, 64, torch.float32,
              True, 11, dev)
    k2k3_case(attn, "ragged_f32_gqa4", 1, 200, 8, 2, 32, torch.float32,
              True, 12, dev, time_it=False)
    k2k3_case(attn, "ragged_bf16_d64", 2, 200, 8, 2, 64, torch.bfloat16,
              True, 13, dev, time_it=False)
    k2k3_case(attn, "ragged_bf16_d32", 1, 77, 4, 2, 32, torch.bfloat16,
              True, 14, dev, time_it=False)
    k2k3_case(attn, "main_shape_bf16_d64", 2, 2048, 32, 8, 64,
              torch.bfloat16, True, 15, dev, time_it=False)

    # K4 against paged_decode_plain.
    lens = [1, 63, 64, 65, 130, 200, 511, 512]
    for dtype in (torch.bfloat16, torch.float32):
        k4_case(paged, f"8b_{str(dtype).split('.')[-1]}", dtype, lens, 5,
                dev)

    tiny_engine_phase(dev)
    entry_phase(dev)
    wrappers = {"flash_fwd": attn.flash_fwd_kernel,
                "flash_bwd_dq": attn.flash_bwd_dq_kernel,
                "flash_bwd_dkv": attn.flash_bwd_dkv_kernel,
                "paged_decode": paged.paged_attention_decode_kernel}
    train_tiny_phase(dev, wrappers)
    serving = serve_8b_phase(dev, wrappers)
    gc.collect()
    torch.cuda.empty_cache()
    training = train_8b_phase(dev, wrappers)
    gc.collect()
    torch.cuda.empty_cache()

    # Every kernel at the shapes its main path gave it: K1 and K4 at the
    # serving path's teacher-forced forward and decode, K1, K2 and K3 at the
    # training step's.
    b, s = serving["forward_shape"]
    k1_case(attn, "main_path_forward", b, s, 32, 8, 128, torch.bfloat16,
            True, 6, dev)
    k4 = k4_case(paged, "main_path_decode", torch.bfloat16,
                 [serving["decode_seq_len"]] * 8, 7, dev)
    k1 = k1_case(attn, "main_path_train_forward", 2, 2048, 32, 8, 128,
                 torch.bfloat16, True, 8, dev)
    k23 = k2k3_case(attn, "main_path_backward", 2, 2048, 32, 8, 128,
                    torch.bfloat16, True, 9, dev)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")

    def bwd(prefix, err):
        # library_ms is SDPA's whole backward: read it against the pair
        # with Delta (pair_delta_ms), as that backward computes Delta too.
        return {"max_abs_err": err, "ms": k23[f"{prefix}_ms"],
                "plain_ms": k23["plain_ms"],
                "bound_ms": k23[f"{prefix}_bound_ms"],
                "bound_by": k23[f"{prefix}_bound_by"],
                "library_ms": k23["library_ms"],
                "pair_delta_ms": k23["pair_delta_ms"]}

    by_path = {n: {"train_8b": training[n], "serve_8b": serving[n]}
               for n in wrappers}
    emit({"kernels": [
        {"name": "flash_fwd", "route": "cuda",
         "source": "ray_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "ray_tpu/ops/attention.py:105",
         "launches": training["flash_fwd"],
         "launches_by_path": by_path["flash_fwd"],
         **{k: k1[k] for k in keys}},
        {"name": "flash_bwd_dq", "route": "cuda",
         "source": "ray_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "ray_tpu/ops/attention.py:198",
         "launches": training["flash_bwd_dq"],
         "launches_by_path": by_path["flash_bwd_dq"],
         **bwd("dq", k23["dq"]["max_abs_err"])},
        {"name": "flash_bwd_dkv", "route": "cuda",
         "source": "ray_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "ray_tpu/ops/attention.py:243",
         "launches": training["flash_bwd_dkv"],
         "launches_by_path": by_path["flash_bwd_dkv"],
         **bwd("dkv", max(k23["dk"]["max_abs_err"],
                          k23["dv"]["max_abs_err"]))},
        {"name": "paged_decode", "route": "cuda",
         "source": "ray_tpu_torch/csrc/paged_decode.cu",
         "replaces": "ray_tpu/llm/_internal/paged.py:115",
         "launches": serving["paged_decode"],
         "launches_by_path": by_path["paged_decode"],
         **{k: k4[k] for k in keys}},
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
