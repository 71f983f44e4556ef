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
Then int8 weights (models/quant.py): a 2-layer 8B forward dequantized module
by module against the whole tree dequantized (same bits), and the
reference's int8 8B serving config (all 32 layers, no bf16 tree resident);
and a switch-routed MoE (models/moe.py): one MoEMlp at 8B widths against
its f32 oracle, and a 4-layer MoE Llama at 8B widths served like the rest.
Then the text surface (llm/_internal/openai.py, batch.py): OpenAIServer at
Llama-3-8B width answers waves of completions and chat requests, unary and
streamed, each response held to the ids the server generated and to a
teacher-forced forward; and the batch engine stage runs a ragged block of 8
rows at the same width. Then tensor-parallel serving (parallel/,
llm/_internal/tp.py) with two rank processes sharing this card over gloo:
the tiny f32 model against TP 1, and Llama-3-8B (32 layers) through
serve_8b's waves, K1 and K4 on each rank's local heads; and the 4-layer
MoE Llama of serve_moe through two ranks at {"tensor": 2} and at
{"expert": 2} (expert parallelism, parallel/ep.py) against its one-card
run. Then sharded training (train/step.py with mesh=, parallel/fsdp.py,
parallel/launch.py), its ranks sharing this card over gloo:
dryrun_multigpu(4) (ring attention over "seq", then a pipeline over
"stage" and the MoE Llama over "expert") and the tiny f32 model at
{"data": 2} against TP 1, then the Llama-3-8B widths cut to 2 layers at
{"tensor": 2} and {"fsdp": 2, "tensor": 2} against TP 1 at the same
depth, K1, K2 and K3 on each rank's local heads, and at {"seq": 2,
"tensor": 2} with ring attention (parallel/ring.py; no K1-K3); and the
MoE Llama with 8 experts cut to 1 layer at {"expert": 2, "tensor": 2}
against one device at the same depth. Then
ring attention alone at {"seq": 2} and {"seq": 4} (bf16 at the 8B
attention widths, and f32) and pipeline_apply (parallel/pipeline.py) at
{"stage": 2} and {"stage": 4}, each held against one device. Then RLlib's
online algorithms (ray_tpu_torch/rllib, which launch none of K1-K4): each
learner's loss and gradients (PPO on flat and 84x84x1 pixel observations,
IMPALA, APPO, DQN, SAC) against the same learner on the CPU; the
reference's pixel PPO and SAC learning configs with their learning checks,
and pixel PPO's env steps/s at 64 envs x 128 steps; IMPALA, APPO and DQN on
the example gridworld. Then multi-agent PPO (rllib/multi_agent.py): the
reference's two-policy learning test on the chase gridworld, each trained
policy held against a random opponent. Then the ResNet family
(models/resnet.py): resnet50ish at 224x224, f32 logits, gradients and
BatchNorm statistics on the card against the CPU and its bf16 logits
against its f32 ones, then bf16 SGD steps at batch 128 (step ms,
images/s, MFU). Each phase prints
one JSON line; the line before the last repeats the card's name and power
limit from nvidia-smi, and the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Exits non-zero, with no result, when CUDA is absent or the port's package
is not beside this file, and when any check fails.

    python3 chip_smoke.py --versus PARENT

also times the kernels of another checkout of the repo (PARENT, e.g. the
parent commit unpacked with git archive) against this tree's, alternating
(phase "versus").
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
import traceback

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
# kernel does, hence its 2e-2. K4 and its plain version round P too, the
# kernel against each warp's running maximum and the plain version against
# the row's, which its rtol covers. atol is a few bf16 ulps of the typical |out|
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
# since then ("t_s") and since the line before ("phase_s"), so the run's
# time can be split by phase.
start = {"t": time.perf_counter()}


def emit(obj):
    if "phase" in obj:
        now = time.perf_counter()
        obj = {**obj, "t_s": now - start["t"],
               "phase_s": now - start.get("last", start["t"])}
        start["phase"], start["last"] = obj["phase"], now
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
    """"kernel<T, D>: registers, barriers; stack frame, spills" for each
    entry function in nvcc's -Xptxas -v output."""
    rows, name, frame = [], "?", ""
    types = {"f": "f32", "13__nv_bfloat16": "bf16"}
    for ln in log.splitlines():
        # The last flash_/paged_ name in the mangled symbol is the kernel's
        # (the first is the anonymous namespace's, named after the file).
        m = re.search(r"Compiling entry function '.*((?:flash|paged)_[a-z0-9_]+)"
                      r"(?:I(f|13__nv_bfloat16)?(?:Li(\d+))?E)?", ln)
        if m:
            args = [a for a in (types.get(m.group(2)), m.group(3)) if a]
            name = m.group(1) + (f"<{', '.join(args)}>" if args else "")
        elif "stack frame" in ln:
            frame = ln.strip()
        elif "Used" in ln:
            rows.append(f"{name}: {ln.split(':', 1)[-1].strip()}; {frame}")
    return rows


# ---------------------------------------------------------------------------
def k1_case(attn, label, b, s, h, hkv, d, dtype, causal, seed, dev,
            time_it=True, skv=None):
    """K1 against flash_attention_fwd_plain on seeded inputs (q [b,s,h,d],
    k/v [b,skv,hkv,d], skv = s unless given), through the forward
    FlashAttention runs on the card (a head dim K1 is not built for is
    zero-padded); two launches must give the same bits."""
    skv = skv or s
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
               for shape in ((b, s, h, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    out, lse = attn.flash_fwd_cuda(q, k, v, causal=causal)
    again = attn.flash_fwd_cuda(q, k, v, causal=causal)
    ref, ref_lse = attn.flash_attention_fwd_plain(q, k, v, causal)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    atol, rtol = TOL["K1", dtype]
    used = limit_used(out, ref, atol, rtol)
    repeat = torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ok = (used <= 1 and lse_err <= LSE_TOL and repeat
          and bool(torch.isfinite(out).all()))
    check(ok, f"K1 {label}")
    row = {"phase": "k1_check", "case": label, "shape": [b, s, h, hkv, d],
           "skv": skv, "dtype": str(dtype).split(".")[-1], "causal": causal,
           "max_abs_err": err, "lse_max_abs_err": lse_err, "atol": atol,
           "rtol": rtol, "limit_used": used, "bitwise_repeat": repeat,
           "ok": ok}
    del again
    if time_it:
        flops = 4 * b * h * d * attn_pairs(s, skv, causal)
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


def attn_pairs(sq, skv, causal):
    """The (query, key) pairs attention computes: all of them, or under the
    causal mask (key j <= query i, both from 0) sum_i min(i + 1, skv)."""
    if not causal:
        return sq * skv
    n = min(sq, skv)
    return n * (n + 1) // 2 + (sq - n) * skv


def _sdpa(q, k, v, causal):
    """The yardstick: PyTorch's fused attention on the same inputs."""
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal, enable_gqa=True).transpose(1, 2)


def k2k3_case(attn, label, b, s, h, hkv, d, dtype, causal, seed, dev,
              time_it=True):
    """K2 (dQ) and K3 (dK, dV) against flash_attention_bwd_plain on the same
    inputs, with K1's out and lse, through the forward and backward
    FlashAttention runs on the card (a head dim the kernels are not built
    for is zero-padded)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(dtype)
                   for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d),
                                 (b, s, h, d)))
    out, lse = attn.flash_fwd_cuda(q, k, v, causal=causal)
    dq, dk, dv = attn.flash_bwd_cuda(q, k, v, out, lse, do, causal=causal)
    refs = attn.flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
    # Deterministic gradients: a second launch on the same inputs gives
    # the same bits (no atomics, a fixed order of every sum).
    again = attn.flash_bwd_cuda(q, k, v, out, lse, do, causal=causal)
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
        delta = attn.flash_bwd_delta(out, do)
        pairs = attn_pairs(s, s, causal)
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


def k4_inputs(dev, dtype, seq_lens, seed, H=32, HK=8, D=128, PS=64, MP=8):
    """A batch of len(seq_lens) decode rows at the 8B engine's decode
    shapes unless given; the page table is a permutation of the pool."""
    B = len(seq_lens)
    g = torch.Generator(device=dev).manual_seed(seed)
    P = B * MP + 1
    q = torch.randn((B, 1, H, D), generator=g, device=dev).to(dtype)
    kp = torch.randn((HK, P, PS, D), generator=g, device=dev).to(dtype)
    vp = torch.randn((HK, P, PS, D), generator=g, device=dev).to(dtype)
    perm = np.random.default_rng(seed).permutation(P)[:B * MP]
    pt = torch.tensor(perm.reshape(B, MP), dtype=torch.int32, device=dev)
    lens = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
    return q, kp, vp, pt, lens


# K4's off-by-one check holds the kernel against the plain version with
# every seq_len one short, which must fail the limit. One key of a row of n
# moves an output by about its weight, e^s / (1.65 n) for unit-normal
# scores (s <= ~3 over a case's heads): above the bf16 atol (2e-3) up to a
# few thousand keys, below it at 32,768. Longer rows report it only.
K4_OFF_BY_ONE_MAX_LEN = 4096


def k4_dims(paged, q, kp, pt):
    """(B, H, HK, D, ps, MP) and the host's split (pages, splits)."""
    B, _, H, D = q.shape
    HK, PS, MP = kp.shape[0], kp.shape[2], pt.shape[1]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    return (B, H, HK, D, PS, MP), paged.decode_split(B, HK, H // HK, MP, PS,
                                                     sms)


def k4_case(paged, label, dtype, seq_lens, seed, dev, time_it=True,
            **shape):
    """K4 against paged_decode_plain on seeded inputs (``k4_inputs``' shapes
    unless given in ``shape``): two launches must give the same bits, and
    (rows up to K4_OFF_BY_ONE_MAX_LEN keys) the plain version with every
    seq_len one short must fail the limit."""
    q, kp, vp, pt, lens = k4_inputs(dev, dtype, seq_lens, seed, **shape)
    out = paged.paged_attention_decode_kernel(q, kp, vp, pt, lens)
    again = paged.paged_attention_decode_kernel(q, kp, vp, pt, lens)
    ref = paged.paged_decode_plain(q, kp, vp, pt, lens)
    short = paged.paged_decode_plain(q, kp, vp, pt, (lens - 1).clamp_min(0))
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    atol, rtol = TOL["K4", dtype]
    used = limit_used(out, ref, atol, rtol)
    off = limit_used(out, short, atol, rtol)
    repeat = torch.equal(out, again)
    off_required = max(seq_lens) <= K4_OFF_BY_ONE_MAX_LEN
    ok = (used <= 1 and repeat and bool(torch.isfinite(out).all())
          and (off > 1 or not off_required))
    check(ok, f"K4 {label}")
    del again, short
    (B, H, HK, D, PS, MP), (pps, splits) = k4_dims(paged, q, kp, pt)
    row = {"phase": "k4_check", "case": label,
           "shape": {"B": B, "H": H, "HK": HK, "D": D, "ps": PS, "MP": MP},
           "seq_lens": (list(seq_lens) if len(seq_lens) <= 8
                        else f"{len(seq_lens)} rows"),
           "dtype": str(dtype).split(".")[-1],
           "split": {"pages": pps, "splits": splits,
                     "blocks": B * HK * -(-(H // HK) // 16) * splits},
           "max_abs_err": err, "atol": atol, "rtol": rtol,
           "limit_used": used, "bitwise_repeat": repeat,
           "off_by_one_limit_used": off,
           "off_by_one_required": off_required, "ok": ok}
    if time_it:
        tokens = sum(min(n, MP * PS) for n in seq_lens)
        # Each real token's K and V row of every kv head, read once.
        kv_bytes = 2 * tokens * HK * D * kp.element_size()
        io = nbytes(q, out, pt, lens) + kv_bytes
        flops = 4 * tokens * H * D
        # The kernel reads only the real pages, so the copies are counted
        # by those bytes, not by the whole pools.
        sets = copies((q, kp, vp, pt, lens), io)
        row.update({
            "copies": len(sets),
            "ms": cuda_ms(paged.paged_attention_decode_kernel, sets),
            "plain_ms": cuda_ms(paged.paged_decode_plain, sets, iters=5),
            "library_ms": None})
        row["bound_ms"], row["bound_by"] = bound(io, flops, dtype)
        row["gbps"] = io / row["ms"] / 1e6
    emit(row)
    return row


def k4_splits_phase(paged, dev, cases):
    """K4's time at each split size of ``cases`` ((label, seq_lens, shape,
    pages a split), bf16), the host's rule (``decode_split``) replaced for
    these calls only; each result is also held to the plain version. The
    rule's own choice is reported beside the sweep."""
    rule = paged.decode_split
    for label, seq_lens, shape, choices in cases:
        q, kp, vp, pt, lens = k4_inputs(dev, torch.bfloat16, seq_lens, 29,
                                        **shape)
        (B, H, HK, D, PS, MP), chosen = k4_dims(paged, q, kp, pt)
        ref = paged.paged_decode_plain(q, kp, vp, pt, lens)
        tokens = sum(min(n, MP * PS) for n in seq_lens)
        sets = copies((q, kp, vp, pt, lens), 2 * tokens * HK * D * 2)
        sweep = []
        try:
            for pps in choices:
                splits = -(-MP // pps)
                paged.decode_split = lambda *_, p=pps, n=splits: (p, n)
                out = paged.paged_attention_decode_kernel(q, kp, vp, pt, lens)
                sweep.append({
                    "pages": pps, "splits": splits,
                    "blocks": B * HK * -(-(H // HK) // 16) * splits,
                    "limit_used": limit_used(out, ref,
                                             *TOL["K4", torch.bfloat16]),
                    "ms": cuda_ms(paged.paged_attention_decode_kernel,
                                  sets)})
        finally:
            paged.decode_split = rule
        ok = all(r["limit_used"] <= 1 for r in sweep)
        check(ok, f"K4 splits {label}")
        emit({"phase": "k4_splits", "case": label,
              "rule": {"pages": chosen[0], "splits": chosen[1]},
              "sweep": sweep, "ok": ok})


def load_parent(parent):
    """ray_tpu_torch/ops/attention.py and llm/_internal/paged.py of another
    checkout (the parent commit's), bound to that checkout's own native
    builder, so its kernels are built from its own csrc/ into its own
    _build/."""
    import importlib.util

    def load(name, rel):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(parent, "ray_tpu_torch", *rel))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod  # dataclasses look their module up there
        spec.loader.exec_module(mod)
        return mod

    native = load("parent_native", ("native", "__init__.py"))
    attention = load("parent_attention", ("ops", "attention.py"))
    paged = load("parent_paged", ("llm", "_internal", "paged.py"))
    attention.native = paged.native = native
    return attention, paged


def versus_phase(attn, paged, parent, shapes, k4_cases, dev):
    """The parent checkout's kernels against this tree's on the same
    inputs, in one process on one card, each timed in the order parent,
    this, this, parent: K1 at each (label, b, s, backward) of ``shapes``
    (32 heads over 8, D = 128, causal, bf16), and K2 and K3 too where
    ``backward``; K4 at each (label, seq_lens, shape) of ``k4_cases``
    (bf16)."""
    other, other_paged = load_parent(parent)
    order = ("parent", "this", "this", "parent")

    def alternate(call, sets, this=attn, that=other):
        mods = {"parent": that, "this": this}
        ms = [cuda_ms(lambda *a, m=mods[w]: call(m, *a), sets)
              for w in order]
        return {"ms": ms, "parent_ms": (ms[0] + ms[3]) / 2,
                "this_ms": (ms[1] + ms[2]) / 2}

    for label, b, s, backward in shapes:
        g = torch.Generator(device=dev).manual_seed(20)
        q, k, v, do = (torch.randn(shape, generator=g, device=dev)
                       .to(torch.bfloat16)
                       for shape in ((b, s, 32, 128), (b, s, 8, 128),
                                     (b, s, 8, 128), (b, s, 32, 128)))
        out_p, lse_p = other.flash_fwd_kernel(q, k, v, causal=True)
        out_t, lse_t = attn.flash_fwd_kernel(q, k, v, causal=True)
        torch.cuda.synchronize()
        row = {"phase": "versus", "case": label, "shape": [b, s, 32, 8, 128],
               "order": list(order),
               "out_max_abs_diff": (out_p.float() - out_t.float()).abs()
               .max().item(),
               "lse_max_abs_diff": (lse_p - lse_t).abs().max().item(),
               "flash_fwd": alternate(
                   lambda m, q, k, v: m.flash_fwd_kernel(q, k, v,
                                                         causal=True),
                   copies((q, k, v), nbytes(q, k, v) * 2))}
        if backward:
            delta = attn.flash_bwd_delta(out_t, do)
            sets = copies((q, k, v, do, lse_t, delta),
                          nbytes(q, k, v, do, lse_t, delta) * 2)
            row["flash_bwd_dq"] = alternate(
                lambda m, *a: m.flash_bwd_dq_kernel(*a, causal=True), sets)
            row["flash_bwd_dkv"] = alternate(
                lambda m, *a: m.flash_bwd_dkv_kernel(*a, causal=True), sets)
        emit(row)
    for label, seq_lens, shape in k4_cases:
        q, kp, vp, pt, lens = k4_inputs(dev, torch.bfloat16, seq_lens, 22,
                                        **shape)
        out_p = other_paged.paged_attention_decode_kernel(q, kp, vp, pt, lens)
        out_t = paged.paged_attention_decode_kernel(q, kp, vp, pt, lens)
        torch.cuda.synchronize()
        tokens = sum(seq_lens)
        emit({"phase": "versus", "case": label, "kernel": "paged_decode",
              "shape": {"B": len(seq_lens), **shape},
              "seq_len_max": max(seq_lens), "order": list(order),
              "out_max_abs_diff": (out_p.float() - out_t.float()).abs()
              .max().item(),
              "paged_decode": alternate(
                  lambda m, *a: m.paged_attention_decode_kernel(*a),
                  copies((q, kp, vp, pt, lens),
                         2 * tokens * kp.shape[0] * kp.shape[3] * 2),
                  this=paged, that=other_paged)})


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
        return server_wave(srv, rng, cfg.vocab_size, n_req, prompt_len,
                           max_tokens)

    try:
        wave()  # warm: first launches, allocator growth
        zero_counts(wrappers)
        torch.cuda.reset_peak_memory_stats()
        waves = [wave() for _ in range(n_waves)]
        k4_serving = wrappers["paged_decode"].launches
        gaps, _, finite, shape = teacher_gaps(
            srv.model, [list(zip(prompts, [r["tokens"] for r in res]))
                        for prompts, res, _ in waves], dev)
        gaps = [g for w in gaps for r in w for g in r]
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
            "forward_shape": shape,
            "summary": {"tokens_per_s": tps,
                        "ttft_mean_s_median": float(np.median(ttft_mean)),
                        "setup_s": setup_s, "peak_mem_gb": peak_gb}}


def server_wave(srv, rng, vocab, n_req, prompt_len, max_tokens):
    """One wave of n_req greedy requests of prompt_len seeded ids through
    ``srv.generate_all``, one thread each, admitted by the engine as one.
    Returns (prompts, results, wall_s)."""
    prompts = [rng.integers(0, vocab, prompt_len).tolist()
               for _ in range(n_req)]
    res = [None] * n_req

    def go(i):
        res[i] = srv.generate_all(prompts[i], max_tokens=max_tokens)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(n_req)]
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


def profile_engine(engine, prompts, max_tokens, phase="serve_8b_profile"):
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
        t = time.perf_counter()
    return profile_summary(phase, prof, wall, engine_steps=steps,
                           stop_s=time.perf_counter() - t)


def profile_summary(phase, prof, wall, **extra):
    """The device's busy share of ``wall`` and the kernels and host
    operators that took the most time in a torch.profiler window, with the
    seconds the summary took ("summary_s"). It reads the profiler's raw
    events: ``key_averages()`` builds their tree in Python, which took
    94-99 s for one serving wave's events on the card's host."""
    from torch.autograd import DeviceType

    t = time.perf_counter()
    kernels, ops, threads = {}, {}, {}

    def add(rows, name, ns):
        n, total = rows.get(name, (0, 0))
        rows[name] = (n + 1, total + ns)

    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            threads.setdefault(e.start_thread_id(), []).append(e)
        # A range a library annotates on the device (AdamW's
        # "Optimizer.step") repeats its kernels' time.
        elif not e.is_user_annotation():
            add(kernels, e.name(), e.duration_ns())
    # A host operator's self time is its span less the spans of the events
    # nested directly in it on its thread.
    for evs in threads.values():
        evs.sort(key=lambda e: (e.start_ns(), -e.end_ns()))
        open_ = []  # [end_ns, name, self_ns] of the enclosing events
        for e in evs:
            start, end = e.start_ns(), e.end_ns()
            while open_ and open_[-1][0] <= start:
                add(ops, *open_.pop()[1:])
            if open_:
                open_[-1][2] -= end - start
            open_.append([end, e.name(), end - start])
        for _, name, ns in open_:
            add(ops, name, ns)
    dev_ns = sum(ns for _, ns in kernels.values())

    def top(rows):
        rows = sorted(rows.items(), key=lambda r: r[1][1], reverse=True)
        return [[name[:60], n, ns / 1e6] for name, (n, ns) in rows[:10]]

    return {"phase": phase, "wall_s": wall, **extra,
            "summary_s": time.perf_counter() - t,
            "kernel_launches": sum(n for n, _ in kernels.values()),
            "device_busy_s": dev_ns / 1e9,
            "device_busy_share": dev_ns / 1e9 / wall,
            "top_kernels_ms": top(kernels),
            "top_host_ops_ms": top(ops)}


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
        t = time.perf_counter()
    summary = profile_summary("train_8b_profile", prof, wall,
                              stop_s=time.perf_counter() - t)

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
# int8 serving (models/quant.py) and switch-routed MoE (models/moe.py).
GB = 1e9
# Peak device memory of the int8 8B phase must stay under its int8 tree
# plus this: KV pages (0.55 GB), one dequantized module at a time (lm_head's
# bf16 copy, 1.05 GB, is the largest) and the teacher-forced logits (8 x 176
# x 128,256 in bf16 and f32, 1.08 GB). A resident bf16 tree would add 16.06.
INT8_HEADROOM = 5 * GB
# MoEMlp (bf16) against moe_reference (f32) at the 8B widths. The bf16
# roundings of the gate and up products, of silu(gate) * up and of the
# output leave an error of ~0.4 % of the reference's RMS (RMS over the
# output; 0.42 % on the CPU at 512/1024 widths), and the largest of ~1M
# elements sits ~5.3 such sigmas out. So the RMS error is held to 1e-2 of
# the reference's RMS, and each element to atol 4e-2 of it (~10 sigma)
# plus rtol 2e-2 (as every bf16 check here). One token's output left out
# of the oracle (what a dropped or misrouted token does) must fail.
MOE_RTOL = 2e-2
MOE_ATOL_RMS = 4e-2
MOE_REL_RMS = 1e-2
# serve_moe, served against teacher-forced (fixed limits; the run is seeded
# and gave the same readings in each of its H100 calls, PERF.md §6):
# router logits where every earlier layer routed alike differ by at most
# MOE_ROUTER_TOL (read 0.274 where routes agreed); at least
# MOE_TEACHER_SHARE of the answer positions route alike in every layer
# (read 1,082 of 1,152 = 0.939); the answer positions routed apart keep
# their teacher gap within MOE_APART_GAP_TOL (read 0.625).
MOE_ROUTER_TOL = 0.4
MOE_TEACHER_SHARE = 0.9
MOE_APART_GAP_TOL = 1.0


def engine_waves(engine, vocab, n_waves, max_tokens, seed, n_req=8,
                 prompt_len=128):
    """Waves of n_req requests of prompt_len seeded tokens, all added
    before the first step (one admission), stepped to the end from this
    thread, as ray_tpu/benchmarks/model_bench.py's _serving_wave does.
    Returns [(prompts, requests, tokens, ttft_s, wall_s)] per wave."""
    from ray_tpu_torch.llm import Request

    rng = np.random.default_rng(seed)
    out = []
    for w in range(n_waves):
        prompts = [rng.integers(0, vocab, prompt_len).tolist()
                   for _ in range(n_req)]
        reqs = [Request(f"w{w}r{i}", p, max_tokens=max_tokens)
                for i, p in enumerate(prompts)]
        toks = {r.request_id: [] for r in reqs}
        ttft = {}
        t = time.perf_counter()
        for r in reqs:
            engine.add_request(r)
        while engine.has_work():
            for so in engine.step():
                toks[so.request_id].append(so.token)
                ttft.setdefault(so.request_id, time.perf_counter() - t)
        wall = time.perf_counter() - t
        out.append((prompts, reqs, [toks[r.request_id] for r in reqs],
                    [ttft[r.request_id] for r in reqs], wall))
    return out


def teacher_gaps(forward, waves, dev):
    """Teacher-forced cacheless forward (K1), one per wave, of that wave's
    rows [(prompt, answer)] in one batch, right-padded with id 0 to the
    longest prompt + answer (causal attention: no position sees the padding
    after it; equal rows need none). For each answer token: how far its
    logit lies below its row's maximum, and its log-softmax. Returns (gaps
    [wave][row][token], logprobs [wave][row][token], all logits finite, the
    last forward's [B, S])."""
    gaps, lps, finite = [], [], True
    for rows in waves:
        S = max(len(p) + len(a) for p, a in rows)
        ids = torch.zeros((len(rows), S), dtype=torch.long, device=dev)
        for i, (p, a) in enumerate(rows):
            ids[i, :len(p) + len(a)] = torch.tensor(list(p) + list(a),
                                                    device=dev)
        with torch.no_grad():
            logits = forward(ids).float()
        finite = finite and bool(torch.isfinite(logits).all())
        gaps.append([])
        lps.append([])
        for i, (p, a) in enumerate(rows):
            r = logits[i, len(p) - 1:len(p) - 1 + len(a)]
            chosen = r.gather(-1, torch.tensor(a, device=dev)[:, None])[:, 0]
            gaps[-1].append((r.max(-1).values - chosen).tolist())
            lps[-1].append((chosen - torch.logsumexp(r, -1)).tolist())
        del logits
    return gaps, lps, finite, list(ids.shape)


def serving_row(phase, cfg, waves, setup_s, K, max_tokens, launches,
                k4_expected, k1_expected, max_gap, peak_gb, ok, **extra):
    tps = [sum(len(t) for t in w[2]) / w[4] for w in waves]
    ttft_mean = [float(np.mean(w[3])) for w in waves]
    return {"phase": phase, "layers": cfg.num_layers,
            "dtype": str(cfg.dtype).split(".")[-1],
            "requests": len(waves[0][0]),
            "prompt_tokens": len(waves[0][0][0]), "max_tokens": max_tokens,
            "decode_steps": K, "waves": len(waves), "setup_s": setup_s,
            "wall_s": [w[4] for w in waves], "tokens_per_s": tps,
            "tokens_per_s_median": float(np.median(tps)),
            "ttft_mean_s": ttft_mean, "ttft_max_s": [max(w[3]) for w in waves],
            "ttft_mean_s_median": float(np.median(ttft_mean)),
            "peak_mem_gb": peak_gb, "teacher_max_gap": max_gap,
            "teacher_tol": TEACHER_TOL, "launches": launches,
            "paged_decode_expected": k4_expected,
            "flash_fwd_expected": k1_expected, **extra, "ok": ok}


def launch_ok(launches, k4, k1):
    return (launches["paged_decode"] == k4 and launches["flash_fwd"] == k1
            and launches["flash_bwd_dq"] == 0
            and launches["flash_bwd_dkv"] == 0)


def quant_check_phase(dev):
    """Llama-3-8B widths, 2 layers, int8 weights from random_quantized_like
    on the card: the logits of a [8, 128] forward with each module
    dequantized at its use (WeightsAtUse) equal those of the whole tree
    dequantized first, bit for bit. Then quantize_tree on the card: layer
    0's weights (seeded normal, bf16) quantized on the card and on the CPU
    give the same int8 and scales, bit for bit."""
    from ray_tpu_torch.models.convert import is_qleaf
    from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from ray_tpu_torch.models.quant import (WeightsAtUse, dequantize_tree,
                                            quantize_tree, quantized_bytes,
                                            random_quantized_like)

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=2,
                              remat=False)
    qp = random_quantized_like(cfg, device=dev)
    model = LlamaModel(cfg, device="meta")
    n_params = sum(p.numel() for p in model.parameters())
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (8, 128))).to(dev)
    with torch.no_grad():
        at_use = model(ids, weights=WeightsAtUse(qp, dequantize_tree))
        whole = torch.func.functional_call(model, dequantize_tree(qp),
                                           (ids,))
    same = torch.equal(at_use, whole)
    finite = bool(torch.isfinite(at_use).all())
    del at_use, whole
    gen = torch.Generator(device=dev).manual_seed(4)
    layer0 = {name: 0.02 * torch.randn(p.shape, generator=gen, device=dev,
                                       dtype=torch.bfloat16)
              for name, p in model.named_parameters()
              if name.startswith("layers.0.")}
    on_card = quantize_tree(layer0, cfg, device=dev)
    on_cpu = quantize_tree({k: v.cpu() for k, v in layer0.items()}, cfg,
                           device="cpu")
    n_q = sum(is_qleaf(v) for v in on_card.values())
    differ = {"int8": 0, "scale": 0, "other": 0, "not_on_card": 0}
    for k, v in on_card.items():
        pairs = ([("int8", v["__q__"], on_cpu[k]["__q__"]),
                  ("scale", v["s"], on_cpu[k]["s"])] if is_qleaf(v)
                 else [("other", v, on_cpu[k])])
        for field, card, cpu in pairs:
            differ["not_on_card"] += int(not card.is_cuda)
            differ[field] += int((card.cpu() != cpu).sum())
    q_same = n_q > 0 and not any(differ.values())
    del layer0, on_card, on_cpu
    ok = same and finite and q_same
    check(ok, "int8 at-use dequant vs whole tree; quantize_tree card vs CPU")
    emit({"phase": "quant_check", "layers": cfg.num_layers,
          "shape": list(ids.shape), "same_bits": same, "finite": finite,
          "quantize_tree_card_vs_cpu_same_bits": q_same,
          "quantize_tree_leaves": n_q, "quantize_tree_elements_differ": differ,
          "quantized_bytes": quantized_bytes(qp),
          "bf16_bytes": 2 * n_params, "params": n_params, "ok": ok})


def serve_8b_int8_phase(dev, wrappers, serve_8b):
    """The reference's int8 8B serving config
    (ray_tpu/benchmarks/model_bench.py:283-318): Llama-3-8B, all 32
    layers, max_seq_len 1024, int8 weights from random_quantized_like built
    on the card, param_transform=dequantize_tree (each module dequantized
    at its use), a meta model; one warm wave of 8 tokens, then three
    measured waves of 8 requests x 128 prompt tokens x 48 new tokens, each
    checked by a teacher-forced cacheless forward (K1)."""
    from ray_tpu_torch.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from ray_tpu_torch.models.quant import (WeightsAtUse, dequantize_tree,
                                            quantized_bytes,
                                            random_quantized_like)

    n_waves, max_tokens, K = 3, 48, 8
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / GB
    t0 = time.perf_counter()
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), max_seq_len=1024,
                              remat=False)
    qp = random_quantized_like(cfg, device=dev)
    model = LlamaModel(cfg, device="meta")
    engine = LLMEngine(model, qp, EngineConfig(
        max_seqs=8, page_size=64, max_pages_per_seq=8, decode_steps=K),
        param_transform=dequantize_tree, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    qbytes = quantized_bytes(qp)
    kv_bytes = sum(nbytes(*c) for c in engine.caches)
    engine_waves(engine, cfg.vocab_size, 1, 8, seed=10)  # warm
    zero_counts(wrappers)
    waves = engine_waves(engine, cfg.vocab_size, n_waves, max_tokens,
                         seed=11)
    at_use = WeightsAtUse(engine.params, dequantize_tree)
    gaps, _, finite, shape = teacher_gaps(
        lambda ids: model(ids, weights=at_use),
        [list(zip(p, t)) for p, _, t, _, _ in waves], dev)
    torch.cuda.synchronize()
    launches = read_counts(wrappers)
    peak = torch.cuda.max_memory_allocated()
    k4 = n_waves * cfg.num_layers * K * math.ceil((max_tokens - 1) / K)
    k1 = n_waves * cfg.num_layers
    max_gap = max(g for w in gaps for r in w for g in r)
    ok_tokens = all(len(t) == max_tokens for w in waves for t in w[2])
    ok_mem = peak < qbytes + INT8_HEADROOM
    ok = (ok_tokens and max_gap <= TEACHER_TOL and finite and ok_mem
          and launch_ok(launches, k4, k1))
    check(ok, "8B int8 serving")
    profile = profile_engine(engine, [
        np.random.default_rng(12).integers(0, cfg.vocab_size, 128).tolist()
        for _ in range(8)], max_tokens, "serve_8b_int8_profile")
    emit(serving_row(
        "serve_8b_int8", cfg, waves, setup_s, K, max_tokens, launches, k4,
        k1, max_gap, peak / GB, ok, weights="int8 (random_quantized_like)",
        quantized_gb=qbytes / GB, kv_pages_gb=kv_bytes / GB,
        peak_limit_gb=(qbytes + INT8_HEADROOM) / GB,
        allocated_at_start_gb=base_gb,
        lm_head_bf16_gb=2 * cfg.vocab_size * cfg.hidden_size / GB,
        serve_8b=serve_8b))
    emit(profile)
    del engine, qp, at_use
    return {**launches, "forward_shape": shape}


class InputLog:
    """Forward hooks that keep each MoE layer's input of every call (no
    device work), for the routes to be recomputed after a run."""

    def __init__(self, model):
        self.inputs = [[] for _ in model.layers]
        self.handles = [
            layer.mlp.register_forward_hook(
                lambda m, args, out, i=i: self.inputs[i].append(args[0]))
            for i, layer in enumerate(model.layers)]

    def take(self):
        got, self.inputs = self.inputs, [[] for _ in self.inputs]
        return got

    def close(self):
        for h in self.handles:
            h.remove()


def router_logits(model, inputs):
    """Each layer's router logits [B, S, E] (f32) on its recorded input:
    the product MoEMlp computed, on the same input."""
    with torch.no_grad():
        return [[layer.mlp.router(x.float()) for x in xs]
                for layer, xs in zip(model.layers, inputs)]


def moe_check_phase(dev, h=4096, inter=14336, e=8):
    """One MoEMlp at the Llama-3-8B widths (8 experts, capacity factor 8, so
    nothing is dropped), bf16, on the card against moe_reference in f32 on
    the same (bf16) weights and inputs."""
    from ray_tpu_torch.models.moe import MoEMlp, moe_reference

    torch.manual_seed(0)
    layer = MoEMlp(h, inter, e, capacity_factor=float(e),
                   dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        layer.router.weight.normal_(0.0, 1.0 / math.sqrt(h), generator=g)
        x = torch.randn((2, 128, h), generator=g, device=dev).to(
            torch.bfloat16)
        out = layer(x)
        params = {"router": {"kernel": layer.router.weight.T},
                  "gate_kernel": layer.gate_kernel,
                  "up_kernel": layer.up_kernel,
                  "down_kernel": layer.down_kernel}
        ref = moe_reference(x, params, e)
        routes = (x.float() @ params["router"]["kernel"]).argmax(-1)
        dropped = ref.clone()
        dropped[0, 0] = 0.0
    torch.cuda.synchronize()
    rms = ref.square().mean().sqrt().item()
    atol = MOE_ATOL_RMS * rms
    used = limit_used(out, ref, atol, MOE_RTOL)
    used_dropped = limit_used(out, dropped, atol, MOE_RTOL)
    err = (out.float() - ref).abs().max().item()
    rel_rms = (out.float() - ref).square().mean().sqrt().item() / rms
    ok = (used <= 1 and rel_rms <= MOE_REL_RMS and used_dropped > 1
          and bool(torch.isfinite(out).all()))
    check(ok, "MoEMlp vs moe_reference")
    with torch.no_grad():
        ms = cuda_ms(layer, [(x,)], iters=10)
    emit({"phase": "moe_check", "shape": [2, 128, h], "experts": e,
          "intermediate": inter, "capacity": layer.capacity(128),
          "tokens_per_expert": torch.bincount(routes.flatten(),
                                              minlength=e).tolist(),
          "max_abs_err": err, "ref_rms": rms, "rel_rms_err": rel_rms,
          "rel_rms_limit": MOE_REL_RMS, "atol": atol, "rtol": MOE_RTOL,
          "limit_used": used, "one_token_dropped_limit_used": used_dropped,
          "ms": ms, "ok": ok})


def serve_moe_phase(dev, wrappers):
    """A switch-routed MoE Llama at the Llama-3-8B widths (8 experts,
    capacity factor 8 = E, so no token is dropped), 4 of 32 layers, bf16,
    seeded random weights, through the engine: the waves and checks of
    serve_8b_int8. Bf16 rounding differs between the paths (K1 and
    batch-1408 products against K4 and batch-8 ones), so the router logits
    differ a little and a token whose two best experts nearly tie may go
    to either. All limits are fixed (MOE_ROUTER_TOL and below): the router
    logits of the two paths differ by at most MOE_ROUTER_TOL at every
    position in every layer up to and including the first where its routes
    differ (so a route can flip only where the teacher's two best logits
    lie within twice that); the teacher-forced gap is held to TEACHER_TOL
    at the answer positions routed alike in every layer, which must be at
    least MOE_TEACHER_SHARE of them, and to MOE_APART_GAP_TOL at the
    rest."""
    from ray_tpu_torch.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.models.llama import (LlamaConfig, LlamaModel,
                                            init_params)

    n_waves, max_tokens, K, prompt_len = 3, 48, 8, 128
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=4,
                              num_experts=8, moe_capacity_factor=8.0,
                              max_seq_len=1024, remat=False)
    model = LlamaModel(cfg, device=dev)
    init_params(model, torch.Generator(device=dev).manual_seed(0))
    engine = LLMEngine(model, None, EngineConfig(
        max_seqs=8, page_size=64, max_pages_per_seq=8, decode_steps=K),
        device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    engine_waves(engine, cfg.vocab_size, 1, 8, seed=20)  # warm
    zero_counts(wrappers)
    log = InputLog(model)
    waves = engine_waves(engine, cfg.vocab_size, n_waves, max_tokens,
                         seed=21)
    served = log.take()
    gaps, _, finite, shape = teacher_gaps(
        model, [list(zip(p, t)) for p, _, t, _, _ in waves], dev)
    taught = log.take()
    log.close()
    torch.cuda.synchronize()
    launches = read_counts(wrappers)
    peak = torch.cuda.max_memory_allocated()
    profile = profile_engine(engine, [
        np.random.default_rng(22).integers(0, cfg.vocab_size, 128).tolist()
        for _ in range(8)], max_tokens, "serve_moe_profile")

    # Routes: per layer, each wave's prefill [8, 128] (rows in admission
    # order) and its 48 decode steps [8, 1] (rows = slots), against the
    # teacher's [8, 176] per wave.
    steps = 1 + math.ceil((max_tokens - 1) / K) * K
    s_logits = router_logits(model, served)
    t_logits = router_logits(model, taught)
    checked, differ, first, first_margins, noise = 0, 0, 0, [], 0.0
    max_gap = apart_gap = 0.0
    for w, (_, reqs, toks, _, _) in enumerate(waves):
        agree = torch.ones((len(reqs), prompt_len + max_tokens),
                           dtype=torch.bool, device=dev)
        for layer in range(cfg.num_layers):
            calls = s_logits[layer][w * steps:(w + 1) * steps]
            slots = torch.tensor([r.slot for r in reqs], device=dev)
            dec = torch.cat(calls[1:], dim=1)[slots]  # [8, 48, E]
            serve = torch.cat([calls[0], dec], dim=1)
            teach = t_logits[layer][w]
            top2 = teach.topk(2, dim=-1).values
            margin = top2[..., 0] - top2[..., 1]
            diff = serve.argmax(-1) != teach.argmax(-1)
            differ += int(diff.sum())
            # Router noise where every earlier layer routed alike, this
            # layer's routed-apart positions included; past a position's
            # first layer routed apart its inputs differ by a whole
            # expert's output.
            if agree.any():
                noise = max(noise, (serve - teach).abs().amax(-1)[agree]
                            .max().item())
            new = diff & agree
            first += int(new.sum())
            first_margins += margin[new].tolist()
            agree &= ~diff
        ok_pos = agree[:, prompt_len - 1:prompt_len - 1 + max_tokens]
        for b, row in enumerate(gaps[w]):
            for i, gap in enumerate(row):
                if ok_pos[b, i]:
                    checked += 1
                    max_gap = max(max_gap, gap)
                else:
                    apart_gap = max(apart_gap, gap)
    k4 = n_waves * cfg.num_layers * K * math.ceil((max_tokens - 1) / K)
    k1 = n_waves * cfg.num_layers
    ok_tokens = all(len(t) == max_tokens for w in waves for t in w[2])
    answers = n_waves * 8 * max_tokens
    ok_routes = (noise <= MOE_ROUTER_TOL
                 and checked >= MOE_TEACHER_SHARE * answers
                 and apart_gap <= MOE_APART_GAP_TOL)
    ok = (ok_tokens and finite and max_gap <= TEACHER_TOL and ok_routes
          and launch_ok(launches, k4, k1))
    check(ok, "MoE serving")
    emit(serving_row(
        "serve_moe", cfg, waves, setup_s, K, max_tokens, launches, k4, k1,
        max_gap, peak / GB, ok, experts=cfg.num_experts,
        capacity_factor=cfg.moe_capacity_factor, of_layers=32,
        params=n_params, teacher_positions_checked=checked,
        teacher_positions=answers, teacher_share_min=MOE_TEACHER_SHARE,
        teacher_max_gap_routed_apart=apart_gap,
        teacher_gap_routed_apart_tol=MOE_APART_GAP_TOL,
        routes_differ=differ, positions_routed_apart=first,
        positions_routed=n_waves * 8 * (prompt_len + max_tokens),
        routed_apart_margins=sorted(first_margins)[-10:],
        router_logit_max_diff=noise, router_logit_tol=MOE_ROUTER_TOL))
    emit(profile)
    del engine, model, served, taught, s_logits, t_logits
    return {**launches, "forward_shape": shape, "cfg": cfg,
            "tokens": [w[2] for w in waves]}


# ---------------------------------------------------------------------------
# The text surface (llm/_internal/openai.py, batch.py, tokenizer.py).
# A served logprob against the teacher-forced forward's log-softmax at the
# same position: a logprob is a logit minus the row's logsumexp, and each
# moves by at most the largest per-logit difference e between the two
# paths. TEACHER_TOL bounds a chosen token's teacher gap, which is at most
# 2e when the served path picked its own maximum, so it allows e up to
# TEACHER_TOL / 2 and a logprob difference up to 2e = TEACHER_TOL.
OPENAI_LP_TOL = TEACHER_TOL
SSE_HEADER = {"__http__": {"content_type": "text/event-stream"}}


class GenerateLog:
    """Wraps an LLMServer's ``generate`` on the instance (instrumentation
    of this script only): each call's prompt, token ids, logprob items and
    ttft_s, under the key its thread set in ``local.key``. Closing the
    wrapper closes the server's generator, as closing that one would."""

    def __init__(self, srv):
        self.calls, self.local = {}, threading.local()
        inner = srv.generate

        def generate(prompt_ids, **kwargs):
            rec = {"prompt": list(prompt_ids), "tokens": [], "logprobs": [],
                   "top": [], "ttft_s": None}
            self.calls[self.local.key] = rec
            with contextlib.closing(inner(prompt_ids, **kwargs)) as gen:
                for item in gen:
                    rec["tokens"].append(item["token"])
                    if "logprob" in item:
                        rec["logprobs"].append(item["logprob"])
                        rec["top"].append(item["top_logprobs"])
                    if "ttft_s" in item:
                        rec["ttft_s"] = item["ttft_s"]
                    yield item

        srv.generate = generate


def emitted_text(tok, ids):
    """The text incremental decoding emits for ``ids``: the decode of the
    longest prefix whose text does not end in U+FFFD (a partial UTF-8
    character is held back). It is tok.decode(ids) unless that ends in a
    partial character."""
    for n in range(len(ids), -1, -1):
        text = tok.decode(ids[:n])
        if not text.endswith("�"):
            return text
    return ""


def full_vocab_tokenizer(vocab_size):
    """A ByteBPETokenizer of ``vocab_size`` ids (Llama-3's 128,256: 256
    bytes, 127,994 merges, 6 specials) whose every non-special id decodes to
    printable ASCII: merges of two printable bytes, then of such a pair and
    a third."""
    import itertools

    from ray_tpu_torch.llm import ByteBPETokenizer
    from ray_tpu_torch.llm._internal.tokenizer import SPECIAL_TOKENS

    sym = [chr(c) for c in range(0x21, 0x7f)]  # their own byte symbols
    pairs = [(a, b) for a in sym for b in sym]
    triples = ((a + b, c) for a, b in pairs for c in sym)
    n = vocab_size - 256 - len(SPECIAL_TOKENS)
    return ByteBPETokenizer(list(itertools.islice(
        itertools.chain(pairs, triples), n)))


def chat_content(rng, tok, n_ids):
    """A user message of seeded lowercase words that the chat template makes
    exactly ``n_ids`` ids under ``tok``: words are drawn while the template
    is 5 or more ids short, then letters are added to the last word (a
    letter mostly adds one id or none); a draw that overshoots starts
    again."""
    from ray_tpu_torch.llm import apply_chat_template

    letters = list("abcdefghijklmnopqrstuvwxyz")
    for _ in range(100):
        words, n = [], 0
        while n < n_ids:
            if n < n_ids - 4:
                words.append("".join(rng.choice(letters, rng.integers(2, 9))))
            else:
                words[-1] += rng.choice(letters)
            n = len(apply_chat_template(
                tok, [{"role": "user", "content": " ".join(words)}]))
        if n == n_ids:
            return " ".join(words)
    raise RuntimeError(f"no chat message of {n_ids} ids")


def openai_wave(rng, vocab, tok, max_tokens):
    """8 requests: 4 completions of 128 pre-tokenized ids from the whole
    vocab (two streamed, one with logprobs 2) and 4 chats of one user
    message that the chat template makes exactly 128 ids (two streamed,
    one with top_logprobs 2)."""
    wave = []
    for chat in (False, True):
        for i in range(4):
            if chat:
                body = {"messages": [{"role": "user", "content":
                                      chat_content(rng, tok, 128)}]}
            else:
                body = {"prompt": rng.integers(0, vocab, 128).tolist()}
            body["max_tokens"] = max_tokens
            if i < 2:
                body["stream"] = True
            elif i == 2:
                body.update({"logprobs": True, "top_logprobs": 2} if chat
                            else {"logprobs": 2})
            wave.append(("/v1/chat/completions" if chat
                         else "/v1/completions", body))
    return wave


def openai_checks(suffix, body, out, rec, tok, model_id):
    """What the wire must hold for one request, given the ids the server's
    generate gave it. Returns the names of the checks that failed."""
    chat = "chat" in suffix
    ids = rec["tokens"]
    want_text = emitted_text(tok, ids)
    bad = []
    if body.get("stream"):
        if out[0] != SSE_HEADER or out[-1] != "data: [DONE]\n\n":
            bad.append("stream framing")
        chunks = []
        for line in out[1:-1]:
            if not (line.startswith("data: ") and line.endswith("\n\n")):
                bad.append("sse line")
                continue
            chunks.append(json.loads(line[len("data: "):]))
        kind = "chat.completion.chunk" if chat else "text_completion"
        if any(c["object"] != kind or c["model"] != model_id
               or c["id"] != chunks[0]["id"] for c in chunks):
            bad.append("chunk object")
        last = chunks[-1]["choices"][0]
        if (last["finish_reason"] != "stop"
                or last.get("delta", {}) != {} or last.get("text", "") != ""
                or any(c["choices"][0]["finish_reason"] is not None
                       for c in chunks[:-1])):
            bad.append("finish chunk")
        if chat:
            if chunks[0]["choices"][0]["delta"] != {"role": "assistant",
                                                    "content": ""}:
                bad.append("role chunk")
            text = "".join(c["choices"][0]["delta"].get("content", "")
                           for c in chunks[1:-1])
        else:
            text = "".join(c["choices"][0]["text"] for c in chunks[:-1])
        if text != want_text:
            bad.append("stream text")
        return bad
    choice = out["choices"][0]
    if (out["object"] != ("chat.completion" if chat else "text_completion")
            or out["model"] != model_id):
        bad.append("object")
    if out["usage"] != {"prompt_tokens": 128, "completion_tokens": len(ids),
                        "total_tokens": 128 + len(ids)}:
        bad.append("usage")
    if choice["finish_reason"] != ("stop" if ids[-1] == tok.eot_id
                                   else "length"):
        bad.append("finish_reason")
    text = choice["message"]["content"] if chat else choice["text"]
    if text != want_text:
        bad.append("text")
    if body.get("logprobs"):
        lp = choice["logprobs"]
        if chat:
            got = [(e["token"], e["logprob"],
                    [(t["token"], t["logprob"]) for t in e["top_logprobs"]])
                   for e in lp["content"]]
            want = [(tok.decode([t]), v, [(tok.decode([i]), x)
                                          for i, x in top])
                    for t, v, top in zip(ids, rec["logprobs"], rec["top"])]
        else:
            got = (lp["tokens"], lp["token_logprobs"], lp["top_logprobs"])
            want = ([tok.decode([t]) for t in ids], rec["logprobs"],
                    [{tok.decode([i]): x for i, x in top}
                     for top in rec["top"]])
        if got != want or len(rec["logprobs"]) != len(ids):
            bad.append("logprobs block")
    return bad


def greedy_top_ok(rec):
    """Greedy: each token's logprob equals the first of its top_logprobs,
    whose token is its own, and equal values come lowest id first, as the
    reference's jax.lax.top_k orders them (bf16 logits tie often). Returns
    (ok, the tokens whose first two alternatives tie)."""
    ok, ties = True, 0
    for t, v, top in zip(rec["tokens"], rec["logprobs"], rec["top"]):
        ties += len(top) > 1 and top[0][1] == top[1][1]
        ok = ok and top[0] == (t, v) and all(
            a[1] > b[1] or (a[1] == b[1] and a[0] < b[0])
            for a, b in zip(top, top[1:]))
    return ok, ties


def serve_openai_phase(dev, wrappers, serve_8b):
    """OpenAIServer at Llama-3-8B width (32 layers, bf16, serve_8b's
    engine) with a tokenizer of the model's 128,256 ids
    (``full_vocab_tokenizer``, saved and passed as ``tokenizer_path``), so
    that every id the random model emits is text: one warm wave, then two
    measured waves of 8 greedy requests (``openai_wave``) of 128 prompt ids
    and 48 new tokens, each admitted whole. Every response is held to the
    ids the server generated for it (``openai_checks``), every answer to a
    teacher-forced forward (K1), every logprob to the teacher's
    log-softmax. Then a 400 (top_p 0), a stream closed after 5 deltas, and
    the device time of the engine's logprob ordering."""
    import tempfile

    from ray_tpu_torch.llm import OpenAIServer
    from ray_tpu_torch.models.llama import LlamaConfig

    n_waves, max_tokens, K = 2, 48, 8
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        tok_path = os.path.join(tmp, "tokenizer.json")
        full_vocab_tokenizer(LlamaConfig.llama3_8b().vocab_size).save(
            tok_path)
        t0 = time.perf_counter()
        oai = OpenAIServer({
            "model": "llama3-8b", "seed": 0, "tokenizer_path": tok_path,
            "engine_config": {"max_seqs": 8, "page_size": 64,
                              "max_pages_per_seq": 8, "decode_steps": K}},
            device=dev)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
    srv, tok, model_id = oai.server, oai.tokenizer, oai.model_id
    cfg = srv.model.cfg
    log = GenerateLog(srv)
    rng = np.random.default_rng(30)

    def wave(w):
        reqs = openai_wave(rng, cfg.vocab_size, tok, max_tokens)
        outs = [None] * len(reqs)

        def go(i):
            log.local.key = (w, i)
            out = oai({"suffix": reqs[i][0], "body": reqs[i][1]})
            outs[i] = out if isinstance(out, dict) else list(out)

        threads = [threading.Thread(target=go, args=(i,))
                   for i in range(len(reqs))]
        t = time.perf_counter()
        with srv.paused():
            for th in threads:
                th.start()
            while srv.stats()["pending"] < len(reqs):
                if time.perf_counter() - t > 60:
                    raise RuntimeError("requests did not reach the server")
                time.sleep(0.001)
        for th in threads:
            th.join(600)
        if any(th.is_alive() for th in threads):
            raise RuntimeError("an OpenAI request did not finish")
        wall = time.perf_counter() - t
        return reqs, outs, [log.calls[(w, i)] for i in range(len(reqs))], wall

    try:
        wave("warm")
        zero_counts(wrappers)
        waves = [wave(w) for w in range(n_waves)]
        gaps, lps, finite, shape = teacher_gaps(
            srv.model, [[(r["prompt"], r["tokens"]) for r in recs]
                        for _, _, recs, _ in waves], dev)
        max_gap = max(g for w in gaps for row in w for g in row)
        bad, windows, lp_err, ties = {}, [], 0.0, 0
        for w, (reqs, outs, recs, _) in enumerate(waves):
            for i, ((suffix, body), out, rec) in enumerate(
                    zip(reqs, outs, recs)):
                failed = openai_checks(suffix, body, out, rec, tok, model_id)
                if body.get("logprobs"):
                    ok, n_ties = greedy_top_ok(rec)
                    ties += n_ties
                    if not ok:
                        failed.append("greedy top_logprobs")
                if failed:
                    bad[f"wave{w}_req{i}"] = failed
            # One admission a wave: the prefill gives each request its first
            # token, then windows of K steps until the longest answer ends.
            windows.append(math.ceil(
                (max(len(r["tokens"]) for r in recs) - 1) / K))
            for (_, body), rec, lp in zip(reqs, recs, lps[w]):
                if body.get("logprobs"):
                    err = max(abs(a - b) for a, b in zip(rec["logprobs"], lp))
                    lp_err = max(lp_err, err)
        torch.cuda.synchronize()
        launches = read_counts(wrappers)
        peak_gb = torch.cuda.max_memory_allocated() / GB
        lp_ok = lp_err <= OPENAI_LP_TOL

        # A bad request: the documented 400 body, and nothing left running.
        err_body = oai({"suffix": "/v1/completions",
                        "body": {"prompt": [1, 2, 3], "top_p": 0}})
        st = srv.stats()
        ok_error = (err_body["__http__"] == {"status": 400}
                    and err_body["body"]["error"]["type"]
                    == "invalid_request_error"
                    and (st["running"], st["waiting"], st["pending"])
                    == (0, 0, 0))

        # A stream closed after 5 deltas must abort the engine request: the
        # slot is released by the engine step that processes the abort, at
        # most the second step to start after the close (the first may have
        # drained the abort queue just before it).
        steps = {"n": 0}
        engine_step = srv.engine.step

        def counted_step():
            steps["n"] += 1
            return engine_step()

        srv.engine.step = counted_step
        log.local.key = "early_close"
        stream = oai({"suffix": "/v1/completions", "body": {
            "prompt": rng.integers(0, cfg.vocab_size, 128).tolist(),
            "max_tokens": max_tokens, "stream": True}})
        items = [next(stream) for _ in range(6)]  # the header, 5 deltas
        stream.close()
        t_close, steps_at_close = time.perf_counter(), steps["n"]
        while True:
            st = srv.stats()
            if (st["running"], st["waiting"], st["pending"]) == (0, 0, 0):
                break
            if time.perf_counter() - t_close > 30:
                break
            time.sleep(0.001)
        close_s = time.perf_counter() - t_close
        close_steps = steps["n"] - steps_at_close
        srv.engine.step = engine_step
        early = log.calls["early_close"]
        ok_close = (st["running"] == 0 and st["waiting"] == 0
                    and close_steps <= 2 and items[0] == SSE_HEADER
                    and all(json.loads(x[len("data: "):])["choices"][0]
                            ["finish_reason"] is None for x in items[1:])
                    and len(early["tokens"]) < max_tokens)
    finally:
        srv.shutdown()
    # The engine orders each step's top logprobs by a stable sort of the
    # whole [max_seqs, vocab] f32 log-softmax (engine._sample), once a
    # sampling step while a logprob request runs: the prefill's and K a
    # window's. Timed here beside topk on bf16-valued logits, which tie.
    logits = torch.randn((8, cfg.vocab_size), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(31),
                         dtype=torch.bfloat16).float()
    sets = copies((torch.log_softmax(logits, -1),), nbytes(logits))
    sort_ms = cuda_ms(lambda x: x.sort(dim=-1, descending=True, stable=True),
                      sets)
    topk_ms = cuda_ms(lambda x: x.topk(2, dim=-1), sets)
    sorts = [1 + K * n for n in windows]
    del logits, sets
    # The text checks compare something: every answer decodes to text.
    text_tokens = sum(tok.decode([t]) != "" for _, _, recs, _ in waves
                      for r in recs for t in r["tokens"])
    ok_text = all(emitted_text(tok, r["tokens"]) for _, _, recs, _ in waves
                  for r in recs)
    k4 = cfg.num_layers * K * sum(windows)
    k1 = n_waves * cfg.num_layers
    ok_launch = launch_ok(launches, k4, k1)
    ok = (not bad and max_gap <= TEACHER_TOL and finite and lp_ok
          and ok_launch and ok_error and ok_close and ok_text)
    check(ok, "OpenAI serving")
    tps = [sum(len(r["tokens"]) for r in recs) / wall
           for _, _, recs, wall in waves]
    ttft = [[r["ttft_s"] for r in recs] for _, _, recs, _ in waves]
    emit({"phase": "serve_openai", "layers": cfg.num_layers,
          "dtype": str(cfg.dtype).split(".")[-1], "model": model_id,
          "tokenizer": f"full vocab ({tok.vocab_size} ids, tokenizer_path)",
          "requests": 8, "prompt_tokens": 128, "max_tokens": max_tokens,
          "decode_steps": K, "waves": n_waves, "setup_s": setup_s,
          "wall_s": [w[3] for w in waves], "tokens_per_s": tps,
          "tokens_per_s_median": float(np.median(tps)),
          "ttft_mean_s": [float(np.mean(t)) for t in ttft],
          "ttft_max_s": [max(t) for t in ttft],
          "tokens": [[len(r["tokens"]) for r in recs]
                     for _, _, recs, _ in waves],
          "text_tokens": text_tokens, "every_answer_text": ok_text,
          "peak_mem_gb": peak_gb, "failed_checks": bad,
          "teacher_max_gap": max_gap, "teacher_tol": TEACHER_TOL,
          "logprob_max_err": lp_err, "logprob_tol": OPENAI_LP_TOL,
          "top_logprob_ties": ties,
          "logprob_sort": {"shape": [8, cfg.vocab_size], "ms": sort_ms,
                           "topk_ms": topk_ms, "sorts_per_wave": sorts,
                           "ms_per_wave": [sort_ms * n for n in sorts]},
          "launches": launches,
          "paged_decode_expected": k4, "flash_fwd_expected": k1,
          "error_400": err_body, "error_ok": ok_error,
          "early_close": {"tokens_before_close": len(early["tokens"]),
                          "engine_steps_after_close": close_steps,
                          "seconds_to_idle": close_s, "stats": st,
                          "ok": ok_close},
          "serve_8b": serve_8b, "ok": ok})
    return {**launches, "forward_shape": shape}


def batch_8b_phase(dev, wrappers):
    """The batch engine stage (llm/_internal/batch.py ``_EngineStage``) at
    Llama-3-8B width (32 layers, bf16, serve_8b's engine) on one block of 8
    rows: ragged prompts of 64, 80, ..., 176 seeded ids, a max_tokens column
    that gives one row 16 and the rest 48, greedy, no stop token (the
    config's default). One warm block, then the measured one, checked
    against a teacher-forced forward (K1) of all 8 rows right-padded to one
    [8, 224] batch."""
    from ray_tpu_torch.llm import ProcessorConfig
    from ray_tpu_torch.llm._internal.batch import _EngineStage

    K, n = 8, 8
    lens = [64 + 16 * i for i in range(n)]
    budgets = [48] * n
    budgets[5] = 16
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stage = _EngineStage(ProcessorConfig(llm_config={
        "model": "llama3-8b", "seed": 0, "engine_config": {
            "max_seqs": 8, "page_size": 64, "max_pages_per_seq": 8,
            "decode_steps": K}}, max_tokens=48), device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg = stage.engine.model.cfg

    def block(seed):
        rng = np.random.default_rng(seed)
        col = np.empty(n, dtype=object)
        col[:] = [rng.integers(0, cfg.vocab_size, m) for m in lens]
        return {"prompt_ids": col, "max_tokens": np.array(budgets)}

    stage(block(40))  # warm
    zero_counts(wrappers)
    batch = block(41)
    t = time.perf_counter()
    out = stage(batch)
    wall = time.perf_counter() - t
    ids = out["generated_ids"]
    gaps, _, finite, shape = teacher_gaps(
        stage.engine.model, [[(p.tolist(), g.tolist())
                              for p, g in zip(batch["prompt_ids"], ids)]],
        dev)
    torch.cuda.synchronize()
    launches = read_counts(wrappers)
    peak_gb = torch.cuda.max_memory_allocated() / GB
    max_gap = max(g for row in gaps[0] for g in row)
    ok_column = (ids.dtype == object and ids.shape == (n,)
                 and all(r.dtype == np.int32 for r in ids)
                 and out["num_generated"].dtype == np.int64)
    # No stop token: every row generates its whole budget.
    ok_counts = out["num_generated"].tolist() == budgets and all(
        len(r) == b for r, b in zip(ids, budgets))
    # All 8 rows are admitted at the first step (8 slots): the prefill gives
    # each its first token, then windows of K steps run until the longest
    # budget ends, one K4 launch per layer and step.
    k4 = cfg.num_layers * K * math.ceil((max(budgets) - 1) / K)
    k1 = cfg.num_layers
    ok = (ok_column and ok_counts and finite and max_gap <= TEACHER_TOL
          and launch_ok(launches, k4, k1))
    check(ok, "8B batch stage")
    tokens = int(out["num_generated"].sum())
    emit({"phase": "batch_8b", "layers": cfg.num_layers,
          "dtype": str(cfg.dtype).split(".")[-1], "rows": n,
          "prompt_tokens": lens, "max_tokens": budgets, "decode_steps": K,
          "setup_s": setup_s, "wall_s": wall, "rows_per_s": n / wall,
          "tokens": tokens, "tokens_per_s": tokens / wall,
          "num_generated": out["num_generated"].tolist(),
          "object_column": ok_column, "peak_mem_gb": peak_gb,
          "teacher_max_gap": max_gap, "teacher_tol": TEACHER_TOL,
          "teacher_forward": "one padded batch", "launches": launches,
          "paged_decode_expected": k4, "flash_fwd_expected": k1,
          "ok": ok})
    final_lens = [m + b - 1 for m, b in zip(lens, budgets)]
    return {**launches, "forward_shape": shape, "decode_seq_lens": final_lens}


# Tensor-parallel phases: the ranks share this card over gloo (NCCL refuses
# two ranks on one device), so their tokens/s measure gloo's host round
# trips, not TP speed. tp_tiny holds TP 2's cacheless logits to TP 1's at
# f32 (the partial sums of o_proj, down_proj and the embedding are added
# in another order). serve_8b_tp2 holds the TP 2 flash forward's
# log-softmax of the served answers to the TP 1 flash forward's on the
# same ids: both round activations to bf16 at the same places but for the
# row-parallel sums (each rank's partial rounded to bf16, then summed in
# f32), which move a logit by about an ulp a layer; the limit is
# TEACHER_TOL's 8 bf16 ulps of a logit in [4, 8), stated before the first
# run.
TP_TINY_TOL = 1e-4
TP_LOGPROB_TOL = 0.25


def rank_launches_ok(counts, k4, k1):
    return all(c["paged_decode"] == k4 and c["flash_fwd"] == k1
               for c in counts)


def tp_tiny_phase(dev):
    """Tiny f32 Llama with flash attention at tensor_parallel_size=2, both
    ranks on this card over gloo, against the same seeded model at TP 1:
    greedy tokens identical, the cacheless forward's logits within
    TP_TINY_TOL, and each rank's K4 and K1 launches exact (K4 on local
    heads H 2 / HK 1, K1 on [2, 10, 2/1, 32] f32)."""
    from ray_tpu_torch.llm import LLMServer
    from ray_tpu_torch.models.llama import LlamaConfig

    cfg = dataclasses.replace(LlamaConfig.tiny(vocab_size=128),
                              attention_impl="flash")
    K, max_tokens = 2, 6
    llm = {"model": "custom", "model_config": dataclasses.asdict(cfg),
           "seed": 0, "engine_config": {"max_seqs": 2, "page_size": 4,
                                        "max_pages_per_seq": 16,
                                        "decode_steps": K}}
    prompts = [[5, 17, 42], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], [100, 3],
               [11, 22, 33, 44]]
    ids = torch.tensor([[5, 17, 42, 7, 99, 3, 0, 127, 64, 1],
                        [1, 2, 3, 4, 42, 7, 99, 3, 0, 9]])
    srv = LLMServer(llm, device=dev)
    try:
        want = [srv.generate_all(p, max_tokens=max_tokens)["tokens"]
                for p in prompts]
        with torch.no_grad():
            ref = srv.model(ids.to(dev)).float()
    finally:
        srv.close()
    t0 = time.perf_counter()
    srv = LLMServer(dict(llm, tensor_parallel_size=2, tp_backend="gloo"),
                    device=dev)
    setup_s = time.perf_counter() - t0
    runner = srv.engine.runner
    procs = list(runner._procs)
    try:
        runner.counters(reset=True)
        got = [srv.generate_all(p, max_tokens=max_tokens)["tokens"]
               for p in prompts]
        logits = runner.forward(ids).to(dev).float()
        counts = runner.counters()
    finally:
        srv.close()
    err = (logits - ref).abs().max().item()
    k4 = len(prompts) * cfg.num_layers * K * math.ceil((max_tokens - 1) / K)
    ok = (got == want and err <= TP_TINY_TOL
          and rank_launches_ok(counts, k4, cfg.num_layers)
          and all(p.poll() is not None for p in procs))
    check(ok, "tiny TP 2 vs TP 1")
    emit({"phase": "tp_tiny", "tensor_parallel_size": 2, "backend": "gloo",
          "ranks": runner.info, "setup_s": setup_s, "tokens": got,
          "tp1_tokens": want, "logits_max_abs_err": err,
          "tol": TP_TINY_TOL, "rank_launches": counts,
          "paged_decode_expected": k4, "flash_fwd_expected": cfg.num_layers,
          "ok": ok})


def serve_8b_tp2_phase(dev):
    """serve_8b's engine config and waves at tensor_parallel_size=2: each
    rank holds half of Llama-3-8B (32 layers, bf16, seeded: exactly TP 1's
    slices) and of the paged KV cache, both on this card over gloo. The
    served answers are teacher-forced through the TP model's own flash
    forward (K1 on local heads, 16 / 4); its log-softmax of the answers is
    held to TP 1's flash forward's on the same ids (TP_LOGPROB_TOL); each
    rank's K4 launches are exact (num_layers x K x ceil((max_tokens - 1) /
    K) a wave) and its peak memory is reported."""
    from ray_tpu_torch.llm import LLMServer
    from ray_tpu_torch.models.llama import LlamaModel, init_params

    n_req, prompt_len, max_tokens, K, n_waves = 8, 128, 48, 8, 3
    t0 = time.perf_counter()
    srv = LLMServer({"model": "llama3-8b", "seed": 0, "engine_config": {
        "max_seqs": 8, "page_size": 64, "max_pages_per_seq": 8,
        "decode_steps": K}, "tensor_parallel_size": 2, "tp_backend": "gloo"},
        device=dev)
    setup_s = time.perf_counter() - t0
    runner = srv.engine.runner
    procs = list(runner._procs)
    cfg = srv.model.cfg
    rng = np.random.default_rng(0)
    try:
        server_wave(srv, rng, cfg.vocab_size, n_req, prompt_len, max_tokens)
        start = runner.counters(reset=True)  # peaks since start: weights in
        waves = [server_wave(srv, rng, cfg.vocab_size, n_req, prompt_len,
                             max_tokens) for _ in range(n_waves)]
        rows = [list(zip(prompts, [r["tokens"] for r in res]))
                for prompts, res, _ in waves]
        decoded = runner.counters()
        t = time.perf_counter()
        gaps, lps, finite, shape = teacher_gaps(
            lambda ids: runner.forward(ids).to(dev), rows, dev)
        teacher_s = time.perf_counter() - t
        counts = runner.counters()
    finally:
        srv.close()
    gone = all(p.poll() is not None for p in procs)
    gc.collect()
    torch.cuda.empty_cache()
    model = LlamaModel(cfg, device=dev)
    init_params(model, torch.Generator(device=dev).manual_seed(0))
    _, lps_1, finite_1, _ = teacher_gaps(model, rows, dev)
    del model
    lp_err = max(abs(a - b) for w, w1 in zip(lps, lps_1)
                 for r, r1 in zip(w, w1) for a, b in zip(r, r1))
    max_gap = max(g for w in gaps for r in w for g in r)
    ok_tokens = all(len(r["tokens"]) == max_tokens
                    for _, res, _ in waves for r in res)
    k4 = n_waves * cfg.num_layers * K * math.ceil((max_tokens - 1) / K)
    ok_launch = (rank_launches_ok(decoded, k4, 0)
                 and rank_launches_ok(counts, k4, n_waves * cfg.num_layers))
    ok = (ok_tokens and finite and finite_1 and max_gap <= TEACHER_TOL
          and lp_err <= TP_LOGPROB_TOL and ok_launch and gone)
    check(ok, "8B TP 2 serving")
    tps = [sum(len(r["tokens"]) for r in res) / w for _, res, w in waves]
    emit({"phase": "serve_8b_tp2", "layers": cfg.num_layers,
          "dtype": "bfloat16", "tensor_parallel_size": 2, "backend": "gloo",
          "ranks": runner.info, "requests": n_req,
          "prompt_tokens": prompt_len, "max_tokens": max_tokens,
          "decode_steps": K, "waves": n_waves, "setup_s": setup_s,
          "wall_s": [w for _, _, w in waves],
          "tokens_per_s_ranks_sharing_one_card_over_gloo": tps,
          "ttft_mean_s": [float(np.mean([r["ttft_s"] for r in res]))
                          for _, res, _ in waves],
          "rank_peak_gb_with_weights": [c.get("peak_gb") for c in start],
          "rank_peak_gb_serving": [c.get("peak_gb") for c in counts],
          "teacher_s": teacher_s, "teacher_max_gap": max_gap,
          "teacher_tol": TEACHER_TOL,
          "tp1_logprob_max_abs_diff": lp_err,
          "tp1_logprob_tol": TP_LOGPROB_TOL, "rank_launches": counts,
          "paged_decode_expected": k4,
          "flash_fwd_expected": n_waves * cfg.num_layers,
          "ranks_exited": gone, "ok": ok})
    return {"forward_shape": shape, "rank_launches": counts,
            "decode_seq_len": prompt_len + max_tokens}


# serve_moe's engine over two ranks sharing this card (serve_moe_mesh): at
# {"tensor": 2} each rank holds 16 of 32 query heads, 4 of 8 kv heads and
# every expert's half of the "mlp" dim, at {"expert": 2} 4 of the 8 experts
# and every head. TP rounds each rank's bf16 partials before their f32 sum
# and EP sums the experts' f32 partials in another order, so a token whose
# two best experts nearly tie may route apart from one card: as in
# serve_moe, MOE_TEACHER_SHARE of the answer positions must hold the dense
# limits (TEACHER_TOL, TP_LOGPROB_TOL) and every position
# MOE_APART_GAP_TOL (limits stated before the first run).
MOE_MESHES = ({"tensor": 2}, {"expert": 2})
MOE_MESH_WAVES = 2


def serve_moe_mesh_phase(dev, moe):
    """serve_moe's config (the 8B widths, 8 experts, capacity factor 8, 4 of
    32 layers, bf16, seed 0) and engine config through LLMEngine(mesh=) at
    each of MOE_MESHES, its two rank processes sharing this card over gloo
    (llm/_internal/tp.py): the first MOE_MESH_WAVES of serve_moe's waves
    (the same prompts), after its warm wave. Against serve_moe's one-card
    run (``moe``): the share of its greedy tokens the mesh repeats, and the
    log-softmax of the mesh's answers teacher-forced through the mesh's
    flash forward (K1 on each rank's local heads) against serve_moe's
    model's on the same ids; the mesh's answers' teacher gaps. Each rank's
    K4 and K1 launches are exact; its peak memory is recorded."""
    from ray_tpu_torch.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.llm._internal.runner import SeededParams
    from ray_tpu_torch.models.llama import LlamaModel, init_params
    from ray_tpu_torch.parallel.mesh import create_mesh

    cfg, K, max_tokens = moe["cfg"], 8, 48
    card = dev
    if dev.type == "cuda" and dev.index is None:
        card = torch.device("cuda", torch.cuda.current_device())
    runs = []
    for shape in MOE_MESHES:
        t0 = time.perf_counter()
        engine = LLMEngine(
            LlamaModel(cfg, device="meta"), SeededParams(0),
            EngineConfig(max_seqs=8, page_size=64, max_pages_per_seq=8,
                         decode_steps=K),
            mesh=create_mesh(shape, devices=[card] * 2), tp_backend="gloo")
        setup_s = time.perf_counter() - t0
        runner = engine.runner
        procs = list(runner._procs)
        try:
            engine_waves(engine, cfg.vocab_size, 1, 8, seed=20)  # warm
            start = runner.counters(reset=True)  # peaks since start
            waves = engine_waves(engine, cfg.vocab_size, MOE_MESH_WAVES,
                                 max_tokens, seed=21)
            decoded = runner.counters()
            rows = [list(zip(p, t)) for p, _, t, _, _ in waves]
            t = time.perf_counter()
            gaps, lps, finite, fshape = teacher_gaps(
                lambda ids: runner.forward(ids).to(dev), rows, dev)
            teacher_s = time.perf_counter() - t
            counts = runner.counters()
        finally:
            engine.close()
        runs.append({"shape": shape, "setup_s": setup_s, "info": runner.info,
                     "start": start, "waves": waves, "decoded": decoded,
                     "rows": rows, "gaps": gaps, "lps": lps,
                     "finite": finite, "forward_shape": fshape,
                     "teacher_s": teacher_s, "counts": counts,
                     "gone": all(p.poll() is not None for p in procs)})
    gc.collect()
    torch.cuda.empty_cache()
    model = LlamaModel(cfg, device=dev)
    init_params(model, torch.Generator(device=dev).manual_seed(0))
    for run in runs:
        _, run["lps_1"], run["finite_1"], _ = teacher_gaps(model, run["rows"],
                                                           dev)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    for run in runs:
        shape, waves = run["shape"], run["waves"]
        label = "_".join(f"{a}{n}" for a, n in shape.items())
        gaps = [g for w in run["gaps"] for r in w for g in r]
        diffs = [abs(a - b) for w, w1 in zip(run["lps"], run["lps_1"])
                 for r, r1 in zip(w, w1) for a, b in zip(r, r1)]
        ones = [t for w in moe["tokens"][:MOE_MESH_WAVES] for t in w]
        mine = [t for w in waves for t in w[2]]
        same = sum(a == b for x, y in zip(mine, ones) for a, b in zip(x, y))
        prefix = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b),
                       len(x)) for x, y in zip(mine, ones)]
        held_gap = sum(g <= TEACHER_TOL for g in gaps) / len(gaps)
        held_lp = sum(d <= TP_LOGPROB_TOL for d in diffs) / len(diffs)
        k4 = MOE_MESH_WAVES * cfg.num_layers * K * math.ceil(
            (max_tokens - 1) / K)
        k1 = MOE_MESH_WAVES * cfg.num_layers
        ok_launch = (rank_launches_ok(run["decoded"], k4, 0)
                     and rank_launches_ok(run["counts"], k4, k1))
        ok = (all(len(t) == max_tokens for t in mine) and run["finite"]
              and run["finite_1"] and held_gap >= MOE_TEACHER_SHARE
              and max(gaps) <= MOE_APART_GAP_TOL
              and held_lp >= MOE_TEACHER_SHARE
              and max(diffs) <= MOE_APART_GAP_TOL and ok_launch
              and run["gone"])
        check(ok, f"MoE serving at {shape}")
        emit({"phase": f"serve_moe_mesh_{label}", "mesh": shape,
              "layers": cfg.num_layers, "of_layers": 32,
              "experts": cfg.num_experts,
              "capacity_factor": cfg.moe_capacity_factor,
              "dtype": "bfloat16", "backend": "gloo", "ranks": run["info"],
              "requests": 8, "prompt_tokens": 128, "max_tokens": max_tokens,
              "decode_steps": K, "waves": MOE_MESH_WAVES,
              "setup_s": run["setup_s"],
              "wall_s": [w[4] for w in waves],
              "tokens_per_s_ranks_sharing_one_card_over_gloo":
                  [sum(len(t) for t in w[2]) / w[4] for w in waves],
              "tokens_equal_to_one_card": same,
              "tokens": len(mine) * max_tokens,
              "rows_equal_to_one_card": sum(p == max_tokens
                                             for p in prefix),
              "rows_first_token_apart": sorted(prefix),
              "teacher_s": run["teacher_s"], "teacher_max_gap": max(gaps),
              "teacher_share_within_tol": held_gap,
              "teacher_tol": TEACHER_TOL,
              "one_card_logprob_max_abs_diff": max(diffs),
              "one_card_logprob_share_within_tol": held_lp,
              "one_card_logprob_tol": TP_LOGPROB_TOL,
              "share_min": MOE_TEACHER_SHARE,
              "apart_tol": MOE_APART_GAP_TOL,
              "rank_peak_gb_with_weights": [c.get("peak_gb")
                                            for c in run["start"]],
              "rank_peak_gb_serving": [c.get("peak_gb")
                                       for c in run["counts"]],
              "rank_launches": run["counts"], "paged_decode_expected": k4,
              "flash_fwd_expected": k1, "ranks_exited": run["gone"],
              "ok": ok})
        out[label] = {"forward_shape": run["forward_shape"],
                      "rank_launches": run["counts"],
                      "heads": (run["info"][0]["heads"],
                                run["info"][0]["kv_heads"])}
    return out


# ---------------------------------------------------------------------------
# Sharded training (train/step.py with mesh=, parallel/fsdp.py,
# parallel/launch.py): rank processes sharing this card over gloo, each
# phase's TP 1 run in this process before its ranks start.
#
# Tiny, f32, flash, TF32 off: the CPU parity tests' limits
# (tests/test_torch_train_sharded.py), against TP 1 on this card: losses
# within 1e-5 relative, step-1 gradients within 5e-4 (the JAX tests'
# gradient limit, tests/test_attention.py:78), weights after 3 steps within
# 1e-4. The weights' limit is meaningful only where the step-1 gradient is
# not zero up to f32 rounding: AdamW moves a weight by lr * g / (|g| +
# 1e-8), so a gradient of 5e-9 that the data ranks' sum of two halves
# moves by 3e-9 moves its weight by about 0.1 lr. Most batches of 2 x 64
# ids give the tiny model such gradients (on the CPU, rng seeds 0-11 with
# weight seed 3: 10 of 12 have one below 1e-8; the card's sums differ
# again). So the weights are held where TP 1's step-1 gradient is 0 or at
# least MESH_TINY_GRAD_FLOOR (ten times Adam's eps); the phase reports the
# elements outside, their worst error and the error over all elements.
MESH_TINY_LOSS_RTOL = 1e-5
MESH_TINY_GRAD_ATOL = 5e-4
MESH_TINY_PARAM_ATOL = 1e-4
MESH_TINY_GRAD_FLOOR = 1e-7
# 8B widths, bf16 compute: TP rounds each rank's partial of a row-parallel
# product (o_proj, down_proj, the vocab-parallel embedding) to bf16 before
# the f32 sum, where TP 1 rounds the whole product once: about one bf16 ulp
# (2^-8 relative) on those activations a layer, and FSDP sums each rank's
# bf16 weight gradient in f32 where TP 1 rounds one product over the whole
# batch. The mean loss over 4,094 positions averages such errors down: the
# limit is train_8b's flash-against-plain 1e-2 (0.1 % of a loss near
# ln(128256) = 11.8), stated before the first run. A weight gradient's
# rank slice is held to TP 1's same slice by its relative Frobenius error:
# a weight gradient is a bf16 product of activations and output gradients
# that each carry those roundings through 2 layers forward and back, about
# six of them of up to 2^-8 relative (2.3 %); the limit is 5e-2, twice
# that, stated before the first run (a CPU rehearsal at reduced widths
# read 1.1-1.4 %). A gradient missing a rank's sum is off by 50 % or more.
MESH_8B_LOSS_TOL = 1e-2
MESH_8B_GRAD_RTOL = 5e-2
# Llama-3-8B widths cut to 2 of 32 layers: 1.487 B parameters at 16 B
# each (f32 weight, gradient, two AdamW moments) are 23.8 GB at TP 1 (run
# first, in this process) and 11.9 GB a rank at TP 2.
MESH_8B_LAYERS = 2
MESH_GRADS = ("layers.0.self_attn.q_proj.weight",
              "layers.0.mlp.down_proj.weight")
# Expert parallelism (train_moe_8b_ep2_tp2): the MoE Llama of serve_moe (8
# experts) at the 8B widths cut to 1 of 32 layers. An MoE layer holds 1.41 B
# expert parameters, 22.5 GB at 16 B each (f32 weight, gradient, two AdamW
# moments); one layer with the embedding and lm_head is 2.50 B, 40 GB on
# the one device (run first, in this process), and ≈ 0.90 B, 14.4 GB, a
# rank at {"expert": 2, "tensor": 2}: ≈ 58 GB for the four ranks on the
# card before activations (two layers would need ≈ 81 GB). The loss is
# held as the dense phases' (MESH_8B_LOSS_TOL). The gradients (a rank's
# slice of gate_kernel, the router, a q_proj) are not: a token whose two
# best experts nearly tie routes apart under another rounding, and each
# such token moves a whole expert's contribution. One device's own bf16
# gradients of this layer lie 9-13 % (relative Frobenius) from its
# f32-compute ones at reduced widths (hidden 256; a dense layer's 1.2 %),
# and the ranks' 7-9 % from the one device's in a CPU rehearsal there. So
# MOE_8B_GRAD_RTOL is 0.25, stated before the first run: a gradient
# missing its sum over the expert or the tensor group is off by 50 % or
# more.
MOE_8B_LAYERS = 1
MOE_8B_EXPERTS = 8
MOE_8B_GRAD_RTOL = 0.25
# The losses after the first step are not held to MESH_8B_LOSS_TOL alone:
# AdamW moves every router weight by about lr whatever its gradient's
# size, so the gradients' rounding differences turn into different routes
# after a step or two. The first chip run of this phase read 9.8e-4 and
# 5.3e-4 off the one device at steps 1 and 2, then 0.102 at step 3 (the
# one device's loss 10.07). So the one device also takes the same steps
# with plain attention (another rounding of the same step, as train_8b's
# yardstick), and step i's loss is held to the larger of MESH_8B_LOSS_TOL
# and MOE_LOSS_NOISE times that run's distance from the flash run at step
# i (factor stated before the run that first applied it).
MOE_LOSS_NOISE = 2.0
MOE_GRADS = ("layers.0.self_attn.q_proj.weight",
             "layers.0.mlp.router.weight", "layers.0.mlp.gate_kernel")


def mesh_launches_ok(results, want):
    return all(r["launches"] == want for r in results)


def train_tiny_mesh_phase(dev):
    """dryrun_multigpu(4) ({"seq": 2, "tensor": 2} with ring attention,
    tiny, one step; then its pipeline at {"stage": 2, "data": 2} and a step
    of the tiny MoE Llama at {"expert": 2, "data": 2}) with its four ranks
    on this card; then the tiny f32 flash model at {"data":
    2} for 3 AdamW steps at lr 1e-3 on train_tiny's batch and seed, against
    the port's TP 1 on this card: each rank's losses, its step-1 gradients
    and the unsharded weights within the CPU limits (MESH_TINY_*), K1, K2
    and K3 exactly 2 a step on every rank (2 layers, no remat)."""
    from ray_tpu_torch.entry import dryrun_multigpu, full_params, \
        mesh_shape_for, train_on_ranks
    from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step

    t0 = time.perf_counter()
    dry = dryrun_multigpu(4, device=dev)
    dry_s = time.perf_counter() - t0
    cfg = dataclasses.replace(LlamaConfig.tiny(), attention_impl="flash")
    ids = np.random.default_rng(2).integers(0, 512, (2, 64))
    steps, lr, seed = 3, 1e-3, 3
    model = LlamaModel(cfg, device=dev, param_dtype=torch.float32)
    opt = adamw(model.parameters(), lr)
    batch = torch.from_numpy(ids).to(dev)
    state = init_train_state(model, opt, batch, device=dev,
                             generator=torch.Generator(
                                 device=dev).manual_seed(seed))
    step = make_train_step(model, opt)
    losses = []
    for i in range(steps):
        losses.append(step(state, batch, batch)[1].item())
        if i == 0:
            grads = {n: p.grad.cpu().numpy()
                     for n, p in model.named_parameters()}
    want = {n: p.detach().cpu().numpy() for n, p in model.named_parameters()}
    del model, opt, state
    t0 = time.perf_counter()
    res = train_on_ranks({"data": 2}, cfg, ids, steps, lr, device=dev,
                         seed=seed, want_params=True, grads_of=list(want))
    ranks_s = time.perf_counter() - t0
    got = full_params(res)
    loss_rel = max(abs(a - b) / abs(b) for r in res
                   for a, b in zip(r["losses"], losses))
    grad_err = max(float(np.abs(r["grads"][n] - grads[n]).max())
                   for r in res for n in grads)
    err = {n: np.abs(got[n] - want[n]) for n in want}
    held = {n: (grads[n] == 0) | (np.abs(grads[n]) >= MESH_TINY_GRAD_FLOOR)
            for n in want}
    param_err = max(float(err[n][held[n]].max()) for n in want)
    param_err_all = max(float(err[n].max()) for n in want)
    outside = {n: int((~held[n]).sum()) for n in want if (~held[n]).any()}
    worst = max(want, key=lambda n: err[n].max())
    worst_grad = float(np.abs(grads[worst]).ravel()[err[worst].argmax()])
    per_step = cfg.num_layers
    launches = {"flash_fwd": steps * per_step,
                "flash_bwd_dq": steps * per_step,
                "flash_bwd_dkv": steps * per_step}
    ok = (math.isfinite(dry) and loss_rel <= MESH_TINY_LOSS_RTOL
          and grad_err <= MESH_TINY_GRAD_ATOL
          and param_err <= MESH_TINY_PARAM_ATOL
          and mesh_launches_ok(res, launches))
    check(ok, "tiny sharded training")
    emit({"phase": "train_tiny_mesh", "dryrun_multigpu_4_mesh":
              mesh_shape_for(4), "dryrun_attention_impl": "ring",
          "dryrun_pp_mesh": {"stage": 2, "data": 2},
          "dryrun_ep_mesh": {"expert": 2, "data": 2}, "dryrun_loss": dry,
          "dryrun_s": dry_s, "mesh": {"data": 2}, "backend": "gloo",
          "ranks_s": ranks_s, "losses": [r["losses"] for r in res],
          "tp1_losses": losses, "loss_max_rel_err": loss_rel,
          "loss_rtol": MESH_TINY_LOSS_RTOL, "grad_max_abs_err": grad_err,
          "grad_atol": MESH_TINY_GRAD_ATOL, "param_max_abs_err": param_err,
          "param_atol": MESH_TINY_PARAM_ATOL, "grad_floor":
              MESH_TINY_GRAD_FLOOR, "elements_below_floor": outside,
          "param_max_abs_err_all": param_err_all,
          "worst_element": {"param": worst, "tp1_step1_grad_abs":
                            worst_grad},
          "rank_launches": [r["launches"] for r in res],
          "launches_expected": launches, "ok": ok})


def train_8b_mesh_phase(dev, name, shape, impl="flash", layers=MESH_8B_LAYERS,
                        num_experts=0, grads_of=MESH_GRADS,
                        grad_rtol=MESH_8B_GRAD_RTOL):
    """Training at the Llama-3-8B widths cut to ``layers`` layers (bf16
    compute over f32 parameters, remat, AdamW at lr 3e-4, train_8b's batch
    of 2 x 2048 seeded ids, seed 0; ``num_experts`` > 0: the switch-routed
    MoE Llama) over ``shape`` with attention ``impl``, its ranks sharing
    this card over gloo, against TP 1 of the same config at the same depth
    run first in this process: each step's loss (MESH_8B_LOSS_TOL; for the
    MoE Llama also MOE_LOSS_NOISE times the distance of the same steps
    with plain attention on one device), and the first step's gradient of
    ``grads_of``'s rank slices by relative Frobenius error (``grad_rtol``).
    Each rank's launches are exact: under "flash" K1 2 a layer and step
    (remat), K2 and K3 1 each; under "ring" (a "seq" axis: ring attention,
    plain PyTorch as in the reference) none, and TP 1 runs plain attention.
    Each rank's peak memory (held, and reserved against its share of the
    card), step seconds and experts are recorded (gloo through host
    memory: no sharded-training speed)."""
    from ray_tpu_torch.entry import train_on_ranks
    from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from ray_tpu_torch.parallel.launch import card_shares
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step

    B, S, lr, steps, seed = 2, 2048, 3e-4, 3, 0
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=layers,
                              attention_impl=impl, num_experts=num_experts)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))

    def one_device(cfg, grads_of):
        model = LlamaModel(cfg, device=dev, param_dtype=torch.float32)
        opt = adamw(model.parameters(), lr)
        batch = torch.from_numpy(ids).to(dev)
        state = init_train_state(model, opt, batch, device=dev,
                                 generator=torch.Generator(
                                     device=dev).manual_seed(seed))
        step = make_train_step(model, opt)
        params = dict(model.named_parameters())
        torch.cuda.reset_peak_memory_stats()
        losses, step_s = [], []
        for i in range(steps):
            t = time.perf_counter()
            losses.append(step(state, batch, batch)[1].item())
            step_s.append(time.perf_counter() - t)
            if i == 0:
                grads = {n: params[n].grad.float().cpu() for n in grads_of}
        peak = torch.cuda.max_memory_allocated() / GB
        del model, opt, state, step, params
        gc.collect()
        torch.cuda.empty_cache()
        return losses, step_s, grads, peak

    losses, tp1_s, grads, tp1_peak = one_device(cfg, grads_of)
    loss_tol = [MESH_8B_LOSS_TOL] * steps
    plain = None
    if num_experts:
        plain = one_device(dataclasses.replace(cfg,
                                               attention_impl="reference"),
                           ())[0]
        loss_tol = [max(MESH_8B_LOSS_TOL, MOE_LOSS_NOISE * abs(a - b))
                    for a, b in zip(plain, losses)]
    free, total = torch.cuda.mem_get_info(dev)
    card_used = (total - free) / GB  # this process's and any other's
    main_reserved = torch.cuda.memory_reserved(dev) / GB
    share = next(iter(card_shares([dev] * math.prod(shape.values()))
                      .values()))
    t0 = time.perf_counter()
    res = train_on_ranks(shape, cfg, ids, steps, lr, device=dev, seed=seed,
                         grads_of=grads_of)
    ranks_s = time.perf_counter() - t0
    loss_errs = [max(abs(r["losses"][i] - losses[i]) for r in res)
                 for i in range(steps)]
    grad_err = {}
    for r in res:
        for n in grads_of:
            want = grads[n][r["index"][n]]
            got = torch.from_numpy(r["grads"][n])
            grad_err[f"rank{r['rank']}:{n}"] = (
                torch.linalg.norm(got - want) / torch.linalg.norm(want)).item()
    L = cfg.num_layers
    per = int(impl == "flash")
    launches = {"flash_fwd": 2 * L * steps * per,
                "flash_bwd_dq": L * steps * per,
                "flash_bwd_dkv": L * steps * per}
    finite = all(math.isfinite(x) for r in res for x in r["losses"])
    ok = (finite and all(e <= t for e, t in zip(loss_errs, loss_tol))
          and max(grad_err.values()) <= grad_rtol
          and mesh_launches_ok(res, launches))
    check(ok, name)
    row = {"phase": name, "mesh": shape, "attention_impl": impl,
           "backend": "gloo", "layers": L,
           "of_layers": 32, "dtype": "bfloat16", "param_dtype": "float32",
           "remat": cfg.remat, "batch": B, "seq_len": S, "lr": lr,
           "rank_heads": [[r["heads"], r["kv_heads"]] for r in res],
           "experts": num_experts,
           "rank_experts": [r["experts"] for r in res],
           "tp1_losses": losses, "losses": [r["losses"] for r in res],
           "loss_max_abs_err": max(loss_errs), "loss_abs_err": loss_errs,
           "loss_tol": loss_tol, "tp1_plain_attention_losses": plain,
           "grad_rel_frobenius_err": grad_err,
           "grad_rtol": grad_rtol, "tp1_peak_gb": tp1_peak,
           "card_used_gb_before_ranks": card_used,
           "card_total_gb": total / GB,
           "rank_card_share_gb": share * total / GB,
           "main_reserved_gb_before_ranks": main_reserved,
           "tp1_step_s": tp1_s,
           "rank_peak_gb": [r.get("peak_gb") for r in res],
           "rank_peak_reserved_gb": [r.get("peak_reserved_gb") for r in res],
           "rank_step_s_ranks_sharing_one_card_over_gloo":
               [r["step_s"] for r in res], "ranks_s": ranks_s,
           "rank_launches": [r["launches"] for r in res],
           "launches_expected": launches, "ok": ok}
    emit(row)
    return {"rank_launches": [r["launches"] for r in res],
            "local_heads": (res[0]["heads"], res[0]["kv_heads"]),
            "rank_batch": B // (shape.get("data", 1) * shape.get("fsdp", 1)),
            "kernels": impl == "flash"}


# Ring attention (parallel/ring.py) and the pipeline (parallel/pipeline.py),
# each rank a process on this card over gloo, against one device.
# Ring, bf16 causal at the 8B attention widths (global [1, 4096, 32/8,
# 128]): both sides compute in f32 from the same bf16 inputs and round the
# output to bf16 once, so they differ by the order of f32 sums and one bf16
# ulp of |out| (< 2^-8 for |out| < 1): the output is held at RING_BF16_ATOL
# (max abs). The q/k/v gradients of out.float().sum() are f32 sums of
# products of bf16-rounded outputs' cotangents: held by relative Frobenius
# error at RING_BF16_GRAD_RTOL. One f32 full case ([2, 512, 8/2, 64], TF32
# off) is held at the CPU tests' limits: 2e-5 for the output, 5e-4 for the
# gradients (allclose atol = rtol).
RING_BF16 = {"b": 1, "s": 4096, "h": 32, "hk": 8, "d": 128,
             "dtype": torch.bfloat16, "seed": 40}
RING_F32 = {"b": 2, "s": 512, "h": 8, "hk": 2, "d": 64,
            "dtype": torch.float32, "seed": 41}
RING_BF16_ATOL = 2e-2
RING_BF16_GRAD_RTOL = 5e-2
RING_F32_TOL = 2e-5
RING_F32_GRAD_TOL = 5e-4
# Pipeline: tanh(x @ w + b) at h 4096 in f32 (TF32 off), M 8 microbatches
# of [2, 512]; the output against the sequential composition on one device
# within PIPE_TOL (allclose atol = rtol), each stage's w gradient within
# PIPE_GRAD_RTOL relative Frobenius.
PIPE = {"M": 8, "mb": (2, 512), "h": 4096}
PIPE_TOL = 1e-5
PIPE_GRAD_RTOL = 1e-4
PARALLEL_REPS = 3


def rel_fro(got, want):
    """||got - want|| / ||want||, Frobenius, in f32."""
    got, want = got.float(), want.float()
    return (torch.linalg.norm(got - want) / torch.linalg.norm(want)).item()


def assemble(results, key, shape):
    """The global array from every rank's block of ``key`` (at ``index``,
    or at ``kv_index`` for dk and dv)."""
    full = torch.zeros(shape, dtype=torch.float32)
    at = "kv_index" if key in ("dk", "dv") else "index"
    for r in results:
        full[r[at]] = torch.from_numpy(r[key])
    return full


def ring_reference(spec, causal, dev):
    """attention_reference on the card on ring_inputs(**spec): its output
    and the q/k/v gradients of out.float().sum(), on the host."""
    from ray_tpu_torch.entry import ring_inputs
    from ray_tpu_torch.ops.attention import attention_reference

    qkv = [t.requires_grad_() for t in ring_inputs(**spec, device=dev)]
    out = attention_reference(*qkv, causal=causal)
    out.float().sum().backward()
    return [out.detach().float().cpu()] + [t.grad.float().cpu()
                                           for t in qkv]


def pipeline_reference(S, dev):
    """The sequential composition of S tanh stages on pipeline_inputs (seed
    S) on the card: its output and ws/bs/xs gradients of its sum, on the
    host, and its forward's ms."""
    from ray_tpu_torch.entry import pipeline_inputs, tanh_stage

    ws, bs, xs = [t.requires_grad_() for t in pipeline_inputs(
        S, PIPE["M"], PIPE["mb"], PIPE["h"], S, dev)]

    def fwd():
        y = xs
        for s in range(S):
            y = tanh_stage((ws[s], bs[s]), y)
        return y

    y = fwd()
    y.sum().backward()
    with torch.no_grad():
        ms = cuda_ms(fwd, [()], iters=5, warmup=1)
    return ([y.detach().cpu()] + [t.grad.cpu() for t in (ws, bs, xs)], ms)


def parallel_checks_phase(dev, attn):
    """ring_check and pipeline_check. For n in 2 and 4, one job of n ranks
    on this card over gloo runs ring_attention at {"seq": n} (RING_BF16
    causal, RING_F32 full) and pipeline_apply at {"stage": n}; each is held
    against one device in this process (limits above). Every rank times
    its calls, all ranks together (PARALLEL_REPS each; ranks sharing one
    card over gloo: no SP or PP speed); K1 at the bf16 case's whole
    sequence, and the sequential composition, are timed beside them as
    yardsticks."""
    from ray_tpu_torch.entry import ring_inputs, train_job

    refs = {"bf16": ring_reference(RING_BF16, True, dev),
            "f32": ring_reference(RING_F32, False, dev)}
    q, k, v = ring_inputs(**RING_BF16, device=dev)
    k1_ms = cuda_ms(lambda q, k, v: attn.flash_fwd_kernel(q, k, v,
                                                          causal=True),
                    copies((q, k, v), nbytes(q, k, v) * 2))
    del q, k, v
    pipe = {S: pipeline_reference(S, dev) for S in (2, 4)}
    gc.collect()
    torch.cuda.empty_cache()
    for n in (2, 4):
        t0 = time.perf_counter()
        runs = [{"fn": "ring", "shape": {"seq": n}, "spec": RING_BF16,
                 "causal": True, "reps": PARALLEL_REPS},
                {"fn": "ring", "shape": {"seq": n}, "spec": RING_F32,
                 "causal": False, "reps": PARALLEL_REPS},
                {"fn": "pipeline", "shape": {"stage": n},
                 "spec": {"S": n, "seed": n, **PIPE},
                 "reps": PARALLEL_REPS}]
        at = time.time()
        res = train_job(runs, device=dev).results()
        job_s = time.perf_counter() - t0
        # Per rank: seconds from the job's start to its first run, each
        # run's seconds, and from its last run's end to the job's end.
        timeline = [{"start_s": r[0]["run_at"] - at,
                     "run_s": [x["run_s"] for x in r],
                     "after_s": at + job_s - r[-1]["run_at"]
                     - r[-1]["run_s"]} for r in res]
        for i, (case, spec, causal) in enumerate(
                (("bf16", RING_BF16, True), ("f32", RING_F32, False))):
            per = [r[i] for r in res]
            want = refs[case]
            shapes = [want[0].shape, want[0].shape, want[2].shape,
                      want[3].shape]
            got = [assemble(per, key, sh)
                   for key, sh in zip(("out", "dq", "dk", "dv"), shapes)]
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            out_err = (got[0] - want[0]).abs().max().item()
            if case == "bf16":
                grad = {f"d{x}": rel_fro(g, w)
                        for x, g, w in zip("qkv", got[1:], want[1:])}
                ok = (finite and out_err <= RING_BF16_ATOL
                      and max(grad.values()) <= RING_BF16_GRAD_RTOL)
                lims = {"atol": RING_BF16_ATOL,
                        "grad_rel_frobenius": grad,
                        "grad_rtol": RING_BF16_GRAD_RTOL}
            else:
                used = limit_used(got[0], want[0], RING_F32_TOL,
                                  RING_F32_TOL)
                grad = {f"d{x}": limit_used(g, w, RING_F32_GRAD_TOL,
                                            RING_F32_GRAD_TOL)
                        for x, g, w in zip("qkv", got[1:], want[1:])}
                ok = finite and used <= 1 and max(grad.values()) <= 1
                lims = {"atol": RING_F32_TOL, "rtol": RING_F32_TOL,
                        "limit_used": used, "grad_tol": RING_F32_GRAD_TOL,
                        "grad_limit_used": grad}
            check(ok, f"ring_check seq {n} {case}")
            row = {"phase": "ring_check", "mesh": {"seq": n},
                   "backend": "gloo", "case": case, "causal": causal,
                   "shape": [spec[x] for x in ("b", "s", "h", "hk", "d")],
                   "rank_block_seq": spec["s"] // n, "max_abs_err": out_err,
                   **lims,
                   "rank_fwd_ms_ranks_sharing_one_card_over_gloo":
                       [r["fwd_ms"] for r in per],
                   "rank_fwd_bwd_ms_ranks_sharing_one_card_over_gloo":
                       [r["fwd_bwd_ms"] for r in per], "job_s": job_s,
                   "job_timeline": timeline,
                   "ok": ok}
            if case == "bf16":
                row["k1_whole_sequence_ms_yardstick"] = k1_ms
            emit(row)
        per = [r[2] for r in res]
        want, seq_ms = pipe[n]
        used = max(limit_used(torch.from_numpy(r["out"]), want[0], PIPE_TOL,
                              PIPE_TOL) for r in per)
        dw = {f"stage{r['stage']}": rel_fro(torch.from_numpy(r["dw"]),
                                            want[1][r["stage"]])
              for r in per}
        db = {f"stage{r['stage']}": rel_fro(torch.from_numpy(r["db"]),
                                            want[2][r["stage"]])
              for r in per}
        dx = rel_fro(torch.from_numpy(per[0]["dx"]), want[3])
        finite = all(bool(np.isfinite(r["out"]).all()) for r in per)
        ok = finite and used <= 1 and max(dw.values()) <= PIPE_GRAD_RTOL
        check(ok, f"pipeline_check stage {n}")
        emit({"phase": "pipeline_check", "mesh": {"stage": n},
              "backend": "gloo", "stage_fn": "tanh(x @ w + b)",
              "dtype": "float32", "microbatches": PIPE["M"],
              "microbatch": list(PIPE["mb"]), "h": PIPE["h"],
              "atol": PIPE_TOL, "rtol": PIPE_TOL, "limit_used": used,
              "dw_rel_frobenius": dw, "dw_rtol": PIPE_GRAD_RTOL,
              "db_rel_frobenius": db, "dx_rel_frobenius": dx,
              "rank_fwd_ms_ranks_sharing_one_card_over_gloo":
                  [r["fwd_ms"] for r in per],
              "sequential_fwd_ms_yardstick": seq_ms, "ok": ok})


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# RLlib's online algorithms (ray_tpu_torch/rllib). No Pallas kernel lies on
# the reference's RL path: its device work is small dense and conv layers,
# Adam and elementwise losses. So the port's runs on cuBLAS and cuDNN and
# launches none of K1-K4: each RL phase zeroes their counts before it runs
# and requires them to be 0 after.

# rllib_learner_check: each learner's loss and gradients on the card
# against the same learner on the CPU from the same weights, batch,
# permutation and noise, f32 with TF32 off. Only the order of sums differs
# (cuBLAS/cuDNN against the CPU's), so every gradient (and the loss) is
# held to 1e-4 relative Frobenius; limit_used = worst / RL_GRAD_RTOL.
RL_GRAD_RTOL = 1e-4
RL_ACTIONS = 4


def rl_learner_inputs():
    """Numpy inputs of every learner case, drawn from one seed: PPO
    minibatches (flat obs 8, and 84x84x1 pixels with the reference's conv
    widths 16/32/32 and PPO's dense 64, 64) under a fixed permutation, an
    IMPALA/APPO rollout [32, 8], DQN transitions, SAC transitions at
    PointGoal's widths (obs 4, action 2) with its two noise draws."""
    rng = np.random.default_rng(40)
    A = RL_ACTIONS

    def ppo(shape, n):
        perm = rng.permutation(n)
        mb = {"obs": rng.random((n,) + shape, np.float32),
              "actions": rng.integers(0, A, n).astype(np.int32),
              "logp": (np.log(1 / A) + 0.3 * rng.standard_normal(n)
                       ).astype(np.float32),
              "advantages": rng.standard_normal(n).astype(np.float32),
              "returns": rng.standard_normal(n).astype(np.float32)}
        return {k: v[perm] for k, v in mb.items()}

    T, N = 32, 8
    rollout = {"obs": rng.standard_normal((T, N, 8)).astype(np.float32),
               "actions": rng.integers(0, A, (T, N)).astype(np.int32),
               "logp": (np.log(1 / A) + 0.3 * rng.standard_normal((T, N))
                        ).astype(np.float32),
               "rewards": rng.standard_normal((T, N)).astype(np.float32),
               "dones": (rng.random((T, N)) < 0.1).astype(np.float32),
               "last_values": rng.standard_normal(N).astype(np.float32)}

    def transitions(n, d, act):
        return {"obs": rng.standard_normal((n, d)).astype(np.float32),
                "actions": act,
                "rewards": rng.standard_normal(n).astype(np.float32),
                "next_obs": rng.standard_normal((n, d)).astype(np.float32),
                "dones": (rng.random(n) < 0.1).astype(np.float32)}

    return {"ppo_mlp": ppo((8,), 256), "ppo_conv84": ppo((84, 84, 1), 256),
            "rollout": rollout,
            "dqn": transitions(128, 8, rng.integers(0, A, 128).astype(
                np.int32)),
            "sac": transitions(128, 4, rng.uniform(-1, 1, (128, 2)).astype(
                np.float32)),
            "sac_noise": rng.standard_normal((2, 128, 2)).astype(np.float32)}


def rl_learner_grads(inputs, device):
    """{case: (loss, {name: gradient on the host})} of every learner on
    ``device``, each from the weights its seed draws on the host."""
    from ray_tpu_torch.rllib import appo, dqn, impala, learner, sac
    from ray_tpu_torch.rllib.rl_module import RLModule, to_tensor

    def tensors(d):
        return {k: to_tensor(v, device, v.dtype) for k, v in d.items()}

    def grads(loss, params):
        gs = torch.autograd.grad(loss, list(params.values()))
        return loss.item(), {k: g.detach().cpu()
                             for k, g in zip(params, gs)}

    out = {}
    for case, obs_dim in (("ppo_mlp", 8), ("ppo_conv84", (84, 84, 1))):
        lr = learner.PPOLearner(RLModule(obs_dim, RL_ACTIONS, (64, 64),
                                         device=device),
                                learner.PPOLearnerConfig(), seed=1)
        out[case] = grads(lr.loss(lr.params, tensors(inputs[case]))[0],
                          lr.params)
    batch = impala.rollout_batch(inputs["rollout"], device)
    lr = impala.IMPALALearner(RLModule(8, RL_ACTIONS, device=device),
                              impala.IMPALALearnerConfig(), seed=1)
    out["impala"] = grads(lr.loss(lr.params, batch)[0], lr.params)
    lr = appo.APPOLearner(RLModule(8, RL_ACTIONS, device=device),
                          appo.APPOLearnerConfig(), seed=1)
    lr.target_params = lr.module.init_params(2)  # a target apart: KL > 0
    out["appo"] = grads(lr.loss(lr.params, batch)[0], lr.params)
    lr = dqn.DQNLearner(dqn.DQNModule(8, RL_ACTIONS, device=device),
                        dqn.DQNLearnerConfig(), seed=1)
    out["dqn"] = grads(lr.loss(lr.params, lr.module.init_params(2),
                               tensors(inputs["dqn"])), lr.params)
    lr = sac.SACLearner(sac.SACModule(4, 2, device=device),
                        sac.SACLearnerConfig(), seed=1)
    mb = tensors(inputs["sac"])
    eps_q, eps_pi = (to_tensor(e, device) for e in inputs["sac_noise"])
    st = lr.state
    out["sac_q"] = grads(lr.q_loss(st["q"], mb, eps_q), st["q"])
    pl, logp = lr.pi_loss(st["policy"], mb, eps_pi)
    out["sac_pi"] = grads(pl, st["policy"])
    out["sac_alpha"] = grads(lr.alpha_loss(st["log_alpha"], logp.detach()),
                             {"log_alpha": st["log_alpha"]})
    return out


def rl_learner_check_phase(dev, wrappers):
    inputs = rl_learner_inputs()
    zero_counts(wrappers)
    card = rl_learner_grads(inputs, dev)
    host = rl_learner_grads(inputs, torch.device("cpu"))
    cases, worst = {}, 0.0
    for case, (loss, grads) in card.items():
        ref_loss, ref = host[case]
        errs = {k: (torch.linalg.norm(g - ref[k])
                    / torch.linalg.norm(ref[k]).clamp_min(1e-30)).item()
                for k, g in grads.items()}
        loss_rel = abs(loss - ref_loss) / max(abs(ref_loss), 1e-30)
        worst = max(worst, loss_rel, *errs.values())
        cases[case] = {"loss": loss, "cpu_loss": ref_loss,
                       "loss_rel_err": loss_rel,
                       "grad_max_rel_fro": max(errs.values()),
                       "worst_grad": max(errs, key=errs.get),
                       "grads": len(errs)}
    launches = read_counts(wrappers)
    ok = (worst <= RL_GRAD_RTOL and not any(launches.values())
          and all(math.isfinite(c["loss"]) for c in cases.values()))
    check(ok, "rllib learners card vs cpu")
    emit({"phase": "rllib_learner_check", "cases": cases,
          "rtol": RL_GRAD_RTOL, "limit_used": worst / RL_GRAD_RTOL,
          "launches": launches, "ok": ok})
    return launches


def rl_ppo_pixels_phase(dev, wrappers):
    """The reference's pixel learning config
    (tests/test_rllib_sac_pixels.py:66-92: 8 envs of the 84x84 gridworld,
    rollout 24, lr 1e-3, 4 epochs, minibatch 64, 12 iterations; late > early
    + 0.1), then a throughput reading at 64 envs x 128 steps, minibatch 256:
    one warm iteration and three measured."""
    from ray_tpu_torch.rllib import PPOConfig
    from ray_tpu_torch.rllib.examples.pixel_gridworld import (
        PixelGridWorldBatch,
    )

    def build(num_envs, rollout, minibatch):
        return (PPOConfig()
                .environment(env_fn=lambda: PixelGridWorldBatch(
                    num_envs=num_envs, size=5, wall_density=0.1,
                    max_steps=24, res=84, seed=11))
                .env_runners(num_env_runners=1,
                             num_envs_per_env_runner=num_envs,
                             rollout_fragment_length=rollout)
                .training(lr=1e-3, num_epochs=4, minibatch_size=minibatch,
                          entropy_coeff=0.01)
                .debugging(seed=0)
                .build(device=dev))

    zero_counts(wrappers)
    t0 = time.perf_counter()
    algo = build(8, 24, 64)
    returns, losses = [], []
    for _ in range(12):
        r = algo.train()
        losses.append(r["loss"])
        if not math.isnan(r["episode_return_mean"]):
            returns.append(r["episode_return_mean"])
    learn_s = time.perf_counter() - t0
    early, late = ((float(np.mean(returns[:3])), float(np.mean(returns[-3:])))
                   if returns else (math.nan, math.nan))
    learned = late > early + 0.1
    algo = build(64, 128, 256)
    algo.train()  # warm: cuDNN's algorithm choice, the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    calls = algo.module.inference_calls
    rs = [algo.train() for _ in range(3)]
    steps = sum(r["env_steps_this_iter"] for r in rs)
    wall = sum(r["env_steps_this_iter"] / r["env_steps_per_s"] for r in rs)
    sample = [r["sample_time_s"] for r in rs]
    learn = [r["learn_time_s"] for r in rs]
    launches = read_counts(wrappers)
    ok = (learned and not any(launches.values())
          and all(math.isfinite(x) for x in losses + [r["loss"] for r in rs]))
    check(ok, "rllib PPO pixels")
    emit({"phase": "rllib_ppo_pixels", "obs": [84, 84, 1],
          "returns": returns, "early": early, "late": late,
          "learned": learned, "learning_s": learn_s,
          "throughput": {"envs": 64, "rollout": 128, "minibatch": 256,
                         "iterations": 3, "env_steps": steps,
                         "env_steps_per_s": steps / wall,
                         "sample_s": sample, "learn_s": learn,
                         "other_s": wall - sum(sample) - sum(learn),
                         "forward_inference_calls":
                             algo.module.inference_calls - calls,
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9},
          "launches": launches, "ok": ok})
    return launches


def rl_sac_point_goal_phase(dev, wrappers):
    """The reference's SAC learning config
    (tests/test_rllib_sac_pixels.py:40-63: 1 runner x 8 PointGoal envs,
    rollout 40, batch 128, 24 SGD steps an iteration, learn_start 300, lr
    5e-4, 25 iterations; best > first + 3.0)."""
    from ray_tpu_torch.rllib import SACConfig
    from ray_tpu_torch.rllib.examples.point_goal import PointGoalEnv

    zero_counts(wrappers)
    t0 = time.perf_counter()
    algo = (SACConfig()
            .environment(lambda: PointGoalEnv())
            .env_runners(num_env_runners=1, num_envs_per_env_runner=8,
                         rollout_fragment_length=40)
            .training(batch_size=128, sgd_steps_per_iter=24,
                      learn_start=300, lr=5e-4)
            .debugging(seed=0)
            .build(device=dev))
    returns, sgd, finite = [], 0, True
    for _ in range(25):
        r = algo.train()
        sgd += r["sgd_steps"]
        if r["sgd_steps"]:
            finite &= math.isfinite(r["q_loss"] + r["pi_loss"] + r["alpha"])
        if not math.isnan(r["episode_return_mean"]):
            returns.append(r["episode_return_mean"])
    first = returns[0] if returns else math.nan
    best = max(returns) if returns else math.nan
    launches = read_counts(wrappers)
    ok = (best > first + 3.0 and finite and not any(launches.values())
          and r["env_steps_total"] == 25 * 40 * 8)
    check(ok, "rllib SAC point goal")
    emit({"phase": "rllib_sac_point_goal", "returns": returns,
          "first": first, "best": best, "sgd_steps": sgd,
          "env_steps": r["env_steps_total"], "alpha": r["alpha"],
          "seconds": time.perf_counter() - t0, "launches": launches,
          "ok": ok})
    return launches


def gridworld_env():
    """The example GridWorldEnv with the observation_space (8,) that the
    algorithms read (the card's machine has no gymnasium CartPole)."""
    from types import SimpleNamespace

    from ray_tpu_torch.rllib.examples.gridworld import GridWorldEnv

    env = GridWorldEnv()
    env.observation_space = SimpleNamespace(shape=(env.obs_dim,))
    return env


RL_GRID_ITERS = 10


def rl_gridworld_phase(dev, wrappers):
    """IMPALA, APPO and DQN, RL_GRID_ITERS iterations each on the example
    gridworld (2 runners x 4 envs, their default rollouts): finite losses,
    one rollout consumed an IMPALA/APPO iteration, the step counts, APPO's
    first KL, DQN's epsilon. Returns are reported; no learning limit."""
    from ray_tpu_torch.rllib import APPOConfig, DQNConfig, IMPALAConfig

    zero_counts(wrappers)
    runs, ok = {}, True
    for name, config in (("impala", IMPALAConfig()), ("appo", APPOConfig()),
                         ("dqn", DQNConfig())):
        t0 = time.perf_counter()
        algo = config.environment(env_fn=gridworld_env).debugging(
            seed=0).build(device=dev)
        kls = []
        if name == "appo":
            update = algo.learner.update

            def recorded(rollout, update=update):
                out = update(rollout)
                kls.append(out["kl"])
                return out

            algo.learner.update = recorded
        rs = [algo.train() for _ in range(RL_GRID_ITERS)]
        cfg = algo.config
        per_iter = (cfg.rollout_length * cfg.num_envs_per_runner
                    * (cfg.num_env_runners if name == "dqn" else 1))
        steps_ok = all(r["env_steps_this_iter"] == per_iter for r in rs)
        if name == "dqn":
            learned = [r for r in rs if r["sgd_steps"]]
            e0, e1 = cfg.epsilon
            frac = min(1.0, RL_GRID_ITERS * per_iter
                       / cfg.epsilon_anneal_steps)
            run_ok = (steps_ok and learned
                      and all(math.isfinite(r["loss"]) for r in learned)
                      and abs(rs[-1]["epsilon"] - (e0 + (e1 - e0) * frac))
                      < 1e-9)
        else:
            run_ok = (steps_ok
                      and all(r["rollouts_consumed"] == 1
                              and math.isfinite(r["loss"]) for r in rs)
                      and (name == "impala" or kls[0] < 1e-4))
        ok &= bool(run_ok)
        runs[name] = {"losses": [r["loss"] for r in rs],
                      "returns": [r["episode_return_mean"] for r in rs],
                      "env_steps_per_s": [r["env_steps_per_s"] for r in rs],
                      "seconds": time.perf_counter() - t0, "ok": bool(run_ok)}
        if name == "appo":
            runs[name]["kl"] = kls
        if name == "dqn":
            runs[name]["epsilon"] = [r["epsilon"] for r in rs]
            runs[name]["sgd_steps"] = sum(r["sgd_steps"] for r in rs)
    launches = read_counts(wrappers)
    ok = ok and not any(launches.values())
    check(ok, "rllib gridworld")
    emit({"phase": "rllib_gridworld", "iterations": RL_GRID_ITERS,
          "runs": runs, "launches": launches, "ok": ok})
    return launches


# ---------------------------------------------------------------------------
# Multi-agent RLlib (rllib/multi_agent.py): two competing PPO policies on
# the chase gridworld. Like the single-agent phases, no Pallas kernel lies on
# the reference's path (two 32-wide MLPs), so the phase launches none of
# K1-K4.

CHASE_ITERS = 35
CHASE_MARGIN = 0.3


def chase_vs_random(module, weights, agent, n_episodes=100, seed=9999):
    """The reference test's evaluation (tests/test_rllib_multi_agent.py:
    54-76): the trained policy plays ``agent`` against a random opponent;
    its mean episode reward. The policy draws from a torch generator and
    the opponent from numpy, both seeded ``seed``."""
    from ray_tpu_torch.rllib.examples.chase import ChaseEnv

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=module.device).manual_seed(seed)
    env = ChaseEnv()
    total = 0.0
    for ep in range(n_episodes):
        obs = env.reset(seed=seed + ep)
        done = False
        while not done:
            a, _, _ = module[agent].forward_inference(
                weights[agent], np.asarray(obs[agent], np.float32)[None],
                gen)
            acts = {aid: int(rng.integers(0, 5)) for aid in env.agents}
            acts[agent] = int(a[0])
            obs, rews, dones = env.step(acts)
            total += rews[agent]
            done = dones["__all__"]
    return total / n_episodes


def rl_multi_agent_chase_phase(dev, wrappers):
    """The reference's learning test (tests/test_rllib_multi_agent.py:
    79-115): hidden (32, 32), lr 1e-3, entropy 0.003, minibatch 256, 2
    runners x 4 envs, rollout 64, seed 3, 35 iterations; then each trained
    policy plays 100 episodes against a random opponent and must beat
    random_baseline(150) by more than 0.3. env steps count agent steps (two
    an env step), as the reference's env_steps_this_iter does."""
    from ray_tpu_torch.rllib import MultiAgentPPOConfig, PPOLearnerConfig
    from ray_tpu_torch.rllib.examples.chase import (
        EVADER,
        PURSUER,
        ChaseEnv,
        random_baseline,
    )

    base = random_baseline(n_episodes=150)
    zero_counts(wrappers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    algo = (MultiAgentPPOConfig(
                hidden=(32, 32),
                learner=PPOLearnerConfig(lr=1e-3, entropy_coeff=0.003,
                                         minibatch_size=256),
                num_env_runners=2, num_envs_per_runner=4,
                rollout_length=64, seed=3)
            .environment(ChaseEnv)
            .multi_agent(
                policies={PURSUER: (ChaseEnv.obs_dim, ChaseEnv.num_actions),
                          EVADER: (ChaseEnv.obs_dim, ChaseEnv.num_actions)},
                policy_mapping_fn=lambda aid: aid)
            .build(device=dev))
    rs = [algo.train() for _ in range(CHASE_ITERS)]
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    calls = sum(m.inference_calls for _, m in algo.module.items())
    peak_gb = torch.cuda.max_memory_allocated() / GB
    weights = algo.get_weights()
    t1 = time.perf_counter()
    scores = {PURSUER: chase_vs_random(algo.module, weights, PURSUER),
              EVADER: chase_vs_random(algo.module, weights, EVADER)}
    eval_s = time.perf_counter() - t1
    margins = {PURSUER: scores[PURSUER] - base["pursuer_mean"],
               EVADER: scores[EVADER] - base["evader_mean"]}
    launches = read_counts(wrappers)
    steps = sum(r["env_steps_this_iter"] for r in rs)
    # a forward a module a timestep, and at most one a cut agent
    # (bootstrap) a sample
    per_sample = 64 * 2
    lo = CHASE_ITERS * 2 * per_sample
    hi = lo + CHASE_ITERS * 2 * 4 * 2
    losses = [v for r in rs for v in r["losses"].values()]
    ok = (all(m > CHASE_MARGIN for m in margins.values())
          and all(math.isfinite(v) for v in losses)
          and set(rs[-1]["losses"]) == {PURSUER, EVADER}
          and all(r["env_steps_this_iter"] == 2 * 2 * 4 * 64 for r in rs)
          and lo <= calls <= hi and not any(launches.values()))
    check(ok, "rllib multi-agent chase")
    emit({"phase": "rllib_multi_agent_chase", "iterations": CHASE_ITERS,
          "baseline": base, "scores": scores, "margins": margins,
          "margin_limit": CHASE_MARGIN,
          "reward_mean_last": rs[-1]["episode_reward_mean"],
          "losses_last": rs[-1]["losses"],
          "env_steps": steps, "env_steps_per_s": steps / train_s,
          "sample_s": sum(r["sample_time_s"] for r in rs),
          "learn_s": sum(r["learn_time_s"] for r in rs),
          "train_s": train_s, "eval_s": eval_s,
          "forward_inference_calls": calls,
          "forward_inference_range": [lo, hi], "peak_gb": peak_gb,
          "launches": launches, "ok": ok})
    return launches


# ---------------------------------------------------------------------------
# The ResNet family (models/resnet.py): resnet50ish (basic blocks
# (3, 4, 6, 3), width 64, 21.8 M parameters) at 224x224. The reference
# computes its convs, pooling and BatchNorm with XLA ops outside any Pallas
# kernel, so the port runs cuDNN and cuBLAS and launches none of K1-K4.

RESNET_SEED = 15
# resnet_check, card against CPU from the same weights: only the order of
# sums differs (cuDNN's algorithms against the CPU's). In f32 with TF32 off
# the training-mode logits are held to 1e-4 and the batch statistics to 1e-3
# (relative Frobenius). The gradients of one step at batch 2 are
# ill-conditioned in f32: BatchNorm over 2 x 7 x 7 positions in the last
# stage amplifies rounding, so the CPU's own f32 gradients differ by 2.2 %
# (global relative Frobenius) between 1 and 6 threads and lie 1.3-1.8 % from
# its f64 ones (tests/torch_parity_report.py resnet50_grad_noise). So the
# gradients and statistics are held to 1e-3 in float64 (card against CPU),
# and the card's f32 gradients must lie no farther from the CPU's f64 ones
# than RESNET_F32_FACTOR times the CPU's f32 gradients do.
RESNET_LOGIT_RTOL = 1e-4
RESNET_GRAD_RTOL = 1e-3
RESNET_F32_FACTOR = 2.0
# The reference's own bf16 logits against its f32 logits, relative
# Frobenius, training mode, resnet50ish at resnet_check's weights and
# inputs: measured once with JAX 0.9.0 on the CPU by
# `tests/torch_parity_report.py resnet50_bf16`. The card's bf16 logits must
# lie within RESNET_BF16_FACTOR times it of its own f32 logits.
RESNET_REF_BF16_DIST = 0.015786821908352365
RESNET_BF16_FACTOR = 2.0
RESNET_BATCH = 128
RESNET_WARM, RESNET_STEPS = 2, 5


def resnet_model(device, dtype=torch.bfloat16):
    """resnet50ish, 1000 classes, its weights drawn on the host from
    RESNET_SEED (the same on every device); a float64 model holds them in
    float64."""
    from ray_tpu_torch.models.resnet import ResNet

    model = ResNet(1000, (3, 4, 6, 3), 64, dtype, device=device)
    model.init_params(torch.Generator().manual_seed(RESNET_SEED))
    return model.double() if dtype == torch.float64 else model


def resnet_check_inputs():
    """resnet_check's batch: 2 seeded 224x224x3 images and labels."""
    rng = np.random.default_rng(52)
    return (rng.standard_normal((2, 224, 224, 3)).astype(np.float32),
            rng.integers(0, 1000, 2))


def resnet_flops(model, res):
    """Forward flop an image, summed from the conv and classifier shapes
    (2 * Cout * Cin * k^2 * Hout * Wout a conv, traced on the meta device,
    plus 2 * in * out)."""
    from ray_tpu_torch.models.resnet import ResNet, SameConv2d

    meta = ResNet(model.num_classes, model.stage_sizes, model.width,
                  model.dtype, device="meta")
    total = [2 * meta.classifier.in_features * meta.classifier.out_features]

    def hook(mod, inp, out):
        total[0] += (2 * out.shape[1] * mod.in_channels
                     * mod.kernel_size[0] * mod.kernel_size[1]
                     * out.shape[2] * out.shape[3])

    for mod in meta.modules():
        if isinstance(mod, SameConv2d):
            mod.register_forward_hook(hook)
    with torch.no_grad():
        meta(torch.empty(1, res, res, 3, device="meta"), train=False)
    return total[0]


def resnet_step_outputs(device, dtype, x, y):
    """Training-mode logits, batch statistics and the gradients of softmax
    cross-entropy, on the host (f32, or f64 for a float64 model)."""
    model = resnet_model(device, dtype)
    logits, stats = model(torch.from_numpy(x).to(device), train=True)
    F.cross_entropy(logits, torch.from_numpy(y).to(device)).backward()
    wide = torch.promote_types(dtype, torch.float32)
    host = lambda t: t.detach().to(wide).cpu()
    return (host(logits), {k: host(v) for k, v in stats.items()},
            {k: host(p.grad) for k, p in model.named_parameters()})


def resnet_check_phase(dev, wrappers):
    """resnet50ish at batch 2 x 224x224x3 on the card against the port on
    the CPU, from the same weights: f32 training-mode logits and batch
    statistics (TF32 off); gradients and statistics in float64; the card's
    f32 gradients against the float64 ones beside the CPU's; the card's bf16
    logits against its own f32 logits."""
    x, y = resnet_check_inputs()
    cpu = torch.device("cpu")
    zero_counts(wrappers)
    t0 = time.perf_counter()
    card = {dt: resnet_step_outputs(dev, dt, x, y)
            for dt in (torch.float32, torch.bfloat16, torch.float64)}
    launches = read_counts(wrappers)
    host = {dt: resnet_step_outputs(cpu, dt, x, y)
            for dt in (torch.float32, torch.float64)}
    f32, f64 = torch.float32, torch.float64

    def worst(a, b):
        errs = {k: rel_fro(v, b[k]) for k, v in a.items()}
        k = max(errs, key=errs.get)
        return errs[k], k

    flat = lambda grads: torch.cat([g.double().flatten()
                                    for g in grads.values()])
    logit_err = rel_fro(card[f32][0], host[f32][0])
    stat_err, stat_at = worst(card[f32][1], host[f32][1])
    stat64_err, stat64_at = worst(card[f64][1], host[f64][1])
    grad64_err, grad64_at = worst(card[f64][2], host[f64][2])
    grad32_err, grad32_at = worst(card[f32][2], host[f32][2])
    truth = flat(host[f64][2])
    card32_vs_64 = rel_fro(flat(card[f32][2]), truth)
    host32_vs_64 = rel_fro(flat(host[f32][2]), truth)
    bf16_dist = rel_fro(card[torch.bfloat16][0], card[f32][0])
    bf16_limit = RESNET_BF16_FACTOR * RESNET_REF_BF16_DIST
    finite = all(torch.isfinite(t).all() for out in card.values()
                 for t in (out[0], *out[2].values()))
    ok = (logit_err <= RESNET_LOGIT_RTOL and stat_err <= RESNET_GRAD_RTOL
          and stat64_err <= RESNET_GRAD_RTOL
          and grad64_err <= RESNET_GRAD_RTOL
          and card32_vs_64 <= RESNET_F32_FACTOR * host32_vs_64
          and bf16_dist <= bf16_limit and finite
          and card[f32][0].shape == (2, 1000) and not any(launches.values()))
    check(ok, "resnet card vs cpu")
    emit({"phase": "resnet_check", "batch": [2, 224, 224, 3],
          "logit_rel_fro": logit_err, "logit_rtol": RESNET_LOGIT_RTOL,
          "stat_max_rel_fro": stat_err, "worst_stat": stat_at,
          "f64_stat_max_rel_fro": stat64_err, "f64_worst_stat": stat64_at,
          "f64_grad_max_rel_fro": grad64_err, "f64_worst_grad": grad64_at,
          "grad_rtol": RESNET_GRAD_RTOL, "grads": len(card[f32][2]),
          "stats": len(card[f32][1]),
          "f32_grad_max_rel_fro_card_vs_cpu": grad32_err,
          "f32_worst_grad": grad32_at,
          "f32_grads_vs_f64": {"card": card32_vs_64, "cpu": host32_vs_64,
                               "factor": RESNET_F32_FACTOR},
          "bf16_vs_f32_rel_fro": bf16_dist, "bf16_limit": bf16_limit,
          "ref_bf16_vs_f32_rel_fro": RESNET_REF_BF16_DIST,
          "seconds": time.perf_counter() - t0, "launches": launches,
          "ok": ok})
    return launches


def resnet_train_phase(dev, wrappers):
    """resnet50ish, bf16, 1000 classes, on one seeded batch of 128 x
    224x224x3 with random labels: optax.sgd at lr 0.1 (the PBT
    trainable's, tests/test_resnet_pbt.py:53-74) as torch's plain SGD,
    softmax cross-entropy, the batch statistics written after each step.
    RESNET_WARM warm steps, then RESNET_STEPS measured (host clock around
    each step, ending in loss.item()). MFU = 3 x the forward flop (from the
    shapes) x batch / step time / 989 TFLOP/s."""
    model = resnet_model(dev)
    gen = torch.Generator(device=dev).manual_seed(RESNET_SEED)
    x = torch.randn(RESNET_BATCH, 224, 224, 3, generator=gen, device=dev)
    y = torch.randint(0, 1000, (RESNET_BATCH,), generator=gen, device=dev)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    stats0 = {k: v.clone() for k, v in model.named_buffers()}
    flops = 3 * resnet_flops(model, 224) * RESNET_BATCH
    zero_counts(wrappers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(RESNET_WARM + RESNET_STEPS):
        t0 = time.perf_counter()
        logits, stats = model(x, train=True)
        loss = F.cross_entropy(logits, y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        model.update_batch_stats(stats)
        losses.append(loss.item())
        times.append(time.perf_counter() - t0)
    launches = read_counts(wrappers)
    step_s = float(np.mean(times[RESNET_WARM:]))
    changed = min(float((v - stats0[k]).abs().max())
                  for k, v in model.named_buffers())
    ok = (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
          and changed > 0 and not any(launches.values()))
    check(ok, "resnet train")
    emit({"phase": "resnet_train", "batch": [RESNET_BATCH, 224, 224, 3],
          "dtype": "bfloat16", "losses": losses,
          "step_ms": [1e3 * t for t in times[RESNET_WARM:]],
          "warm_ms": [1e3 * t for t in times[:RESNET_WARM]],
          "step_ms_mean": 1e3 * step_s,
          "images_per_s": RESNET_BATCH / step_s,
          "gflop_per_image": flops / RESNET_BATCH / 1e9,
          "mfu": flops / step_s / PEAK_FLOPS[torch.bfloat16],
          "peak_gb": torch.cuda.max_memory_allocated() / GB,
          "min_stat_change": changed, "launches": launches, "ok": ok})
    return launches


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--versus", metavar="CHECKOUT",
                    help="also time K1-K4 of another checkout of the repo "
                         "(the parent commit's) against this tree's, "
                         "alternating")
    args = ap.parse_args()
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
    for b, causal in ((1, True), (2, True), (1, False)):
        k1_case(attn, f"8b_bf16_{'causal' if causal else 'full'}_b{b}", b,
                2048, 32, 8, 128, torch.bfloat16, causal, 0, dev)
    k1_case(attn, "main_shape_bf16_d64", 2, 2048, 32, 8, 64, torch.bfloat16,
            True, 16, dev)
    k1_case(attn, "small_f32_causal", 2, 256, 4, 2, 64, torch.float32, True,
            1, dev)
    k1_case(attn, "ragged_f32_full", 1, 200, 4, 1, 32, torch.float32, False,
            2, dev, time_it=False)
    k1_case(attn, "ragged_bf16_d64", 2, 200, 8, 2, 64, torch.bfloat16, True,
            3, dev, time_it=False)
    k1_case(attn, "ragged_bf16_d32", 1, 77, 4, 2, 32, torch.bfloat16, True,
            4, dev, time_it=False)
    # Sq != Skv: more keys than queries (full), and more queries than keys
    # (causal: the rows past Skv see every key).
    k1_case(attn, "sq200_skv333_bf16_full", 2, 200, 8, 2, 128,
            torch.bfloat16, False, 17, dev, time_it=False, skv=333)
    k1_case(attn, "sq333_skv200_bf16_causal", 2, 333, 8, 2, 128,
            torch.bfloat16, True, 18, dev, time_it=False, skv=200)

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

    # Head dims K1-K3 are not built for: zero-padded to 128.
    k1_case(attn, "ragged_bf16_d96", 2, 200, 8, 2, 96, torch.bfloat16, True,
            19, dev, time_it=False)
    k2k3_case(attn, "ragged_bf16_d96", 2, 200, 8, 2, 96, torch.bfloat16,
              True, 20, dev, time_it=False)

    # K4 against paged_decode_plain.
    lens = [1, 63, 64, 65, 130, 200, 511, 512]
    for dtype in (torch.bfloat16, torch.float32):
        k4_case(paged, f"8b_{str(dtype).split('.')[-1]}", dtype, lens, 5,
                dev)
    # Long contexts (Llama-3.1-8B's window allows 32,768), a GQA group of
    # 16, Gemma-2-9B's head widths (16 heads over 8, D 256), D 64, and
    # empty rows in f32.
    k4_case(paged, "long_b8_4096", torch.bfloat16, [4096] * 8, 23, dev,
            MP=64)
    k4_case(paged, "long_b1_32768", torch.bfloat16, [32768], 24, dev,
            MP=512)
    k4_case(paged, "hg16", torch.bfloat16, [176] * 8, 25, dev, HK=2)
    k4_case(paged, "d256", torch.bfloat16, [176] * 8, 26, dev, H=16, D=256)
    k4_case(paged, "d64", torch.bfloat16, [176] * 8, 27, dev, D=64)
    k4_case(paged, "f32_empty", torch.float32,
            [0, 1, 176, 0, 65, 512, 300, 0], 28, dev, time_it=False)
    k4_splits_phase(paged, dev, (
        ("main_path_decode", [176] * 8, {}, (1, 2, 4, 8)),
        ("long_b1_32768", [32768], {"MP": 512}, (1, 4, 8, 11, 16, 32))))

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
    quant_check_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    int8 = serve_8b_int8_phase(dev, wrappers, serving["summary"])
    gc.collect()
    torch.cuda.empty_cache()
    moe_check_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    moe = serve_moe_phase(dev, wrappers)
    gc.collect()
    torch.cuda.empty_cache()
    openai = serve_openai_phase(dev, wrappers, serving["summary"])
    gc.collect()
    torch.cuda.empty_cache()
    batch = batch_8b_phase(dev, wrappers)
    gc.collect()
    torch.cuda.empty_cache()
    tp_tiny_phase(dev)
    tp = serve_8b_tp2_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    moe_mesh = serve_moe_mesh_phase(dev, moe)
    gc.collect()
    torch.cuda.empty_cache()
    train_tiny_mesh_phase(dev)
    meshes = {"train_8b_tp2": ({"tensor": 2}, "flash"),
              "train_8b_fsdp2_tp2": ({"fsdp": 2, "tensor": 2}, "flash"),
              "train_8b_sp2_tp2": ({"seq": 2, "tensor": 2}, "ring")}
    sharded = {}
    for name, (shape, impl) in meshes.items():
        sharded[name] = train_8b_mesh_phase(dev, name, shape, impl)
        gc.collect()
        torch.cuda.empty_cache()
    sharded["train_moe_8b_ep2_tp2"] = train_8b_mesh_phase(
        dev, "train_moe_8b_ep2_tp2", {"expert": 2, "tensor": 2}, "flash",
        layers=MOE_8B_LAYERS, num_experts=MOE_8B_EXPERTS, grads_of=MOE_GRADS,
        grad_rtol=MOE_8B_GRAD_RTOL)
    gc.collect()
    torch.cuda.empty_cache()
    parallel_checks_phase(dev, attn)
    gc.collect()
    torch.cuda.empty_cache()
    rl = {"rllib_learner_check": rl_learner_check_phase(dev, wrappers),
          "rllib_ppo_pixels": rl_ppo_pixels_phase(dev, wrappers),
          "rllib_sac_point_goal": rl_sac_point_goal_phase(dev, wrappers),
          "rllib_gridworld": rl_gridworld_phase(dev, wrappers),
          "rllib_multi_agent_chase": rl_multi_agent_chase_phase(dev,
                                                                wrappers)}
    gc.collect()
    torch.cuda.empty_cache()
    resnet = {"resnet_check": resnet_check_phase(dev, wrappers)}
    gc.collect()
    torch.cuda.empty_cache()
    resnet["resnet_train"] = resnet_train_phase(dev, wrappers)
    gc.collect()
    torch.cuda.empty_cache()
    # The int8 and MoE serving paths give K1 and K4 serve_8b's shapes (the
    # same heads, batch, prompt and answer), so the main-path checks below
    # cover them.
    check(int8["forward_shape"] == moe["forward_shape"]
          == openai["forward_shape"] == serving["forward_shape"],
          "serving paths' shapes")
    # MoE served over the mesh gives K1 and K4 the shapes of serve_8b_tp2's
    # ranks ({"tensor": 2}: 16 / 4 heads) and of serve_8b ({"expert": 2}:
    # every head), which the checks below hold.
    check(moe_mesh["tensor2"]["forward_shape"] == tp["forward_shape"]
          and moe_mesh["tensor2"]["heads"] == (16, 4)
          and moe_mesh["expert2"]["forward_shape"]
          == serving["forward_shape"]
          and moe_mesh["expert2"]["heads"] == (32, 8),
          "MoE mesh serving shapes")

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
    # The batch stage's ragged rows: its teacher forward and its last
    # decode step.
    k1_case(attn, "batch_path_forward", *batch["forward_shape"], 32, 8, 128,
            torch.bfloat16, True, 21, dev)
    k4_case(paged, "batch_path_decode", torch.bfloat16,
            batch["decode_seq_lens"], 22, dev)
    # Each TP rank's local heads (16 over 4 at 8B, TP 2): its teacher
    # forward and its last decode step.
    k1_case(attn, "tp2_path_forward", *tp["forward_shape"], 16, 4, 128,
            torch.bfloat16, True, 29, dev)
    k4_case(paged, "tp2_path_decode", torch.bfloat16,
            [tp["decode_seq_len"]] * 8, 30, dev, H=16, HK=4)
    # Each sharded-training rank's local heads and rows (16 over 4 at TP
    # 2; 2 rows at TP 2, 1 under FSDP 2): its forward, remat recompute and
    # backward. Ring attention (train_8b_sp2_tp2) launches none of K1-K3.
    for i, (name, r) in enumerate((n, r) for n, r in sharded.items()
                                  if r["kernels"]):
        h, hk = r["local_heads"]
        k1_case(attn, f"{name}_path_forward", r["rank_batch"], 2048, h, hk,
                128, torch.bfloat16, True, 31 + 2 * i, dev, time_it=i == 0)
        k2k3_case(attn, f"{name}_path_backward", r["rank_batch"], 2048, h,
                  hk, 128, torch.bfloat16, True, 32 + 2 * i, dev,
                  time_it=i == 0)
    if args.versus:
        versus_phase(attn, paged, args.versus,
                     (("main_path_train", 2, 2048, True),
                      ("main_path_forward", b, s, False)),
                     (("main_path_decode", [serving["decode_seq_len"]] * 8,
                       {}),
                      ("long_b1_32768", [32768], {"MP": 512})), dev)
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

    by_path = {n: {"train_8b": training[n], "serve_8b": serving[n],
                   "serve_8b_int8": int8[n], "serve_moe": moe[n],
                   "serve_openai": openai[n], "batch_8b": batch[n],
                   "serve_8b_tp2_per_rank": [c.get(n, 0) for c in
                                             tp["rank_launches"]],
                   **{f"serve_moe_mesh_{label}_per_rank":
                      [c.get(n, 0) for c in r["rank_launches"]]
                      for label, r in moe_mesh.items()},
                   **{f"{name}_per_rank": [c.get(n, 0) for c in
                                           r["rank_launches"]]
                      for name, r in sharded.items()},
                   **{name: c[n] for name, c in {**rl, **resnet}.items()}}
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
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        print(f"chip_smoke: raised after phase {start.get('phase')} at "
              f"{time.perf_counter() - start['t']:.1f} s", file=sys.stderr)
        sys.exit(1)
