"""Prints the CPU parity table of the PyTorch port (PERF.md): for each port
module, the max abs error against its JAX counterpart on the same numpy
inputs, beside the tolerance its test holds it to.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_parity_report.py

The inputs are those of tests/test_torch_*.py; the Pallas kernels run in
interpret mode on the CPU.
"""

import dataclasses
import math
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from ray_tpu.llm._internal import engine as jeng  # noqa: E402
from ray_tpu.llm._internal import paged as jpaged  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu.ops import attention as jattn  # noqa: E402
from ray_tpu.train import step as jstep  # noqa: E402
from ray_tpu_torch.llm._internal import engine as teng  # noqa: E402
from ray_tpu_torch.llm._internal import paged as tpaged  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.models.convert import convert_params  # noqa: E402
from ray_tpu_torch.ops import attention as tattn  # noqa: E402
from ray_tpu_torch.train import step as tstep  # noqa: E402


def err(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def main():
    rows = []
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 128, 4, 32), dtype=np.float32)
    k = rng.standard_normal((2, 128, 2, 32), dtype=np.float32)
    v = rng.standard_normal((2, 128, 2, 32), dtype=np.float32)
    t = torch.from_numpy

    jk, jv = jattn._gqa_expand(jnp.asarray(k), jnp.asarray(v), 4)
    tr = lambda x: x.transpose(0, 2, 1, 3)
    out_j, lse_j = jattn._flash_fwd_core(
        tr(jnp.asarray(q)), tr(jk), tr(jv),
        (True, 1 / math.sqrt(32), 64, 64, True))
    out_t, lse_t = tattn.flash_attention_fwd_plain(t(q), t(k), t(v), True)
    rows.append(("ops/attention.py `flash_attention_fwd_plain` (out)",
                 "`_flash_kernel` (interpret)",
                 err(out_t, np.asarray(out_j).transpose(0, 2, 1, 3)), 2e-5))
    rows.append(("ops/attention.py `flash_attention_fwd_plain` (LSE)",
                 "`_flash_kernel` (interpret)",
                 err(lse_t, np.asarray(lse_j)[..., 0]), 2e-5))
    ref = jattn.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True)
    rows.append(("ops/attention.py `attention_reference`",
                 "`attention_reference`",
                 err(tattn.attention_reference(t(q), t(k), t(v)), ref),
                 2e-5))

    # Gradients: jax.grad through flash_attention runs the Pallas K2 and K3
    # in interpret mode; the port's FlashAttention runs the plain backward.
    w = rng.standard_normal(q.shape, dtype=np.float32)
    gj = jax.grad(lambda q, k, v: (jattn.flash_attention(
        q, k, v, block_q=64, block_k=64, interpret=True) * w).sum(),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    (tattn.flash_attention(tq, tk, tv) * t(w)).sum().backward()
    for name, g_t, g_j, kern in (("dq", tq.grad, gj[0], "_flash_dq_kernel"),
                                 ("dk", tk.grad, gj[1], "_flash_dkv_kernel"),
                                 ("dv", tv.grad, gj[2], "_flash_dkv_kernel")):
        rows.append((f"ops/attention.py `flash_attention_bwd_plain` ({name})",
                     f"`{kern}` (interpret)", err(g_t, g_j), 5e-4))

    B, H, HK, D, PS, MP, P = 3, 8, 2, 64, 8, 4, 16
    dq = rng.standard_normal((B, 1, H, D), dtype=np.float32)
    kp = rng.standard_normal((HK, P, PS, D), dtype=np.float32)
    vp = rng.standard_normal((HK, P, PS, D), dtype=np.float32)
    pt = (rng.permutation(P - 1)[:B * MP].reshape(B, MP)
          % (P - 1)).astype(np.int32)
    lens = np.array([5, 17, 31], np.int32)
    jout = jpaged.paged_attention_decode_kernel(
        *map(jnp.asarray, (dq, kp, vp, pt, lens)), interpret=True)
    rows.append(("llm/_internal/paged.py `paged_decode_plain`",
                 "`_paged_decode_kernel` (interpret)",
                 err(tpaged.paged_decode_plain(*map(t, (dq, kp, vp, pt,
                                                        lens))), jout),
                 2e-5))
    # bf16: both round P to bf16 before P·V (identical bits at MP 4).
    bf = jpaged.paged_attention_decode_kernel(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (dq, kp, vp)),
        jnp.asarray(pt), jnp.asarray(lens), interpret=True)
    rows.append(("llm/_internal/paged.py `paged_decode_plain` (bf16)",
                 "`_paged_decode_kernel` (interpret, bf16)",
                 err(tpaged.paged_decode_plain(
                     *(t(a).to(torch.bfloat16) for a in (dq, kp, vp)),
                     t(pt), t(lens)).float(), bf.astype(jnp.float32)), 0.0))
    qpos = (lens - 1)[:, None]
    jg = jpaged.paged_attention(*map(jnp.asarray, (dq, kp, vp, pt, qpos,
                                                   lens)), use_kernel=False)
    rows.append(("llm/_internal/paged.py `paged_attention` (gather)",
                 "`paged_attention` (gather)",
                 err(tpaged.paged_attention(*map(t, (dq, kp, vp, pt, qpos,
                                                     lens))), jg), 2e-5))

    jcfg = jllama.LlamaConfig.tiny(vocab_size=128)
    jparams = jllama.LlamaModel(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    sd = convert_params(jax.tree.map(np.asarray, jparams))
    ids = np.random.default_rng(0).integers(0, 128, (2, 24), dtype=np.int32)
    for impl in ("reference", "flash"):
        jm = jllama.LlamaModel(dataclasses.replace(jcfg, attention_impl=impl))
        tm = tllama.LlamaModel(dataclasses.replace(
            tllama.LlamaConfig.tiny(vocab_size=128), attention_impl=impl),
            device="cpu")
        tllama.load_params(tm, sd)
        with torch.no_grad():
            got = tm(t(ids))
        rows.append((f"models/llama.py logits ({impl})",
                     "`LlamaModel.apply`",
                     err(got, jm.apply({"params": jparams}, jnp.asarray(ids))),
                     1e-4))

    # Three AdamW steps of the tiny f32 train step from the same weights.
    ids = np.random.default_rng(0).integers(0, 512, (2, 32), dtype=np.int32)
    for impl in ("reference", "flash"):
        jcfg_t = dataclasses.replace(jllama.LlamaConfig.tiny(),
                                     attention_impl=impl)
        jm = jllama.LlamaModel(jcfg_t)
        opt = optax.adamw(1e-3)
        jstate = jstep.init_train_state(jm, opt, jnp.asarray(ids))
        tm = tllama.LlamaModel(dataclasses.replace(
            tllama.LlamaConfig.tiny(), attention_impl=impl), device="cpu",
            param_dtype=torch.float32)
        tllama.load_params(tm, convert_params(
            jax.tree.map(np.asarray, jstate.params)))
        topt = tstep.adamw(tm.parameters(), 1e-3)
        tstate = tstep.init_train_state(tm, topt, t(ids), device="cpu")
        jfn = jstep.make_train_step(jm, opt, donate=False)
        tfn = tstep.make_train_step(tm, topt)
        for _ in range(3):
            jstate, jloss = jfn(jstate, jnp.asarray(ids), jnp.asarray(ids))
            tstate, tloss = tfn(tstate, t(ids).long(), t(ids).long())
        rows.append((f"train/step.py loss after 3 steps ({impl}), relative",
                     "`make_train_step` + optax.adamw",
                     abs(tloss.item() - float(jloss)) / abs(float(jloss)),
                     1e-5))
        jsd = convert_params(jax.tree.map(np.asarray, jstate.params))
        rows.append((f"train/step.py weights after 3 steps ({impl})",
                     "`make_train_step` + optax.adamw",
                     max(err(p.detach(), jsd[n])
                         for n, p in tm.named_parameters()), 1e-4))

    prompts = {"a": [1, 2, 3], "b": [9, 8, 7, 6, 5], "c": [100, 3],
               "d": [11, 22, 33, 44]}
    kw = dict(max_seqs=2, page_size=4, max_pages_per_seq=16)
    je = jeng.LLMEngine(jllama.LlamaModel(jcfg), jparams,
                        jeng.EngineConfig(**kw))
    te = teng.LLMEngine(tllama.LlamaModel(tllama.LlamaConfig.tiny(
        vocab_size=128), device="cpu"), sd, teng.EngineConfig(**kw),
        device="cpu")
    outs = []
    for eng, mod in ((je, jeng), (te, teng)):
        for rid, p in prompts.items():
            eng.add_request(mod.Request(rid, p, max_tokens=6))
        got = {}
        while eng.has_work():
            for so in eng.step():
                got.setdefault(so.request_id, []).append(so.token)
        outs.append(got)
    differ = sum(a != b for r in prompts
                 for a, b in zip(outs[0][r], outs[1][r]))
    rows.append(("llm/_internal/engine.py greedy tokens (4 requests × 6)",
                 "`LLMEngine`", float(differ), 0.0))

    print("| Port module | JAX counterpart | max abs error | tolerance |")
    print("|---|---|---|---|")
    for name, ref_name, e, tol in rows:
        print(f"| {name} | {ref_name} | {e:.3g} | {tol:g} |")


if __name__ == "__main__":
    main()
