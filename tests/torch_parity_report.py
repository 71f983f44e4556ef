"""Prints the CPU parity table of the PyTorch port (PERF.md): for each port
module, the max abs error against its JAX counterpart on the same numpy
inputs, beside the tolerance its test holds it to.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_parity_report.py \
        [multi_agent] [resnet] [offline] [checkpoint]

The inputs are those of tests/test_torch_*.py; the Pallas kernels run in
interpret mode on the CPU. Naming sections prints only their rows;
``resnet50_bf16`` alone prints the reference's bf16-against-f32 logit
distance that chip_smoke.py's resnet_check is held to, and
``resnet50_grad_noise`` how far the f32 gradients of that check move with
the order of sums.
"""

import dataclasses
import math
import os
import pickle

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# The 8 virtual CPU devices of tests/conftest.py, for the reference's TP.
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           + os.environ.get("XLA_FLAGS", ""))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from ray_tpu.llm._internal import engine as jeng  # noqa: E402
from ray_tpu.llm._internal import paged as jpaged  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu.models import moe as jmoe  # noqa: E402
from ray_tpu.models import quant as jquant  # noqa: E402
from ray_tpu.ops import attention as jattn  # noqa: E402
from ray_tpu.train import step as jstep  # noqa: E402
from ray_tpu_torch.llm._internal import engine as teng  # noqa: E402
from ray_tpu_torch.llm._internal import paged as tpaged  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.models import moe as tmoe  # noqa: E402
from ray_tpu_torch.models import quant as tquant  # noqa: E402
from ray_tpu_torch.models.convert import convert_params  # noqa: E402
from ray_tpu_torch.ops import attention as tattn  # noqa: E402
from ray_tpu_torch.train import step as tstep  # noqa: E402


def err(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def f32(a):
    """numpy or torch (bf16 included) -> float64 numpy."""
    if torch.is_tensor(a):
        return a.double().numpy()
    return np.asarray(a).astype(np.float64)


def tree_err(port, ref):
    """Max abs error over a port state dict and a converted reference one
    (quantized leaves compared field by field)."""
    e = 0.0
    for name, r in ref.items():
        pairs = ([(port[name][f], r[f]) for f in ("__q__", "s")]
                 if isinstance(r, dict) else [(port[name], r)])
        e = max([e] + [float(np.abs(f32(a) - f32(b)).max())
                       for a, b in pairs])
    return e


def greedy_differ(je, te, requests, jmod=jeng, tmod=teng):
    """Greedy tokens that differ between a JAX and a port engine."""
    outs = []
    for eng, mod in ((je, jmod), (te, tmod)):
        for rid, p in requests.items():
            eng.add_request(mod.Request(rid, p, max_tokens=6))
        got = {}
        while eng.has_work():
            for so in eng.step():
                got.setdefault(so.request_id, []).append(so.token)
        outs.append(got)
    return float(sum(a != b for r in requests
                     for a, b in zip(outs[0][r], outs[1][r])))


def quant_moe_rows(rows, jparams, sd):
    """models/quant.py and models/moe.py (tests/test_torch_quant.py and
    tests/test_torch_moe.py's inputs)."""
    t = torch.from_numpy
    tcfg = tllama.LlamaConfig.tiny(vocab_size=128)
    jq = jquant.quantize_tree(jparams, min_size=64)
    tq = tquant.quantize_tree(sd, tcfg, min_size=64, device="cpu")
    conv = lambda tree: convert_params(jax.tree.map(np.asarray, tree))
    rows.append(("models/quant.py `quantize_tree` (int8 and scales)",
                 "`quantize_tree`", tree_err(tq, conv(jq)), 0.0))
    for dt in ("float32", "bfloat16"):
        rows.append((f"models/quant.py `dequantize_tree` ({dt})",
                     "`dequantize_tree`",
                     tree_err(tquant.dequantize_tree(tq, getattr(torch, dt)),
                              conv(jquant.dequantize_tree(
                                  jq, getattr(jnp, dt)))), 0.0))
    jcfg12 = dataclasses.replace(jllama.LlamaConfig.tiny(vocab_size=128),
                                 num_layers=12)
    shape = jax.eval_shape(lambda: jllama.LlamaModel(jcfg12).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    rows.append(("models/quant.py `random_quantized_like` (12 layers)",
                 "`random_quantized_like`",
                 tree_err(tquant.random_quantized_like(
                     dataclasses.replace(tcfg, num_layers=12),
                     device="cpu"),
                          conv(jquant.random_quantized_like(shape))), 0.0))
    kw = dict(max_seqs=2, page_size=4, max_pages_per_seq=16, decode_steps=1)
    requests = {"a": [5, 17, 42, 7], "b": [1, 2, 3],
                "c": list(range(9, 30))}
    je = jeng.LLMEngine(jllama.LlamaModel(jllama.LlamaConfig.tiny(
        vocab_size=128)), jq, jeng.EngineConfig(**kw),
        param_transform=jquant.dequantize_tree)
    te = teng.LLMEngine(tllama.LlamaModel(tcfg, device="meta"), tq,
                        teng.EngineConfig(**kw),
                        param_transform=tquant.dequantize_tree, device="cpu")
    rows.append(("llm/_internal/engine.py int8 greedy tokens that differ "
                 "(3 requests × 6)", "`LLMEngine` + `dequantize_tree`",
                 greedy_differ(je, te, requests), 0.0))

    x = np.random.default_rng(0).standard_normal((2, 32, 32)).astype(
        np.float32)
    for cf in (4.0, 0.25):
        jl = jmoe.MoEMlp(32, 64, 4, capacity_factor=cf, dtype=jnp.float32)
        p = jl.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
        npp = jax.tree.map(np.asarray, p)
        tl = tmoe.MoEMlp(32, 64, 4, capacity_factor=cf, dtype=torch.float32,
                         device="cpu")
        tllama.load_params(tl, {"router.weight": npp["router"]["kernel"].T,
                                **{k: npp[k] for k in ("gate_kernel",
                                                       "up_kernel",
                                                       "down_kernel")}})
        with torch.no_grad():
            got = tl(t(x))
        rows.append((f"models/moe.py `MoEMlp` (capacity factor {cf:g}"
                     f"{', drops' if cf < 1 else ''})", "`MoEMlp`",
                     err(got, jl.apply({"params": p}, jnp.asarray(x))),
                     2e-5))
    rows.append(("models/moe.py `moe_reference`", "`moe_reference`",
                 err(tmoe.moe_reference(t(x), npp, 4),
                     jmoe.moe_reference(jnp.asarray(x), p, 4)), 2e-5))
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(vocab_size=128),
                               num_experts=4)
    mcfg = dataclasses.replace(tcfg, num_experts=4)
    jm = jllama.LlamaModel(jcfg)
    mp = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))[
        "params"]
    tm = tllama.LlamaModel(mcfg, device="cpu")
    tllama.load_params(tm, conv(mp))
    ids = np.random.default_rng(0).integers(0, 128, (2, 24), dtype=np.int32)
    with torch.no_grad():
        got = tm(t(ids))
    rows.append(("models/llama.py MoE logits (4 experts)",
                 "`LlamaModel.apply`",
                 err(got, jm.apply({"params": mp}, jnp.asarray(ids))), 1e-4))
    je = jeng.LLMEngine(jm, mp, jeng.EngineConfig(**kw))
    te = teng.LLMEngine(tm, conv(mp), teng.EngineConfig(**kw), device="cpu")
    rows.append(("llm/_internal/engine.py MoE greedy tokens that differ "
                 "(2 requests × 6, prefill drops)", "`LLMEngine`",
                 greedy_differ(je, te, {"a": list(range(40, 66)),
                                        "b": [5, 17, 42, 7]}), 0.0))


def text_surface_rows(rows):
    """tokenizer.py, openai.py and batch.py (tests/test_torch_openai.py and
    tests/test_torch_batch.py's inputs and helpers)."""
    import tempfile

    import test_torch_batch as tb
    import test_torch_openai as to
    from ray_tpu.llm._internal import batch as jbatch
    from ray_tpu.llm._internal import openai as jopenai
    from ray_tpu.llm._internal import tokenizer as jtok
    from ray_tpu_torch.llm import OpenAIServer, ProcessorConfig
    from ray_tpu_torch.llm._internal import batch as tbatch
    from ray_tpu_torch.llm._internal import tokenizer as ttok

    d = tempfile.mkdtemp()
    tok_path = os.path.join(d, "tok.json")
    jtok.ByteBPETokenizer.train(to.CORPUS, vocab_size=300).save(tok_path)
    jr, tr = jtok.ByteBPETokenizer.load(tok_path), ttok.ByteBPETokenizer.load(
        tok_path)
    strings = [s for seed in range(3) for s in to._strings(seed)]
    differ = sum(tr.encode(s) != jr.encode(s)
                 or tr.decode(tr.encode(s), skip_specials=False)
                 != jr.decode(jr.encode(s), skip_specials=False)
                 for s in strings)
    differ += ttok.ByteBPETokenizer.train(to.CORPUS, 300).merges != jr.merges
    rows.append((f"llm/_internal/tokenizer.py merges, encode/decode of "
                 f"{len(strings)} strings that differ", "`ByteBPETokenizer`",
                 float(differ), 0.0))

    model = jllama.LlamaModel(jllama.LlamaConfig.tiny(vocab_size=512))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    params_path = os.path.join(d, "params.pkl")
    with open(params_path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)
    cfg = {"model": "tiny", "model_id": to.MODEL_ID,
           "model_config": {"vocab_size": 512}, "params_path": params_path,
           "tokenizer_path": tok_path,
           "engine_config": {"max_seqs": 2, "page_size": 4,
                             "max_pages_per_seq": 16, "decode_steps": 1}}
    servers = (jopenai.OpenAIServer(cfg), OpenAIServer(cfg, device="cpu"))
    requests = [
        ("/v1/models", None),
        ("/v1/completions", {"prompt": "the quick fox", "max_tokens": 12}),
        ("/v1/completions", {"prompt": to.PROMPT_IDS, "max_tokens": 12,
                             "stream": True}),
        ("/v1/chat/completions", {"messages": to.CHAT, "max_tokens": 12}),
        ("/v1/chat/completions", {"messages": to.CHAT, "max_tokens": 12,
                                  "stream": True}),
        ("/v1/completions", {"prompt": "x", "top_p": 0}),
        ("/v1/embeddings", {})]
    lp_requests = [
        ("/v1/completions", {"prompt": to.PROMPT_IDS, "max_tokens": 8,
                             "logprobs": 2}),
        ("/v1/chat/completions", {"messages": to.CHAT, "max_tokens": 8,
                                  "logprobs": True, "top_logprobs": 2})]
    differ = 0
    for suffix, body in requests:
        p, r = to._both(servers, suffix, body)
        differ += p != r
    lp_err = 0.0
    for suffix, body in lp_requests:
        p, r = to._both(servers, suffix, body)
        lp = (p["choices"][0]["logprobs"], r["choices"][0]["logprobs"])
        if "content" in lp[0]:
            vals = [[(e["logprob"], [t["logprob"] for t in e["top_logprobs"]])
                     for e in x["content"]] for x in lp]
            lp_err = max([lp_err] + [abs(a[0] - b[0]) for a, b in
                                     zip(*vals)] + [
                abs(u - v) for a, b in zip(*vals)
                for u, v in zip(a[1], b[1])])
        else:
            lp_err = max([lp_err] + [abs(a - b) for a, b in zip(
                lp[0]["token_logprobs"], lp[1]["token_logprobs"])])
        differ += to._strip(p)["choices"][0].keys() != to._strip(
            r)["choices"][0].keys()
    logits = np.round(np.random.default_rng(5).standard_normal((6, 512))
                      * 2).astype(np.float32)
    engine = servers[1].server.engine
    _, (_, _, ids) = engine._sample(
        torch.from_numpy(logits), torch.zeros(6), torch.ones(6),
        torch.zeros(6, dtype=torch.int32), [], False, True)
    _, jids = jax.lax.top_k(jax.nn.log_softmax(jnp.asarray(logits)),
                            engine.cfg.max_logprobs)
    rows.append(("llm/_internal/engine.py top logprob ids on tied logits "
                 "that differ (6 rows × 5)", "`jax.lax.top_k`",
                 float((ids.numpy() != np.asarray(jids)).sum()), 0.0))
    servers[1].server.shutdown()
    servers[0].server._running = False
    rows.append((f"llm/_internal/openai.py bodies and SSE streams that "
                 f"differ, without id and created ({len(requests)} "
                 "requests)", "`OpenAIServer`", float(differ), 0.0))
    rows.append(("llm/_internal/openai.py logprobs (completions logprobs 2, "
                 "chat top_logprobs 2)", "`OpenAIServer`", lp_err, 1e-4))

    bcfg = {**cfg, "engine_config": {"max_seqs": 3, "page_size": 4,
                                     "max_pages_per_seq": 16,
                                     "decode_steps": 1}}
    batch = {"prompt_ids": tb._column(tb._ragged(0)),
             "max_tokens": np.array([4, 9, 1, 6, 12])}
    got = tbatch._EngineStage(ProcessorConfig(llm_config=bcfg),
                              device="cpu")(dict(batch))
    want = jbatch._EngineStage(jbatch.ProcessorConfig(llm_config=bcfg))(
        dict(batch))
    differ = sum(int((a != b).sum()) if a.shape == b.shape else len(b)
                 for a, b in zip(got["generated_ids"], want["generated_ids"]))
    rows.append(("llm/_internal/batch.py generated ids that differ (5 "
                 "ragged rows, per-row max_tokens)", "`_EngineStage`",
                 float(differ), 0.0))


def parallel_rows(rows):
    """parallel/mesh.py, parallel/sharding.py and tensor-parallel serving
    (tests/test_torch_parallel.py and tests/test_torch_tp.py's inputs and
    helpers; TP starts gloo rank processes on the CPU)."""
    import tempfile

    import test_torch_parallel as tpar
    import test_torch_tp as ttp
    from ray_tpu.llm._internal.server import LLMServer as JaxServer
    from ray_tpu.parallel import mesh as jmesh
    from ray_tpu_torch.llm import LLMServer
    from ray_tpu_torch.parallel import mesh as tmesh

    differ = 0
    for shape, n in tpar.MESH_SHAPES:
        ref, port = tpar._meshes(shape, n)
        differ += tmesh.mesh_shape(port) != jmesh.mesh_shape(ref)
    for shape in tpar.MESH_ERRORS:
        msgs = []
        for make, devices in ((jmesh.create_mesh, jax.devices()),
                              (tmesh.create_mesh, [tpar.CPU] * 8)):
            try:
                make(shape, devices=devices)
                msgs.append(None)
            except ValueError as e:
                msgs.append(str(e))
        differ += msgs[0] is None or msgs[0] != msgs[1]
    rows.append((f"parallel/mesh.py `create_mesh` sizes and errors that "
                 f"differ ({len(tpar.MESH_SHAPES)} shapes, "
                 f"{len(tpar.MESH_ERRORS)} errors)", "`create_mesh`",
                 float(differ), 0.0))
    pairs = [p for m in tpar.SPEC_MESHES for r in tpar.RULES
             for p in tpar.spec_pairs(m, r)]
    rows.append((f"parallel/sharding.py `spec_for`, `_drop_indivisible` "
                 f"that differ ({len(pairs)} cases)",
                 "`spec_for`, `_drop_indivisible`",
                 float(sum(a != b for a, b in pairs)), 0.0))
    for n in (2, 4):
        e = max(tree_err(got, want)
                for want, got, _, _ in tpar.tiny_shards(n))
        rows.append((f"parallel/sharding.py `shard_state_dict`, tiny, every "
                     f"rank of TP {n}", "`addressable_shards` under "
                     "`LLAMA_SHARDING`, converted", e, 0.0))
    d = tempfile.mkdtemp()
    tempfile.tempdir = d
    path = ttp.write_params(os.path.join(d, "params.pkl"))
    ref = JaxServer(dict(ttp.TINY, params_path=path, tensor_parallel_size=4))
    ref_tokens = ttp._serve(ref)
    ref._running = False
    srv = LLMServer(dict(ttp.TINY, params_path=path), device="cpu")
    tokens_1 = ttp._serve(srv)
    with torch.no_grad():
        logits_1 = srv.model(ttp.IDS)
    srv.close()
    n_tok = sum(len(t) for t in tokens_1)
    for n in (2, 4):
        srv = LLMServer(dict(ttp.TINY, params_path=path,
                             tensor_parallel_size=n), device="cpu")
        tokens = ttp._serve(srv)
        logits = srv.engine.runner.forward(ttp.IDS)
        srv.close()
        differ = sum((a != b) + (a != c) for x, y, z in
                     zip(tokens, tokens_1, ref_tokens)
                     for a, b, c in zip(x, y, z))
        rows.append((f"llm/_internal/tp.py greedy tokens at TP {n} that "
                     f"differ from TP 1's and from the reference's TP 4 "
                     f"({n_tok} tokens each)",
                     "`LLMServer(tensor_parallel_size=4)`", float(differ),
                     0.0))
        rows.append((f"models/llama.py logits at TP {n} against TP 1",
                     "(the port at TP 1)", err(logits, logits_1), 1e-4))


def sharded_train_rows(rows):
    """tests/test_torch_train_sharded.py's runs: 3 steps on gloo CPU ranks
    at each mesh against the port's single-device step, and at {"fsdp": 2,
    "tensor": 2} against the reference's sharded step."""
    import test_torch_train_sharded as T
    from ray_tpu_torch.entry import full_params, train_job

    jparams, sd = T.reference_init()
    keys = [(s, "reference") for s in T.TWO] + [
        (T.FOUR, i) for i in T.IMPLS] + [(T.TP4, "reference")]
    results = {}
    for part in (keys[:3], keys[3:]):
        job = train_job([{"shape": s, "cfg": T._cfg(i, s), "ids": T._ids(),
                          "steps": T.STEPS, "lr": T.LR, "state_dict": sd,
                          "want_params": True} for s, i in part],
                        device="cpu")
        per_rank = job.results()
        for j, key in enumerate(part):
            results[repr(key[0]), key[1]] = [r[j] for r in per_rank]
    single = {i: T._single(i, sd) for i in T.IMPLS}
    jax_runs = {i: T._jax_sharded(i, jparams) for i in T.IMPLS}

    def row(what, ref_name, res, losses, params):
        loss = max(abs(a - b) / abs(b) for r in res
                   for a, b in zip(r["losses"], losses))
        got = full_params(res)
        rows.append((f"train/step.py sharded, {what}, loss after 3 steps, "
                     "relative", ref_name, loss, T.LOSS_RTOL))
        rows.append((f"train/step.py sharded, {what}, weights after 3 "
                     "steps", ref_name, max(err(got[n], params[n])
                                            for n in params),
                     T.PARAM_ATOL))

    for shape, impl in keys:
        row(f"{shape} ({impl}, gloo CPU ranks)", "(the port on one device)",
            results[repr(shape), impl], *single[impl])
    for impl in T.IMPLS:
        row(f"{T.FOUR} ({impl})", "`make_train_step(mesh=, param_rules="
            "LLAMA_SHARDING)`, 4 CPU devices",
            results[repr(T.FOUR), impl], *jax_runs[impl])


def ring_pipeline_rows(rows):
    """tests/test_torch_ring.py's and tests/test_torch_pipeline.py's runs:
    the blockwise update, ring attention at {"seq": 4} and 3 steps at
    {"seq": 2, "tensor": 2} on gloo CPU ranks, and the pipeline at S 2
    and 4, against the reference's."""
    import test_torch_pipeline as P
    import test_torch_ring as R
    from ray_tpu_torch.entry import full_params, train_job

    jparams, sd = R.weights()
    ring_runs = R.rank_runs(sd)
    per_rank = train_job(ring_runs + P.rank_runs(), device="cpu").results()
    ring_ref, step_ref = R.reference_runs(jparams)
    q0, k0, v0 = R._qkv(2, 64, 4, 4, 32, 7)
    _, k1, v1 = R._qkv(2, 64, 4, 4, 32, 8)
    s_ = q0.shape[1]
    tri = np.where(np.arange(s_)[None, :] <= np.arange(s_)[:, None], 0.0,
                   -1e30).astype(np.float32)
    block = 0.0
    for second in (None, np.full((s_, s_), -1e30, np.float32)):
        outs = []
        for mod, arr in ((tattn, torch.from_numpy), (jattn, jnp.asarray)):
            m, l, o = mod.block_attn_init(arr(q0))
            for k_, v_, msk in ((k0, v0, tri), (k1, v1, second)):
                m, l, o = mod.block_attn_update(
                    arr(q0), arr(k_), arr(v_), m, l, o, scale=0.17,
                    mask=None if msk is None else arr(msk))
            outs.append(f32(mod.block_attn_finish(l, o, arr(q0).dtype)))
        block = max(block, err(*outs))
    rows.append(("ops/attention.py `block_attn_init/update/finish` (the "
                 "diagonal block, then one unmasked or fully masked)",
                 "`block_attn_*`", block, R.OUT_TOL["atol"]))
    for i, (name, *_rest) in enumerate(R.RING_CASES):
        want = ring_ref[name]
        got = R.assemble(per_rank, i, want)
        rows.append((f"parallel/ring.py `ring_attention` at {{\"seq\": 4}}, "
                     f"{name} (out)", "`ring_attention`, 4 CPU devices",
                     err(got[0], want[0]), R.OUT_TOL["atol"]))
        rows.append((f"parallel/ring.py `ring_attention` at {{\"seq\": 4}}, "
                     f"{name} (dq, dk, dv)", "`jax.vjp` of it",
                     max(err(a, b) for a, b in zip(got[1:], want[1:])),
                     R.GRAD_TOL["atol"]))
    res = [r[len(R.RING_CASES)] for r in per_rank]
    got = full_params(res)
    for ref_name, (losses, params) in (
            ("(the port on one device)", R.single_device(sd)),
            ("`make_train_step(mesh=)`, ring, 4 CPU devices", step_ref)):
        rows.append(("train/step.py at {\"seq\": 2, \"tensor\": 2} (ring), "
                     "loss after 3 steps, relative", ref_name,
                     max(abs(a - b) / abs(b) for r in res
                         for a, b in zip(r["losses"], losses)),
                     R.LOSS_RTOL))
        rows.append(("train/step.py at {\"seq\": 2, \"tensor\": 2} (ring), "
                     "weights after 3 steps", ref_name,
                     max(err(got[n], params[n]) for n in params),
                     R.PARAM_ATOL))
    pipe_ref = P.reference_runs()
    out_err = grad_err = 0.0
    for j, (case, S) in enumerate(P.RUNS):
        _, dws, dbs, dxs = pipe_ref[j]
        for r in (pr[len(ring_runs) + j] for pr in per_rank):
            out_err = max(out_err, err(r["out"], pipe_ref[j][0]))
            grad_err = max(grad_err, err(r["dw"], dws[r["stage"]]),
                           err(r["db"], dbs[r["stage"]]))
            if r["stage"] == 0:
                grad_err = max(grad_err, err(r["dx"], dxs))
    rows.append(("parallel/pipeline.py `pipeline_apply` at S 2 and 4 "
                 "(test_pipeline.py's two cases), out",
                 "`pipeline_apply`", out_err,
                 P.TOL["atol"]))
    rows.append(("parallel/pipeline.py `pipeline_apply` gradients (dw, db, "
                 "dx), the same runs", "`jax.grad` of `pipeline_apply`",
                 grad_err,
                 P.TOL["atol"]))


def ep_rows(rows):
    """tests/test_torch_ep.py's runs: 3 steps on gloo CPU ranks at each of
    its meshes with an "expert" axis against the port's single-device step
    and, at {"expert": 2, "data": 2}, the reference's sharded step; the MoE
    engine's greedy tokens at {"tensor": 2} and {"expert": 2} against the
    port on one device and the reference's engine on the same mesh."""
    import test_torch_ep as E
    from ray_tpu.parallel.mesh import create_mesh as jcreate_mesh
    from ray_tpu_torch.entry import full_params, train_job
    from ray_tpu_torch.parallel.mesh import create_mesh

    jparams, sd = E.weights()
    per_rank = train_job(E.rank_runs(sd), device="cpu").results()
    single = E.single_device(sd)
    reference = E._jax_step(jparams)
    for i, shape in enumerate(E.MESHES):
        res = [r[i] for r in per_rank]
        got = full_params(res)
        refs = [("(the port on one device)", single)]
        if shape == E.EP_DP:
            refs.append(("`make_train_step(mesh=, param_rules="
                         "LLAMA_SHARDING)`, 4 CPU devices", reference))
        for ref_name, (losses, params) in refs:
            rows.append((f"train/step.py at {shape} (MoE, 4 experts), loss "
                         "after 3 steps, relative", ref_name,
                         max(abs(a - b) / abs(b) for r in res
                             for a, b in zip(r["losses"], losses)),
                         E.LOSS_RTOL))
            rows.append((f"train/step.py at {shape} (MoE, 4 experts), "
                         "weights after 3 steps", ref_name,
                         max(err(got[n], params[n]) for n in params),
                         E.PARAM_ATOL))
    jcfg, tcfg = E._cfgs()
    one = E.greedy(teng.LLMEngine(tllama.LlamaModel(tcfg, device="cpu"), sd,
                                  teng.EngineConfig(**E.ENGINE),
                                  device="cpu"), teng)
    for shape in E.SERVE:
        eng = teng.LLMEngine(tllama.LlamaModel(tcfg, device="meta"), sd,
                             teng.EngineConfig(**E.ENGINE),
                             mesh=create_mesh(shape, devices=[E.CPU] * 2))
        try:
            got = E.greedy(eng, teng)
        finally:
            eng.close()
        ref = E.greedy(jeng.LLMEngine(
            jllama.LlamaModel(jcfg), jparams, jeng.EngineConfig(**E.ENGINE),
            mesh=jcreate_mesh(shape, devices=jax.devices()[:2])), jeng)
        n = sum(len(t) for t in one.values())
        rows.append((f"llm/_internal/engine.py MoE greedy tokens at {shape} "
                     f"that differ from one device's and from the "
                     f"reference's at the same mesh ({n} tokens each)",
                     "`LLMEngine(mesh=)`",
                     float(sum((a != b) + (a != c) for k in one
                               for a, b, c in zip(got[k], one[k], ref[k]))),
                     0.0))


def rllib_rows(rows):
    """RLlib's online algorithms, on the inputs of
    tests/test_torch_rllib.py: forwards, V-trace, the tanh-Gaussian
    density, and the weights after each learner's update from the
    reference's converted initial weights."""
    from ray_tpu.rllib import appo as japo
    from ray_tpu.rllib import dqn as jdqn
    from ray_tpu.rllib import impala as jimp
    from ray_tpu.rllib import learner as jlearn
    from ray_tpu.rllib import rl_module as jrl
    from ray_tpu.rllib import sac as jsac
    from ray_tpu_torch.models.convert import convert_rl_params
    from ray_tpu_torch.rllib import appo as tapo
    from ray_tpu_torch.rllib import dqn as tdqn
    from ray_tpu_torch.rllib import impala as timp
    from ray_tpu_torch.rllib import learner as tlearn
    from ray_tpu_torch.rllib import rl_module as trl
    from ray_tpu_torch.rllib import sac as tsac

    def conv(tree):
        return convert_rl_params(jax.tree.map(np.asarray, tree))

    def w_err(port, ref_tree):
        ref = conv(ref_tree)
        return max(err(port[k].detach().numpy(), v) for k, v in ref.items())

    rng = np.random.default_rng(2)
    fwd = []
    for obs_dim in (6, (40, 40, 1), (84, 84, 1)):
        jm = jrl.RLModule(obs_dim, 4)
        tm = trl.RLModule(obs_dim, 4, device="cpu")
        params = jm.init_params(jax.random.PRNGKey(3))
        shape = (5,) + (obs_dim if isinstance(obs_dim, tuple)
                        else (obs_dim,))
        obs = rng.random(shape).astype(np.float32)
        jl, jv = jm.forward_train(params, jnp.asarray(obs))
        with torch.no_grad():
            tl, tv = tm.forward_train(
                {k: torch.from_numpy(v) for k, v in conv(params).items()},
                torch.from_numpy(obs))
        fwd.append(max(err(tl, jl), err(tv, jv)))
    rows.append(("rllib/rl_module.py `forward_train` logits and value: MLP "
                 "/ conv at res 40 / res 84",
                 "`RLModule.forward_train`",
                 max(fwd), 1e-4))
    T, N = 7, 3
    x = [rng.normal(size=s).astype(np.float32)
         for s in ((T, N), (N,), (T, N))]
    dones = (rng.random((T, N)) < 0.2).astype(np.float32)
    rhos = np.exp(rng.normal(scale=0.5, size=(T, N))).astype(np.float32)
    args = x + [dones, rhos]
    ref = jimp.vtrace_targets(*map(jnp.asarray, args), gamma=0.9)
    got = timp.vtrace_targets(*map(torch.from_numpy, args), gamma=0.9)
    mean = rng.normal(size=(64, 2)).astype(np.float32)
    log_std = rng.uniform(-5, 0.5, (64, 2)).astype(np.float32)
    pre = mean + np.exp(log_std) * rng.normal(size=(64, 2)).astype(
        np.float32)
    lp = (jsac._tanh_gaussian_logp(*map(jnp.asarray, (pre, mean, log_std))),
          tsac._tanh_gaussian_logp(*map(torch.from_numpy,
                                        (pre, mean, log_std))))
    rows.append(("rllib/impala.py `vtrace_targets` (vs, pg_adv); sac.py "
                 "`_tanh_gaussian_logp`",
                 "`vtrace_targets`; `_tanh_gaussian_logp`",
                 max(err(got[0], ref[0]), err(got[1], ref[1]),
                     err(lp[1], lp[0])), 2e-5))

    def ppo_update(obs_shape, epochs, b, dtype=torch.float32):
        """The reference's and the port's weights after one update (the
        port's learner in ``dtype``), from the reference's init."""
        cfg = jlearn.PPOLearnerConfig(num_epochs=epochs, minibatch_size=64,
                                      lr=1e-3)
        od = obs_shape if len(obs_shape) == 3 else obs_shape[0]
        jl = jlearn.PPOLearner(jrl.RLModule(od, 4), cfg, seed=0)
        tl = tlearn.PPOLearner(trl.RLModule(od, 4, device="cpu"), cfg,
                               seed=0)
        tl.params = {k: torch.from_numpy(v).to(dtype).requires_grad_()
                     for k, v in conv(jl.params).items()}
        tl.opt = tlearn.ClippedAdam(tl.params, cfg.lr, cfg.max_grad_norm)
        jl.update([b])
        tl.update([{k: v.astype(np.float64) if dtype == torch.float64
                    and v.dtype == np.float32 else v for k, v in b.items()}])
        return jl.params, tl.get_weights()

    ppo, batches = [], {}
    for obs_shape, epochs in (((6,), 2), ((40, 40, 1), 1), ((84, 84, 1), 1)):
        b = batches[obs_shape] = {
            "obs": rng.random((48,) + obs_shape).astype(np.float32),
            "actions": rng.integers(0, 4, 48).astype(np.int32),
            "logp": (np.log(0.25) + 0.3 * rng.normal(size=48)).astype(
                np.float32),
            "advantages": rng.normal(size=48).astype(np.float32),
            "returns": rng.normal(size=48).astype(np.float32)}
        ref, port = ppo_update(obs_shape, epochs, b)
        ppo.append(w_err(port, ref))
    rows.append(("rllib/learner.py `PPOLearner.update`, weights after "
                 "whole-batch epochs: MLP 2 / conv res 40 1 / res 84 1",
                 "`PPOLearner.update`", max(ppo), 1e-4))
    # Two epochs at res 84: Adam's second step amplifies f32 rounding
    # (ReLUs near 0 after the first step). The tolerance column holds the
    # port in f32 against the port in f64: the f32 noise floor.
    b = batches[(84, 84, 1)]
    ref, port = ppo_update((84, 84, 1), 2, b)
    _, port64 = ppo_update((84, 84, 1), 2, b, torch.float64)
    rows.append(("rllib/learner.py `PPOLearner.update`, conv res 84, 2 "
                 "epochs: the reference against the port (tolerance "
                 "column: the port in f32 against the port in f64)",
                 "`PPOLearner.update`", w_err(port, ref),
                 max(err(port[k].detach(), port64[k].detach())
                     for k in port)))

    def rollout(seed):
        r = np.random.default_rng(seed)
        return {"obs": r.normal(size=(8, 4, 4)).astype(np.float32),
                "actions": r.integers(0, 3, (8, 4)).astype(np.int32),
                "logp": (np.log(1 / 3) + 0.3 * r.normal(size=(8, 4))
                         ).astype(np.float32),
                "rewards": r.normal(size=(8, 4)).astype(np.float32),
                "dones": (r.random((8, 4)) < 0.15).astype(np.float32),
                "last_values": r.normal(size=4).astype(np.float32)}

    errs = []
    for jcls, tcls, cfg in (
            (jimp.IMPALALearner, timp.IMPALALearner,
             jimp.IMPALALearnerConfig(lr=1e-3)),
            (japo.APPOLearner, tapo.APPOLearner,
             japo.APPOLearnerConfig(lr=1e-2, target_update_freq=1))):
        jl = jcls(jrl.RLModule(4, 3), cfg, seed=0)
        tl = tcls(trl.RLModule(4, 3, device="cpu"), cfg, seed=0)
        tlearn.set_params_(tl.params, conv(jl.params))
        if hasattr(tl, "target_params"):
            tl.target_params = trl.clone_weights(tl.params)
        for i in range(2):
            jl.update(rollout(10 + i))
            tl.update(rollout(10 + i))
        errs.append(w_err(tl.get_weights(), jl.params))
    r = np.random.default_rng(0)
    mbs = [{"obs": r.normal(size=(32, 5)).astype(np.float32),
            "actions": r.integers(0, 3, 32).astype(np.int32),
            "rewards": (3 * r.normal(size=32)).astype(np.float32),
            "next_obs": r.normal(size=(32, 5)).astype(np.float32),
            "dones": (r.random(32) < 0.2).astype(np.float32)}
           for _ in range(5)]
    cfg = jdqn.DQNLearnerConfig(lr=1e-3, target_update_period=2)
    jl = jdqn.DQNLearner(jdqn.DQNModule(5, 3), cfg, seed=0)
    tl = tdqn.DQNLearner(tdqn.DQNModule(5, 3, device="cpu"), cfg, seed=0)
    tlearn.set_params_(tl.params, conv(jl.params))
    tl.target_params = trl.clone_weights(tl.params)
    jl.update(mbs)
    tl.update(mbs)
    errs.append(max(w_err(tl.get_weights(), jl.params),
                    w_err(tl.target_params, jl.target_params)))
    cfg = jsac.SACLearnerConfig(lr=1e-3, tau=0.1)
    jl = jsac.SACLearner(jsac.SACModule(4, 2), cfg, seed=0)
    tl = tsac.SACLearner(tsac.SACModule(4, 2, device="cpu"), cfg, seed=0)
    for part in ("policy", "q", "q_target"):
        tlearn.set_params_(tl.state[part], conv(jl.state[part]))
    mbs = [{"obs": r.normal(size=(32, 4)).astype(np.float32),
            "actions": r.uniform(-1, 1, (32, 2)).astype(np.float32),
            "rewards": r.normal(size=32).astype(np.float32),
            "next_obs": r.normal(size=(32, 4)).astype(np.float32),
            "dones": (r.random(32) < 0.2).astype(np.float32)}
           for _ in range(3)]
    key = jl._key
    for mb in mbs:
        key, sub = jax.random.split(key)
        eps = [torch.from_numpy(np.array(jax.random.normal(k, (32, 2))))
               for k in jax.random.split(sub)]
        tl.step({k: torch.from_numpy(v) for k, v in mb.items()}, *eps)
    jl.update(mbs)
    errs.append(max(max(w_err(tl.state[p], jl.state[p])
                        for p in ("policy", "q", "q_target")),
                    err(tl.state["log_alpha"].detach(),
                        jl.state["log_alpha"])))
    rows.append(("rllib/impala.py / appo.py (2 updates, target refreshed "
                 "after each) / dqn.py (5 double-DQN steps, 2 target "
                 "refreshes) / sac.py (3 steps on the reference's noise): "
                 "weights after the updates",
                 "`IMPALALearner` / `APPOLearner` / `DQNLearner` / "
                 "`SACLearner`",
                 max(errs), 1e-4))
    rows.append(("rllib/ copies: `compute_gae`, `ReplayBuffer`, "
                 "`SyncVectorEnv`, the example envs (elements that differ; "
                 "tests/test_torch_rllib.py)",
                 "the same modules", 0.0, 0.0))


def multi_agent_rows(rows):
    """rllib/multi_agent.py: the runner under the argmax policy
    (tests/test_torch_multi_agent.py's sample), and one whole-batch update a
    module on the GAE batches of the reference's sample."""
    from test_torch_multi_agent import HIDDEN, sample_both

    from ray_tpu.rllib import learner as jlearn
    from ray_tpu.rllib import rl_module as jrl
    from ray_tpu_torch.models.convert import convert_rl_params
    from ray_tpu_torch.rllib import learner as tlearn
    from ray_tpu_torch.rllib import multi_agent as tma
    from ray_tpu_torch.rllib import rl_module as trl

    both = sample_both()
    differ, e = 0, 0.0
    for js, ts, jrew, trew, _ in both.values():
        differ += int(jrew != trew)
        for mid in js:
            for a, b in zip(js[mid], ts[mid]):
                differ += sum(int((a[k] != b[k]).sum())
                              for k in ("obs", "actions", "rewards", "dones"))
                e = max(e, *(err(a[k], b[k])
                             for k in ("logp", "values", "last_values")))
    rows.append(("rllib/multi_agent.py `MultiAgentEnvRunner.sample(80)`, "
                 "2 envs, argmax policy (chase, turn-based): obs, actions, "
                 "rewards, dones and episode rewards that differ (PR 15)",
                 "`MultiAgentEnvRunner`", float(differ), 0.0))
    rows.append(("the same: logp, values, last_values (PR 15)",
                 "`MultiAgentEnvRunner`", e, 1e-5))
    js = both["chase"][0]
    cfg = dict(lr=1e-3, num_epochs=2, minibatch_size=512)
    e = 0.0
    for i, mid in enumerate(sorted(js)):
        batch = [tma.agent_gae(tr, 0.99, 0.95) for tr in js[mid]]
        merged = {k: np.concatenate([b[k] for b in batch]) for k in batch[0]}
        ref = jlearn.PPOLearner(jrl.RLModule(6, 5, HIDDEN),
                                jlearn.PPOLearnerConfig(**cfg), seed=3 + i)
        port = tlearn.PPOLearner(trl.RLModule(6, 5, HIDDEN, device="cpu"),
                                 tlearn.PPOLearnerConfig(**cfg), seed=3 + i)
        port.set_weights(convert_rl_params(jax.tree.map(np.asarray,
                                                        ref.params)))
        ref.update([merged])
        port.update([merged])
        e = max(e, tree_err(port.get_weights(), convert_rl_params(
            jax.tree.map(np.asarray, ref.params))))
    rows.append(("rllib/multi_agent.py one update a module (2 whole-batch "
                 "epochs) on the per-agent GAE batches: weights (PR 15)",
                 "`MultiAgentPPO.training_step`", e, 1e-4))


def resnet_rows(rows):
    """models/resnet.py against ray_tpu/models/resnet.py on
    tests/test_torch_resnet.py's seeded variables."""
    from test_torch_resnet import _pair, _rel

    from ray_tpu.models.resnet import ResNet as JResNet
    from ray_tpu_torch.models import resnet as tres
    from ray_tpu_torch.models.convert import convert_resnet_variables

    for res in (32, 16):
        rng = np.random.default_rng(res)
        x = rng.normal(size=(4, res, res, 3)).astype(np.float32)
        y = np.array([0, 3, 7, 9])
        jm = JResNet.tiny(10)
        v, tm = _pair(jm, tres.ResNet.tiny(10, device="cpu"), x)

        def loss_fn(params, v=v, x=x, y=y, jm=jm):
            logits, upd = jm.apply({"params": params,
                                    "batch_stats": v["batch_stats"]},
                                   jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
            return optax.softmax_cross_entropy(
                logits, jax.nn.one_hot(y, 10)).mean(), (logits, upd)

        (_, (jl, upd)), jg = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(v["params"])
        tl, ts = tm(torch.from_numpy(x), train=True)
        torch.nn.functional.cross_entropy(tl, torch.from_numpy(y)).backward()
        stats = convert_resnet_variables({}, jax.tree.map(
            np.asarray, upd["batch_stats"]))
        grads = convert_resnet_variables(jax.tree.map(np.asarray, jg), {})
        tm.update_batch_stats(ts)
        with torch.no_grad():
            te = tm(torch.from_numpy(x), train=False)
        je = jm.apply({"params": v["params"],
                       "batch_stats": upd["batch_stats"]}, jnp.asarray(x),
                      train=False)
        name = f"models/resnet.py `ResNet.tiny()` f32 at {res}x{res}"
        rows.append((f"{name}: training / eval logits (PR 15)",
                     "`ResNet.apply`", max(err(tl.detach(), jl),
                                           err(te, je)), 1e-4))
        rows.append((f"{name}: batch-stat updates (PR 15)",
                     "`ResNet.apply(mutable=[\"batch_stats\"])`",
                     max(err(ts[k], w) for k, w in stats.items()), 1e-5))
        rows.append((f"{name}: gradients (PR 15)", "`jax.grad`",
                     max(err(p.grad, grads[k])
                         for k, p in tm.named_parameters()), 5e-4))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    jm = JResNet(num_classes=10, stage_sizes=(1, 1), width=8)
    v, tm = _pair(jm, tres.ResNet(10, (1, 1), 8, device="cpu"), x, seed=2)
    with torch.no_grad():
        te = tm(torch.from_numpy(x), train=False)
    rows.append(("models/resnet.py bf16 tiny (1, 1) width 8, eval logits, "
                 "relative Frobenius (PR 15)", "`ResNet.apply`",
                 _rel(te.numpy(), jm.apply(v, jnp.asarray(x), train=False)),
                 2e-2))


def offline_rows(rows):
    """rllib/offline.py, bc.py and cql.py on tests/test_torch_offline.py's
    data and passes."""
    from test_torch_offline import record, two_blocks

    from ray_tpu.rllib import bc as jbc
    from ray_tpu.rllib import cql as jcql
    from ray_tpu.rllib import offline as joff
    from ray_tpu.rllib.examples import gridworld as jgrid
    from ray_tpu_torch.models.convert import convert_rl_params
    from ray_tpu_torch.rllib import bc as tbc
    from ray_tpu_torch.rllib import cql as tcql
    from ray_tpu_torch.rllib import offline as toff
    from ray_tpu_torch.rllib.examples import gridworld as tgrid
    from ray_tpu_torch.rllib.learner import set_params_
    from ray_tpu_torch.rllib.rl_module import clone_weights

    differ = 0
    blocks = {}
    for expert, kw in ((True, dict(n_episodes=150, seed=0, max_steps=48)),
                       (False, dict(n_episodes=20, seed=5, max_steps=48))):
        ref = record(jgrid, joff, expert, **kw)
        port = record(tgrid, toff, expert, **kw)
        differ += sum(int((ref[k] != port[k]).sum())
                      + int(ref[k].dtype != port[k].dtype) for k in ref)
        blocks.setdefault("expert", port)
    ds = two_blocks(blocks["expert"])
    for seed in (0, 1):
        for g, w in zip(toff.OfflineData(ds).iter_train_batches(
                batch_size=64, num_epochs=2, seed=seed),
                joff.OfflineData(ds).iter_train_batches(
                    batch_size=64, num_epochs=2, seed=seed)):
            differ += sum(int((g[k] != w[k]).sum()) for k in w)
    rows.append(("rllib/offline.py `record_episodes` (expert fixture, 20 "
                 "random episodes), `OfflineData` batches (seeds 0, 1): "
                 "elements that differ",
                 "`record_episodes` / `OfflineData`", float(differ), 0.0))

    def conv(tree):
        return convert_rl_params(jax.tree.map(np.asarray, tree))

    for name, jc, tc, kw in (("bc.py `BC.train`, batch 256 (3 updates)",
                              jbc.BCConfig, tbc.BCConfig, {}),
                             ("cql.py `CQL.train`, batch 64 (12 updates, "
                              "target every 2)", jcql.CQLConfig,
                              tcql.CQLConfig, {"train_batch_size": 64})):
        ref = (jc().environment(obs_dim=8, num_actions=4)
               .offline_data(dataset=ds).training(**kw).build())
        port = (tc().environment(obs_dim=8, num_actions=4)
                .offline_data(dataset=ds).training(**kw).build(device="cpu"))
        set_params_(port.params, conv(ref.params))
        cql = jc is jcql.CQLConfig
        if cql:
            ref.config.learner.target_update_every = 2
            port.config.learner.target_update_every = 2
            port.target_params = clone_weights(port.params)
        r, p = ref.train(), port.train()
        e = tree_err(port.get_weights(), conv(ref.params))
        if cql:
            e = max(e, tree_err(port.target_params, conv(ref.target_params)))
        ref_name = f"`{name.split('`')[1]}`"
        rows.append((f"rllib/{name}: loss (relative)", ref_name,
                     abs(p["loss"] - r["loss"]) / abs(r["loss"]), 1e-5))
        rows.append((f"the same: weights{' and target' if cql else ''}",
                     ref_name, e, 1e-4))


def checkpoint_rows(rows):
    """train/_checkpoint.py on tests/test_torch_checkpoint.py's cases."""
    import shutil
    import tempfile

    from test_torch_checkpoint import FOUR, LR, _flash, _ids, _register_all

    from ray_tpu.train import _checkpoint as jck
    from ray_tpu_torch.entry import train_job, train_rank
    from ray_tpu_torch.parallel.mesh import create_mesh
    from ray_tpu_torch.train import _checkpoint as tck

    tmp = tempfile.mkdtemp()
    old = tempfile.tempdir
    tempfile.tempdir = tmp
    try:
        job = train_job([{"shape": FOUR, "cfg": _flash(), "ids": _ids(),
                          "steps": 2, "lr": LR, "seed": 3,
                          "checkpoint": os.path.join(tmp, "mesh")}],
                        device="cpu")
        differ = 0
        for i, (attr, order) in enumerate(((None, "max"), ("score", "max"),
                                           ("score", "min"))):
            out = []
            for k, module in enumerate((jck, tck)):
                root = os.path.join(tmp, f"manager{i}_{k}")
                os.makedirs(os.path.join(root, "store", "checkpoint_000004"))
                srcs = []
                for j in range(5):
                    os.makedirs(os.path.join(root, f"s{j}"))
                    srcs.append(os.path.join(root, f"s{j}"))
                mgr = _register_all(module, os.path.join(root, "store"),
                                    srcs, attr, order)
                out.append((sorted(os.listdir(os.path.join(root, "store"))),
                            os.path.basename(mgr.latest.path),
                            os.path.basename(mgr.best.path), mgr._index))
            differ += int(out[0] != out[1])
        rows.append(("train/_checkpoint.py `CheckpointManager`, 5 "
                     "registrations over an existing checkpoint, keep 2, "
                     "by age / max / min: cases whose survivors, latest, "
                     "best or numbering differ",
                     "`CheckpointManager`", float(differ), 0.0))

        cfg = tllama.LlamaConfig.tiny()
        jm = jllama.LlamaModel(jllama.LlamaConfig.tiny())
        opt = optax.adamw(LR)
        ids = jnp.asarray(_ids())
        jstate = jstep.init_train_state(jm, opt, ids)
        sd = convert_params(jax.tree.map(np.asarray, jstate.params))
        res = train_rank(create_mesh({"data": 1}, devices=["cpu"]), 0, cfg,
                         _ids(), 2, LR, state_dict=sd, want_params=True,
                         checkpoint=os.path.join(tmp, "one"))
        fn = jstep.make_train_step(jm, opt, donate=False)
        for _ in range(2):
            jstate, _ = fn(jstate, ids, ids)
        jstate = jck.load_pytree(jck.save_pytree(
            jstate, os.path.join(tmp, "ref")), target=jstate)
        jstate, jloss = fn(jstate, ids, ids)
        ck = res["checkpoint"]
        want = convert_params(jax.tree.map(np.asarray, jstate.params))
        ranks = [r[0]["checkpoint"] for r in job.results(300)]
        rows.append(("train/_checkpoint.py round trip after 2 AdamW steps "
                     "of the tiny f32 Llama, then a step: states whose "
                     "loss, weights or moments differ from the continued "
                     "one's, on one device / on each of 4 gloo ranks at "
                     "`{\"fsdp\": 2, \"tensor\": 2}`",
                     "(the port without the round trip)",
                     float(not ck["equal"])
                     + sum(not c["equal"] for c in ranks), 0.0))
        rows.append(("the same on one device against the reference's 3 "
                     "steps with its orbax round trip: loss (relative)",
                     "`save_pytree`/`load_pytree` + `make_train_step`",
                     abs(ck["loss"] - float(jloss)) / abs(float(jloss)),
                     1e-5))
        rows.append(("the same: weights",
                     "`save_pytree`/`load_pytree` + `make_train_step`",
                     max(err(p, want[n]) for n, p in res["params"].items()),
                     1e-4))
    finally:
        job.close()
        tempfile.tempdir = old
        shutil.rmtree(tmp, ignore_errors=True)


def resnet50_bf16_distance():
    """The reference's bf16 logits against its f32 logits (relative
    Frobenius, training mode) for resnet50ish at chip_smoke.py's
    resnet_check weights (RESNET_SEED, drawn by the port) and inputs: the
    yardstick of chip_smoke.py's RESNET_REF_BF16_DIST."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    from ray_tpu.models.resnet import ResNet as JResNet
    from ray_tpu_torch.models.convert import unconvert_resnet_variables

    torch.set_num_threads(4)
    x, _ = chip_smoke.resnet_check_inputs()
    model = chip_smoke.resnet_model(torch.device("cpu"), torch.float32)
    params, stats = unconvert_resnet_variables(
        {k: v.numpy() for k, v in model.state_dict().items()})
    v = {"params": params, "batch_stats": stats}
    logits = {}
    for dt in (jnp.float32, jnp.bfloat16):
        jm = JResNet(num_classes=1000, stage_sizes=(3, 4, 6, 3), dtype=dt)
        fn = jax.jit(lambda v, x, jm=jm: jm.apply(
            v, x, train=True, mutable=["batch_stats"])[0])
        logits[dt] = np.asarray(fn(v, jnp.asarray(x)), np.float64)
    f32_, bf16_ = logits[jnp.float32], logits[jnp.bfloat16]
    dist = np.linalg.norm(bf16_ - f32_) / np.linalg.norm(f32_)
    print(f"resnet50ish reference bf16 vs f32 training logits, relative "
          f"Frobenius, jax {jax.__version__}: {float(dist)!r}")


def resnet50_grad_noise():
    """How far one step's f32 gradients of resnet50ish (chip_smoke.py's
    resnet_check weights and batch of 2) move with the order of sums alone:
    the port on the CPU at 1 and at 6 threads, against each other and
    against the port in float64 (global relative Frobenius)."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    x, y = chip_smoke.resnet_check_inputs()
    cpu = torch.device("cpu")
    grads = {}
    for name, threads, dt in (("f64", 6, torch.float64),
                              ("f32_6_threads", 6, torch.float32),
                              ("f32_1_thread", 1, torch.float32)):
        torch.set_num_threads(threads)
        g = chip_smoke.resnet_step_outputs(cpu, dt, x, y)[2]
        grads[name] = torch.cat([v.double().flatten() for v in g.values()])
    dist = lambda a, b: float(torch.linalg.norm(grads[a] - grads[b])
                              / torch.linalg.norm(grads[b]))
    print({"f32_1_vs_6_threads": dist("f32_1_thread", "f32_6_threads"),
           "f32_6_threads_vs_f64": dist("f32_6_threads", "f64"),
           "f32_1_thread_vs_f64": dist("f32_1_thread", "f64")})


def main():
    import sys

    sections = {"multi_agent": multi_agent_rows, "resnet": resnet_rows,
                "offline": offline_rows, "checkpoint": checkpoint_rows}
    names = sys.argv[1:]
    if names == ["resnet50_bf16"]:
        return resnet50_bf16_distance()
    if names == ["resnet50_grad_noise"]:
        return resnet50_grad_noise()
    rows = []
    if names:
        for n in names:
            sections[n](rows)
        return print_rows(rows)
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
    quant_moe_rows(rows, jparams, sd)
    text_surface_rows(rows)
    parallel_rows(rows)
    sharded_train_rows(rows)
    ring_pipeline_rows(rows)
    ep_rows(rows)
    rllib_rows(rows)
    for fn in sections.values():
        fn(rows)
    print_rows(rows)


def print_rows(rows):
    print("| Port module | JAX counterpart | max abs error | tolerance |")
    print("|---|---|---|---|")
    for name, ref_name, e, tol in rows:
        print(f"| {name} | {ref_name} | {e:.3g} | {tol:g} |")


if __name__ == "__main__":
    main()
