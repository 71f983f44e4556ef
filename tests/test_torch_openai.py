"""Port parity for the text surface of llm/: the byte-level BPE tokenizer
(tokenizer.py) and the OpenAI-compatible server (openai.py). The same
request dicts go through ray_tpu's OpenAIServer and ray_tpu_torch's, over
the same weights (one pickle of a JAX init, read by both packages'
load_model_and_params) and the same trained tokenizer file. Bodies and SSE
lines must be equal apart from "id" and "created", logprobs within 1e-4.

No ray_tpu.init, Serve or Data: the reference server is called directly,
as its proxy would call it."""

import json
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm._internal import openai as jopenai
from ray_tpu.llm._internal import tokenizer as jtok
from ray_tpu.models import llama as jllama
from ray_tpu_torch.llm import (
    ByteBPETokenizer,
    OpenAIServer,
    apply_chat_template,
    get_tokenizer,
)
from ray_tpu_torch.llm._internal import openai as topenai
from ray_tpu_torch.llm._internal import tokenizer as ttok


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads for this module's torch work, restored after
    (several pytest workers share the machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


MODEL_ID = "tiny-test-model"
LP_TOL = 1e-4
# Multi-byte text (2-, 3- and 4-byte UTF-8) so that merges and decoded
# tokens split characters.
CORPUS = ["the quick brown fox jumps over the lazy dog. " * 8,
          "héllo wörld — naïve café ✓ 漢字 漢字 🙂🙂 " * 6,
          "def f(x):\n    return x  +  1\n\n" * 5]
PIECES = ["the", " quick", " fox", "é", "ö", "—", "✓", "漢", "字", "🙂",
          " ", "  ", "\n", "\n\n", "\t", "0", "42", "'s", "!?", " ",
          "<|eot_id|>", "<|begin_of_text|>", "<|pad|>", "x", "Z"]


def _strings(seed, n=24):
    rng = np.random.default_rng(seed)
    return ["".join(PIECES[i] for i in rng.integers(0, len(PIECES),
                                                    rng.integers(0, 16)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(tokenizer_path, params_path): a tokenizer trained to 300 ids on
    CORPUS by the reference, and a LlamaConfig.tiny(vocab_size=512) JAX
    init as numpy."""
    d = tmp_path_factory.mktemp("openai")
    tok_path = str(d / "tok.json")
    jtok.ByteBPETokenizer.train(CORPUS, vocab_size=300).save(tok_path)
    model = jllama.LlamaModel(jllama.LlamaConfig.tiny(vocab_size=512))
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    params_path = str(d / "params.pkl")
    with open(params_path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)
    return tok_path, params_path


@pytest.fixture(scope="module")
def llm_config(files):
    tok_path, params_path = files
    return {"model": "tiny", "model_id": MODEL_ID,
            "model_config": {"vocab_size": 512},
            "params_path": params_path, "tokenizer_path": tok_path,
            "engine_config": {"max_seqs": 2, "page_size": 4,
                              "max_pages_per_seq": 16, "decode_steps": 1}}


@pytest.fixture(scope="module")
def servers(llm_config):
    """(reference, port) OpenAIServers, one each for the module."""
    ref = jopenai.OpenAIServer(llm_config)
    port = OpenAIServer(llm_config, device="cpu")
    yield ref, port
    port.server.shutdown()
    assert not port.server._thread.is_alive()
    ref.server._running = False  # the reference server has no shutdown


# ---------------------------------------------------------------------------
# Tokenizer (exact)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vocab_size", [262, 300, 400])
def test_train_learns_the_same_merges(vocab_size):
    ref = jtok.ByteBPETokenizer.train(CORPUS, vocab_size=vocab_size)
    port = ByteBPETokenizer.train(CORPUS, vocab_size=vocab_size)
    assert port.merges == ref.merges
    assert port.vocab_size == ref.vocab_size
    for name in ("bos_id", "eos_id", "eot_id", "pad_id"):
        assert getattr(port, name) == getattr(ref, name)
    assert port.eot_id == (256 + len(port.merges)
                           + ttok.SPECIAL_TOKENS.index(ttok.EOT))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_decode_equal_reference(files, seed):
    ref = jtok.ByteBPETokenizer.load(files[0])
    port = ByteBPETokenizer.load(files[0])
    rng = np.random.default_rng(100 + seed)
    for s in _strings(seed):
        assert (port.encode(s, add_bos=True)
                == ref.encode(s, add_bos=True)), s
        ids = port.encode(s)
        assert ids == ref.encode(s), s
        assert port.decode(ids) == ref.decode(ids)
        assert (port.decode(ids, skip_specials=False)
                == ref.decode(ids, skip_specials=False) == s)
        # arbitrary ids: split characters, specials, ids past the vocab
        junk = rng.integers(0, 320, 12).tolist()
        assert port.decode(junk) == ref.decode(junk)
        assert (port.decode(junk, skip_specials=False)
                == ref.decode(junk, skip_specials=False))


def test_byte_fallback_and_get_tokenizer_equal_reference():
    s = "".join(_strings(7, n=4))
    ref, port = jtok.ByteBPETokenizer.byte_fallback(), get_tokenizer({})
    assert port.vocab_size == ref.vocab_size == 262
    assert port.encode(s) == ref.encode(s)
    assert port.decode(port.encode(s), skip_specials=False) == s
    assert get_tokenizer(None).encode(s) == ref.encode(s)


@pytest.mark.parametrize("gen_prompt", [True, False])
def test_chat_template_equal_reference(files, gen_prompt):
    ref = jtok.ByteBPETokenizer.load(files[0])
    port = ByteBPETokenizer.load(files[0])
    messages = [{"role": "system", "content": "be brief ✓"},
                {"role": "user", "content": "héllo <|eot_id|> 漢字"},
                {"role": "assistant", "content": ""},
                {"content": "no role"}]
    assert (apply_chat_template(port, messages, gen_prompt)
            == jtok.apply_chat_template(ref, messages, gen_prompt))


def test_saved_files_load_in_the_other_package(tmp_path):
    ref = jtok.ByteBPETokenizer.train(CORPUS, vocab_size=320)
    port = ByteBPETokenizer.train(CORPUS, vocab_size=320)
    ref.save(str(tmp_path / "ref.json"))
    port.save(str(tmp_path / "port.json"))
    assert ((tmp_path / "ref.json").read_text()
            == (tmp_path / "port.json").read_text())
    a = ByteBPETokenizer.load(str(tmp_path / "ref.json"))
    b = jtok.ByteBPETokenizer.load(str(tmp_path / "port.json"))
    s = " ".join(_strings(3))
    assert a.encode(s) == b.encode(s) == ref.encode(s)
    assert get_tokenizer({"tokenizer_path": str(tmp_path / "ref.json")}
                         ).merges == ref.merges


# ---------------------------------------------------------------------------
# Stream helpers (exact, no model)
# ---------------------------------------------------------------------------
def test_incremental_decoder_holds_back_split_characters():
    """Pushed one id at a time, multi-byte characters split across byte
    tokens never reach a delta as U+FFFD; the deltas join to the text."""
    tok = ByteBPETokenizer.byte_fallback()
    text = "a—漢🙂b é"
    ref_dec = jopenai._IncrementalDecoder(
        jtok.ByteBPETokenizer.byte_fallback())
    dec = topenai._IncrementalDecoder(tok)
    deltas = [dec.push(i) for i in tok.encode(text)]
    assert deltas == [ref_dec.push(i) for i in tok.encode(text)]
    assert "".join(deltas) == text
    assert not any("�" in d for d in deltas)


@pytest.mark.parametrize("stops,chunks", [
    (["ab"], ["xa", "b", "c"]),
    (["abc", "b"], ["a", "bc"]),
    (["need"], ["no ", "ne", "ed", "le"]),
    (["zz"], ["a", "b", "c"]),
    (["漢字"], ["x漢", "字y"]),
    ([], ["a", "b"]),
    (["", "q"], ["pq"]),
])
def test_stop_matcher_equal_reference(stops, chunks):
    """A stop string spanning chunks emits nothing of itself; with no
    match, flush returns the held-back tail."""
    ref, port = jopenai._StopMatcher(stops), topenai._StopMatcher(stops)
    got = []
    for c in chunks:
        got.append(port.push(c))
        assert got[-1] == ref.push(c)
        if got[-1][1]:
            break
    emitted = "".join(e for e, _ in got)
    text = "".join(chunks)
    hits = [text.find(s) for s in stops if s and s in text]
    if hits:
        assert got[-1][1] and emitted == text[:min(hits)]
    else:
        tail = port.flush()
        assert tail == ref.flush()
        assert emitted + tail == text


# ---------------------------------------------------------------------------
# OpenAIServer: the same request dicts through both
# ---------------------------------------------------------------------------
def _strip(obj, top=True):
    """Drop "created" everywhere and a response's own "id"."""
    if isinstance(obj, dict):
        return {k: _strip(v, False) for k, v in obj.items()
                if k != "created" and not (top and k == "id")}
    if isinstance(obj, list):
        return [_strip(v, False) for v in obj]
    return obj


def assert_same(port, ref, path="body"):
    """Equal structure and values; floats within LP_TOL."""
    assert type(port) is type(ref) or (isinstance(port, (int, float))
                                       and isinstance(ref, (int, float))), \
        (path, port, ref)
    if isinstance(ref, dict):
        assert list(port) == list(ref), (path, port, ref)
        for k in ref:
            assert_same(port[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert len(port) == len(ref), (path, port, ref)
        for i, (a, b) in enumerate(zip(port, ref)):
            assert_same(a, b, f"{path}[{i}]")
    elif isinstance(ref, float):
        assert abs(port - ref) <= LP_TOL, (path, port, ref)
    else:
        assert port == ref, (path, port, ref)


def _sse_items(stream):
    """A streamed response as comparable items: the header dict, each
    data line's JSON without id/created, and the [DONE] line."""
    out = []
    for item in stream:
        if isinstance(item, dict):
            out.append(item)
            continue
        assert item.startswith("data: ") and item.endswith("\n\n"), item
        payload = item[len("data: "):-2]
        out.append(payload if payload == "[DONE]"
                   else _strip(json.loads(payload)))
    return out


def _both(servers, suffix, body):
    ref, port = servers
    req = {"suffix": suffix, "body": body}
    r, p = ref(dict(req)), port(dict(req))
    if isinstance(r, dict):
        assert isinstance(p, dict)
        return _strip(p), _strip(r)
    return _sse_items(p), _sse_items(r)


PROMPT_IDS = [5, 17, 42, 7, 260, 99, 3]
CHAT = [{"role": "user", "content": "héllo fox ✓"}]


def _stream_text(items, chat):
    key = (lambda c: c["delta"].get("content", "")) if chat else \
        (lambda c: c["text"])
    return "".join(key(it["choices"][0]) for it in items[1:-1])


def test_models_route(servers):
    p, r = _both(servers, "/v1/models", None)
    assert_same(p, r)
    assert p["data"][0]["id"] == MODEL_ID
    assert servers[1].check_health()


@pytest.mark.parametrize("case,suffix,body", [
    ("text", "/v1/completions", {"prompt": "the quick fox", "max_tokens": 12}),
    ("ids", "/v1/completions", {"prompt": PROMPT_IDS, "max_tokens": 12}),
    ("text_list", "/v1/completions", {"prompt": ["héllo", " wörld"],
                                      "max_tokens": 12}),
    ("chat", "/v1/chat/completions", {"messages": CHAT, "max_tokens": 12,
                                      "model": MODEL_ID}),
])
def test_unary_bodies_equal_reference(servers, case, suffix, body):
    p, r = _both(servers, suffix, body)
    assert_same(p, r)
    chat = "chat" in suffix
    assert p["object"] == ("chat.completion" if chat else "text_completion")
    assert p["model"] == MODEL_ID
    assert p["usage"]["completion_tokens"] <= 12


@pytest.mark.parametrize("suffix,body", [
    ("/v1/completions", {"prompt": PROMPT_IDS, "max_tokens": 12}),
    ("/v1/chat/completions", {"messages": CHAT, "max_tokens": 12}),
])
def test_streams_equal_reference_and_their_unary_text(servers, suffix, body):
    p, r = _both(servers, suffix, {**body, "stream": True})
    assert_same(p, r)
    chat = "chat" in suffix
    assert p[0] == {"__http__": {"content_type": "text/event-stream"}}
    assert p[-1] == "[DONE]"
    assert p[-2]["choices"][0]["finish_reason"] == "stop"
    if chat:
        assert p[1]["choices"][0]["delta"] == {"role": "assistant",
                                               "content": ""}
    unary, _ = _both(servers, suffix, body)
    assert _stream_text(p, chat) == _text(unary, chat)


STOP_CASES = {"/v1/completions": {"prompt": "héllo"},
              "/v1/chat/completions": {"messages": CHAT}}


def _text(body, chat):
    choice = body["choices"][0]
    return choice["message"]["content"] if chat else choice["text"]


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("suffix", list(STOP_CASES))
def test_stop_string_equal_reference(servers, suffix, stream):
    """The stop string is taken from the no-stop answer: its first two
    characters, from the third on, that hold a multi-byte character and no
    U+FFFD. The answer halts before it, in the engine too."""
    chat = "chat" in suffix
    base = {**STOP_CASES[suffix], "max_tokens": 24}
    p, r = _both(servers, suffix, base)
    assert_same(p, r)
    full = _text(p, chat)
    stop = next(full[i:i + 2] for i in range(2, len(full) - 1)
                if "\ufffd" not in full[i:i + 2]
                and max(full[i:i + 2]) > "\x7f")
    idx = full.find(stop)
    assert idx > 0
    p, r = _both(servers, suffix, {**base, "stop": [stop],
                                   "stream": stream})
    assert_same(p, r)
    if stream:
        assert _stream_text(p, chat) == full[:idx]
    else:
        assert _text(p, chat) == full[:idx]
        assert p["choices"][0]["finish_reason"] == "stop"
        assert p["usage"]["completion_tokens"] < 24


@pytest.mark.parametrize("suffix,body", [
    ("/v1/completions", {"prompt": PROMPT_IDS, "max_tokens": 8,
                         "logprobs": 2}),
    ("/v1/chat/completions", {"messages": CHAT, "max_tokens": 8,
                              "logprobs": True, "top_logprobs": 2}),
])
def test_logprobs_blocks_equal_reference(servers, suffix, body):
    p, r = _both(servers, suffix, body)
    assert_same(p, r)
    lp = p["choices"][0]["logprobs"]
    if "content" in lp:
        for entry in lp["content"]:
            assert len(entry["top_logprobs"]) == 2
            # greedy: the chosen token heads its alternatives
            assert entry["logprob"] == entry["top_logprobs"][0]["logprob"]
    else:
        assert len(lp["tokens"]) == len(lp["token_logprobs"]) == 8
        # Ids past the tokenizer's vocab decode to "", so two alternatives
        # can share one key of a top_logprobs dict (as in the reference).
        for value, top in zip(lp["token_logprobs"], lp["top_logprobs"]):
            assert 1 <= len(top) <= 2 and value >= max(top.values())


def test_tied_top_logprobs_come_lowest_id_first(servers):
    """Logits with many exact ties (as bf16 logits have): the port engine's
    top logprobs equal jax.lax.top_k's, which puts the lower id first
    among equal values, and the greedy token heads them."""
    engine = servers[1].server.engine
    rng = np.random.default_rng(5)
    logits = np.round(rng.standard_normal((6, 512)) * 2).astype(np.float32)
    n = logits.shape[0]
    toks, (chosen, vals, ids) = engine._sample(
        torch.from_numpy(logits), torch.zeros(n), torch.ones(n),
        torch.zeros(n, dtype=torch.int32), [], False, True)
    L = engine.cfg.max_logprobs
    jvals, jids = jax.lax.top_k(jax.nn.log_softmax(jnp.asarray(logits)), L)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), atol=1e-6)
    np.testing.assert_array_equal(toks.numpy(), ids[:, 0].numpy())
    assert (vals[:, 0] == vals[:, 1]).any()  # the case holds ties


@pytest.mark.parametrize("suffix,body,status", [
    ("/v1/completions", {"prompt": "x", "top_p": 0}, 400),
    ("/v1/completions", {"prompt": "x", "top_p": 1.5, "stream": True}, 400),
    ("/v1/chat/completions", {"messages": CHAT, "top_k": -1}, 400),
    ("/v1/chat/completions", {"max_tokens": 4}, 400),
    ("/v1/chat/completions", {"messages": [], "stream": True}, 400),
    ("/v1/embeddings", {"input": "x"}, 404),
])
def test_error_bodies_equal_reference(servers, suffix, body, status):
    p, r = _both(servers, suffix, body)
    assert p == r
    assert p["__http__"] == {"status": status}
    assert p["body"]["error"]["type"] == "invalid_request_error"
    assert servers[1].stats()["running"] == 0


@pytest.mark.parametrize("body", [
    {},
    {"model": MODEL_ID},
    {"model": f"{MODEL_ID}:adapter1", "seed": 3, "temperature": 0.7},
    {"model": "adapter2", "top_p": 0.5, "top_k": 4, "max_tokens": 9},
    {"logprobs": 3},
    {"logprobs": True},
    {"logprobs": True, "top_logprobs": 4},
    {"logprobs": False, "top_logprobs": 4},
])
def test_gen_kwargs_and_lora_mapping_equal_reference(servers, body):
    ref, port = servers
    got = port._gen_kwargs(body)
    assert got == ref._gen_kwargs(body)
    assert got["stop_token"] == port.tokenizer.eot_id
    model = body.get("model")
    if model and model != MODEL_ID:
        assert got["lora_id"] == model.split(":")[-1]
    else:
        assert "lora_id" not in got


def _wait_idle(oai, timeout=30.0):
    deadline = time.monotonic() + timeout
    while True:
        st = oai.stats()
        if st["running"] == 0 and st["waiting"] == 0 and st["pending"] == 0:
            return st
        assert time.monotonic() < deadline, st
        time.sleep(0.005)


@pytest.mark.parametrize("suffix,body", [
    ("/v1/completions", {"prompt": PROMPT_IDS}),
    ("/v1/chat/completions", {"messages": CHAT}),
])
def test_stream_closed_early_frees_its_slot(servers, monkeypatch, suffix,
                                            body):
    """A consumer that closes a stream after a few items aborts the engine
    request: it never finishes in the engine, no request stays running or
    waiting, and every page of the cache is free again."""
    port = servers[1]
    engine = port.server.engine
    free = engine.allocator.num_free
    outputs = []
    step = engine.step

    def recording_step():
        out = step()
        outputs.extend(out)
        return out

    monkeypatch.setattr(engine, "step", recording_step)
    n_prompt = (len(PROMPT_IDS) if "prompt" in body else
                len(apply_chat_template(port.tokenizer, CHAT)))
    max_tokens = 64 - n_prompt  # the whole context (decode_steps=1)
    stream = port({"suffix": suffix,
                   "body": {**body, "max_tokens": max_tokens,
                            "stream": True}})
    for _ in range(4):
        next(stream)
    stream.close()
    st = _wait_idle(port)
    assert st["free_pages"] == free
    assert outputs and not any(so.finished for so in outputs)
    assert len(outputs) < max_tokens


def test_entry_point_raises_without_cuda(llm_config, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        OpenAIServer(llm_config)
