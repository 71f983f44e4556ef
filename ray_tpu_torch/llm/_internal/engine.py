"""Continuous-batching LLM engine. Port of ray_tpu/llm/_internal/engine.py.

Same scheduler as the JAX engine:
- a decode window of ``decode_steps`` tokens over a FIXED batch of slots
  (idle slots masked), here a Python loop of eager steps;
- batched prefill per length bucket, one pass over the weights for every
  admission of a wave, writing straight into the paged KV cache;
- prefix sharing of full prompt pages, with same-wave dependency ordering;
- pipelined dispatch: window N+1 is enqueued from window N's DEVICE outputs
  before N's tokens reach the host;
- batched multi-LoRA banks, a ``param_transform`` hook (int8 serving:
  ``param_transform=dequantize_tree`` over a quantized state dict from
  models/quant.py), and sampling (greedy, temperature, top-k, top-p,
  logprobs).

What differs, because this is PyTorch: the paged KV cache is updated in
place (the JAX engine donated it through each jitted step); host control
state goes to the device as a copy taken at dispatch time (the host mirrors
are mutated right after); and each slot samples from its own seeded
``torch.Generator``, which advances only when that slot samples a token, so
a seeded request's stream depends only on its seed and its own tokens.
JAX's threefry bits are not reproduced: sampled tokens differ from the JAX
engine's, greedy tokens do not.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.llm._internal.paged import (
    PageAllocator,
    PagedCacheConfig,
    PrefixCache,
)
from ray_tpu_torch.llm._internal.runner import ModelRunner, to_host
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclasses.dataclass
class EngineConfig:
    max_seqs: int = 8
    page_size: int = 16
    max_pages_per_seq: int = 64
    num_pages: Optional[int] = None  # default: enough for all slots full
    prefill_buckets: Tuple[int, ...] = (32, 128, 512, 2048)
    # Decode iterations per dispatch (multi-step scheduling): amortizes host
    # scheduling over K tokens at the cost of up to K-1 wasted tokens past a
    # stop condition.
    decode_steps: int = 8
    # Static width of the per-token top-logprob report (requests may ask
    # for fewer; more than this raises at add_request).
    max_logprobs: int = 5
    # Full prompt pages are indexed by content hash and shared across
    # requests.
    enable_prefix_cache: bool = True
    # Batched multi-LoRA: lora_rank 0 disables; max_loras counts ADAPTERS
    # (slot 0 = none).
    lora_rank: int = 0
    max_loras: int = 4
    lora_targets: Tuple[str, ...] = ("q_proj", "k_proj", "v_proj",
                                     "o_proj")
    # Overlap host scheduling with device compute: dispatch decode window
    # N+1 from window N's DEVICE outputs before N's tokens reach the host.
    pipeline_dispatch: bool = True

    def resolved_num_pages(self) -> int:
        return self.num_pages or self.max_seqs * self.max_pages_per_seq


@dataclasses.dataclass
class Request:
    request_id: str
    prompt_ids: List[int]
    max_tokens: int = 64
    temperature: float = 0.0
    stop_token: Optional[int] = None
    lora_id: str = ""  # adapter name ("" = base model)
    # OpenAI sampling parity: nucleus / top-k truncation; `seed` pins this
    # request's own generator (its stream depends only on its own sampling
    # events, not on batch-mates).
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled
    seed: Optional[int] = None
    # Number of top-alternative logprobs to return per token (0 = off).
    logprobs: int = 0
    # runtime state
    slot: int = -1
    generated: int = 0
    done: bool = False


@dataclasses.dataclass
class StepOutput:
    request_id: str
    token: int
    finished: bool
    # log p(token) under the UNSCALED model distribution, plus the top-N
    # (id, logprob) alternatives — populated when the request asked.
    logprob: Optional[float] = None
    top_logprobs: Optional[List[Tuple[int, float]]] = None


# A dispatched decode window: tokens [K,B], final last_tokens [B], final
# seq_lens [B] (all on the device; over ranks a pending reply of the ranks and
# handles of their device state), logprob arrays or None, and the slot set
# it was dispatched for.
_Window = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Any, frozenset]


class LLMEngine:
    """add_request() + step() — the scheduler half of continuous batching;
    the device half is a ``ModelRunner`` (llm/_internal/runner.py).

    ``params`` is a state dict (arrays or tensors) loaded into ``model``,
    ``SeededParams``, or None to use the model's own weights. With
    ``param_transform`` the engine keeps ``params`` as given on the device
    and runs every forward on ``param_transform(params)``, and ``model``'s
    own parameters are not read (build it on the meta device to hold none).
    When ``params`` holds quantized leaves (models/quant.py), the transform
    (e.g. ``dequantize_tree``) runs one module's sub-tree at a time where
    that module runs (``WeightsAtUse``), so at most one decoder layer or
    ``lm_head`` exists dequantized at a time; there it must map each leaf
    to one of the same full name, or the step raises. Otherwise it runs on
    the whole tree. Runs on ``device``: the card unless the caller names
    one.

    Tensor and expert parallel: pass ``mesh`` (parallel/mesh.py) of N > 1
    ranks whose axes above 1 are "tensor" and/or "expert". The device half
    then runs in N rank processes on the mesh's devices
    (llm/_internal/tp.py), each over its shard of the model
    (``LLAMA_SHARDING``: heads/mlp/vocab over tensor, an MoE model's
    experts over expert) and of the paged KV cache (its kv heads: split
    over "tensor", replicated over "expert"); ``model`` gives only the
    config (build it on the meta device), and ``params`` must be a full
    state dict (each rank keeps its slice) or ``SeededParams``. This engine
    keeps the scheduler, the page allocator and the host mirrors, and sends
    each dispatch's host inputs to every rank; rank 0 samples and returns
    the tokens. ``tp_backend``: "nccl" (default when every rank has its own
    card) or "gloo" (the CPU's, and the only one for ranks that share a
    card; it must then be named). LoRA and param_transform (int8) are not
    ported over ranks; nor is a mesh axis other than "tensor" and "expert"
    (each raises). ``close()`` stops the ranks.
    """

    def __init__(self, model, params, cfg: EngineConfig,
                 param_transform: Optional[Callable] = None, device=None,
                 mesh=None, tp_backend: Optional[str] = None):
        self.cfg = cfg
        mcfg = model.cfg
        self.cache_cfg = PagedCacheConfig(
            num_pages=cfg.resolved_num_pages() + 1,
            page_size=cfg.page_size, max_seqs=cfg.max_seqs,
            max_pages_per_seq=cfg.max_pages_per_seq)
        if mesh is not None:
            other = {ax: n for ax, n in zip(mesh.axis_names, mesh.shape)
                     if ax not in ("tensor", "expert") and n > 1}
            if other:
                raise NotImplementedError(
                    f"serving over mesh axes {other} is not ported: the "
                    "engine serves over \"tensor\" and \"expert\" axes; "
                    "data and fsdp axes are the sharded-training step's "
                    "(train/step.py)")
        # Whether the device half runs in rank processes.
        self.ranked = mesh is not None and mesh.size > 1
        if not self.ranked:
            self.runner = ModelRunner(model, params, cfg, self.cache_cfg,
                                      param_transform, device)
            self.device = self.runner.device
            self.model = self.runner.model
            self.params = self.runner.params
            self.caches = self.runner.caches
            self.lora_banks = self.runner.lora_banks
            self._sample = self.runner._sample
        else:
            unported = {"LoRA (lora_rank > 0)": cfg.lora_rank > 0,
                        "param_transform (int8 weights)":
                            param_transform is not None}
            for what, on in unported.items():
                if on:
                    raise NotImplementedError(
                        f"{what} under tensor or expert parallelism is not "
                        "ported")
            if params is None:
                raise ValueError("an engine over a mesh needs params: a "
                                 "full state dict or SeededParams")
            from ray_tpu_torch.llm._internal.tp import TPRunner

            self.runner = TPRunner(mcfg, params, cfg, self.cache_cfg, mesh,
                                   tp_backend)
            self.device = None
            self.model = model
            self.params = None
            self.lora_banks = None
        self.allocator = PageAllocator(self.cache_cfg)
        self.waiting: deque = deque()
        self.running: Dict[int, Request] = {}
        # host mirrors of device state
        self.page_table = np.zeros(
            (cfg.max_seqs, cfg.max_pages_per_seq), np.int32)
        self.seq_lens = np.zeros((cfg.max_seqs,), np.int32)
        self.last_tokens = np.zeros((cfg.max_seqs,), np.int32)
        self.temps = np.zeros((cfg.max_seqs,), np.float32)
        self.top_ps = np.ones((cfg.max_seqs,), np.float32)
        self.top_ks = np.zeros((cfg.max_seqs,), np.int32)
        self._seed_counter = 0
        self._free_slots = list(range(cfg.max_seqs))
        self.prefix_cache = (PrefixCache(self.allocator)
                             if cfg.enable_prefix_cache else None)
        self._lora_slots: Dict[str, int] = {}
        self.lora_idx = np.zeros((cfg.max_seqs,), np.int32)
        self._inflight: Optional[_Window] = None

    @property
    def _weights(self):
        """The runner's ``WeightsAtUse`` (None: whole-tree transform)."""
        return self.runner._weights

    @_weights.setter
    def _weights(self, weights) -> None:
        self.runner._weights = weights

    def close(self) -> None:
        """Stop the rank processes of an engine over a mesh (a no-op
        otherwise)."""
        if self.ranked:
            self.runner.close()

    # ------------------------------------------------------------------
    # LoRA multiplexing
    # ------------------------------------------------------------------
    def load_lora(self, name: str, adapter: Dict[str, Any],
                  scale: float = 1.0) -> int:
        """Install adapter weights into a bank slot. `adapter` maps
        "layers_<i>" → {proj: (A [r, Din], B [Dout, r])}. Returns the
        slot. Re-loading a name overwrites its slot."""
        if self.lora_banks is None:
            raise ValueError("engine built with lora_rank=0")
        slot = self._lora_slots.get(name)
        if slot is None:
            if len(self._lora_slots) >= self.cfg.max_loras:
                raise ValueError(
                    f"all {self.cfg.max_loras} LoRA slots in use")
            slot = len(self._lora_slots) + 1  # 0 = zero adapter
            self._lora_slots[name] = slot
        self.runner.load_lora(slot, adapter, scale)
        return slot

    def lora_slot(self, name: str) -> int:
        if not name:
            return 0
        slot = self._lora_slots.get(name)
        if slot is None:
            raise KeyError(f"LoRA adapter {name!r} not loaded")
        return slot

    # ------------------------------------------------------------------
    # Dispatch
    # ------------------------------------------------------------------
    def _decode_window(self, last_tokens, page_table, seq_lens) -> _Window:
        """Dispatch K decode steps over all slots. last_tokens/seq_lens [B]
        are host arrays or the in-flight window's device outputs;
        page_table [B,MP] and the slots' control state come from the host
        mirrors, copied now."""
        active = np.zeros((self.cfg.max_seqs,), bool)
        for slot in self.running:
            active[slot] = True
        rich, want_lp = self._sampling_flags(self.running.values())
        out, toks, lens, lps = self.runner.decode_window(
            last_tokens, page_table, seq_lens, active, self.temps,
            self.top_ps, self.top_ks, self.lora_idx, rich, want_lp)
        return (out, toks, lens, lps, frozenset(self.running))

    def _host(self, toks, lp):
        """A dispatch's tokens and logprobs on the host (blocks)."""
        if self.ranked:
            return toks.get()
        return to_host(toks, lp)

    def _sampling_flags(self, reqs) -> Tuple[bool, bool]:
        rich = any(r.temperature > 0 and (r.top_p < 1.0 or r.top_k > 0)
                   for r in reqs)
        want_lp = any(r.logprobs > 0 for r in reqs)
        return rich, want_lp

    # ------------------------------------------------------------------
    # Scheduler
    # ------------------------------------------------------------------
    def add_request(self, req: Request) -> None:
        # Multi-step decode may overshoot by up to decode_steps-1 writes.
        need = (len(req.prompt_ids) + req.max_tokens
                + max(1, self.cfg.decode_steps) - 1)
        if need > self.cache_cfg.max_context:
            raise ValueError(
                f"request needs up to {need} cache slots; max context is "
                f"{self.cache_cfg.max_context}")
        if not (0.0 < req.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {req.top_p}")
        if req.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {req.top_k}")
        if req.logprobs < 0 or req.logprobs > self.cfg.max_logprobs:
            raise ValueError(
                f"logprobs must be in [0, {self.cfg.max_logprobs}], got "
                f"{req.logprobs}")
        if req.lora_id:
            if self.lora_banks is None:
                raise KeyError(
                    f"LoRA adapter {req.lora_id!r} requested but the "
                    "engine was built with lora_rank=0")
            self.lora_slot(req.lora_id)  # validate HERE, before any
            # admission-time state mutation — a typo'd adapter must fail
            # this one request, not poison the running batch
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def num_running(self) -> int:
        return len(self.running)

    def step(self) -> List[StepOutput]:
        """Admit + prefill waiting requests, then one decode window.

        With pipeline_dispatch, the next window is dispatched from the
        in-flight window's DEVICE outputs before its tokens reach the
        host, so host-side stop/stream handling overlaps device compute.
        The pipeline drains to a sync point when the slot set changes
        (admit/finish) — the next dispatch then rebuilds control state from
        the host mirrors."""
        out: List[StepOutput] = []
        admitted = self._admit(out)
        if not self.running:
            if self._inflight is not None:
                self._process_window(self._inflight, out)
                self._inflight = None
            return out
        if admitted and self._inflight is not None:
            # Admission changed active/temps/last_tokens: the in-flight
            # window predates it — drain before dispatching from host.
            self._process_window(self._inflight, out)
            self._inflight = None
            if not self.running:
                return out
        K = max(1, self.cfg.decode_steps)
        if self._inflight is None:
            self._ensure_decode_pages(K)
            self._inflight = self._decode_window(
                self.last_tokens, self.page_table, self.seq_lens)
            if not self.cfg.pipeline_dispatch:
                self._process_window(self._inflight, out)
                self._inflight = None
            return out
        # Pipelined: cover the NEXT window's writes too, then chain the
        # dispatch off the in-flight window's device state. Skip the chain
        # when every request ends inside the in-flight window — the chained
        # window would be pure waste.
        if all(r.generated + K >= r.max_tokens
               for r in self.running.values()):
            self._process_window(self._inflight, out)
            self._inflight = None
            return out
        self._ensure_decode_pages(2 * K)
        _, last, lens, _, _ = self._inflight
        nxt = self._decode_window(last, self.page_table, lens)
        finished = self._process_window(self._inflight, out)
        if finished:
            # The chained window ran with pre-finish control state. Its
            # tokens are still VALID for surviving slots (their device
            # last/lens were correct); finished slots are skipped by the
            # processing loop, and their stale page writes are harmless:
            # released pages get re-prefilled by strictly later work on the
            # ordered device stream. Process it now and resync from host
            # state on the next step.
            self._process_window(nxt, out)
            self._inflight = None
        else:
            self._inflight = nxt
        return out

    def _process_window(self, window: _Window,
                        out: Optional[List[StepOutput]]) -> bool:
        """Block on a window's tokens; update host mirrors and emit
        outputs. out=None discards (pipeline drain). Returns True if any
        slot finished."""
        toks, _, _, lp, slots = window
        toks, lp = self._host(toks, lp)  # [K, B] (blocks here)
        if out is None:
            return False
        K = toks.shape[0]
        finished_any = False
        for slot in slots:
            req = self.running.get(slot)
            if req is None:
                continue
            if req.done:  # aborted externally (e.g. stop-string match)
                self._release(slot)
                finished_any = True
                continue
            for j in range(K):
                tok = int(toks[j, slot])
                self.seq_lens[slot] += 1
                self.last_tokens[slot] = tok
                req.generated += 1
                finished = (req.generated >= req.max_tokens
                            or (req.stop_token is not None
                                and tok == req.stop_token))
                so = StepOutput(req.request_id, tok, finished)
                if lp is not None and req.logprobs > 0:
                    so.logprob = float(lp[0][j, slot])
                    so.top_logprobs = [
                        (int(lp[2][j, slot, i]), float(lp[1][j, slot, i]))
                        for i in range(req.logprobs)]
                out.append(so)
                if finished:
                    # Tokens past the stop within this window are wasted
                    # compute (multi-step tradeoff); drop them.
                    self._release(slot)
                    finished_any = True
                    break
        return finished_any

    def finish_request(self, request_id: str) -> bool:
        """Finish a request early (serving layer stop-string match /
        client disconnect). Safe from the engine-loop thread; the slot is
        released at the next window boundary (an in-flight window's
        remaining tokens for it are dropped)."""
        for req in self.running.values():
            if req.request_id == request_id:
                req.done = True
                return True
        for req in list(self.waiting):
            if req.request_id == request_id:
                self.waiting.remove(req)
                return True
        return False

    def _admit(self, out: List[StepOutput]) -> bool:
        """Admit as many waiting requests as fit. The wave's prefills run
        BATCHED per bucket — one pass over the weights for the whole
        admission wave, not one per request — and the first tokens stay on
        device until every batch is in flight, so TTFT for N admissions is
        ~one weight stream + one host sync."""
        admitted = False
        # Flat admission-order list of (slot, req, suffix_ids, cached_len,
        # S, bucket, deps). deps = admission indices of SAME-WAVE requests
        # whose prefill must be dispatched first: a sharer attends over
        # pages its owner's prefill writes, so owner and sharer in one
        # batched prefill would race; dispatch below splits buckets into
        # dependency-respecting sub-batches.
        entries: List[Tuple[int, Request, Any, int, int, int, set]] = []
        # page id -> admission index of the request whose prefill writes it
        wave_page_owner: Dict[int, int] = {}
        ps = self.cache_cfg.page_size
        while self.waiting and self._free_slots:
            req: Request = self.waiting[0]
            T = len(req.prompt_ids)
            # Prefix reuse: share the longest cached run of FULL prompt
            # pages into this slot; prefill then runs only on the suffix.
            # At least one real token must go through prefill (it produces
            # the first sampled token), so a whole-prompt hit backs off by
            # one page.
            digests: List[Any] = []
            shared: List[int] = []
            if self.prefix_cache is not None:
                digests = self.prefix_cache.page_digests(req.prompt_ids, ps)
                shared = self.prefix_cache.match(digests)
                if len(shared) * ps >= T:
                    shared = shared[:(T - 1) // ps]
                # PIN the matched pages before any eviction below can see
                # them as cache-only (ref==1) and hand them to the free
                # list — a page must never be shared and free at once.
                for p in shared:
                    self.allocator.retain(p)
            cached_len = len(shared) * ps
            fresh_tokens = T + 1 - cached_len  # suffix + first decode room
            if not self.allocator.can_allocate(fresh_tokens):
                deficit = (self.allocator.pages_needed(fresh_tokens)
                           - self.allocator.num_free)
                if self.prefix_cache is not None and deficit > 0:
                    self.prefix_cache.evict(deficit)
                if not self.allocator.can_allocate(fresh_tokens):
                    for p in shared:  # unpin: not admitting
                        self.allocator.unref(p)
                    break  # wait for running requests to free pages
            self.waiting.popleft()
            admitted = True
            slot = self._free_slots.pop()
            req.slot = slot
            self.running[slot] = req
            if shared:
                # transfer the admission pins to the slot
                self.allocator.adopt(slot, shared)
            pages = self.allocator.ensure(slot, T + 1)
            row = np.zeros((self.cfg.max_pages_per_seq,), np.int32)
            row[:len(pages)] = pages
            self.page_table[slot] = row
            suffix = req.prompt_ids[cached_len:]
            S = len(suffix)
            bucket = next((b for b in self.cfg.prefill_buckets if b >= S),
                          self.cache_cfg.max_context)
            self.temps[slot] = req.temperature
            self.top_ps[slot] = req.top_p
            self.top_ks[slot] = req.top_k
            # Seed this slot's generator: explicit seed for reproducible
            # requests, else a fresh engine-global counter.
            if req.seed is not None:
                seed = int(req.seed)
            else:
                self._seed_counter += 1
                seed = (0x5eed << 20) + self._seed_counter
            self.runner.seed(slot, seed)
            self.lora_idx[slot] = self.lora_slot(req.lora_id) \
                if self.lora_banks is not None else 0
            idx = len(entries)
            deps = {wave_page_owner[p] for p in shared
                    if p in wave_page_owner}
            if self.prefix_cache is not None and digests:
                # Index this prompt's full pages for future requests;
                # no-op for runs already cached. Pages past the shared
                # prefix are written by THIS request's prefill — record
                # ownership so later same-wave sharers order after us.
                n_full = len(digests)
                slot_pages = self.allocator.slot_pages[slot]
                self.prefix_cache.insert(digests, slot_pages[:n_full])
                for p in slot_pages[len(shared):n_full]:
                    wave_page_owner[p] = idx
            self.seq_lens[slot] = T
            req.generated = 1
            entries.append((slot, req, suffix, cached_len, S, bucket, deps))
        pending: List[Tuple[int, Request, Any, Any, int]] = []
        # Dispatch in dependency-respecting sub-batches: repeatedly take
        # the earliest undispatched admission, batch it with every other
        # undispatched same-bucket entry whose deps are all dispatched.
        # deps always point to earlier admissions, so the earliest
        # remaining entry is always dispatchable (no deadlock).
        done: set = set()
        remaining = list(range(len(entries)))
        while remaining:
            bucket = entries[remaining[0]][5]
            batch = [j for j in remaining
                     if entries[j][5] == bucket and entries[j][6] <= done]
            wave = [entries[j][:5] for j in batch]
            nb = len(wave)
            ids = np.zeros((nb, bucket), np.int32)
            rows = np.zeros((nb, self.cfg.max_pages_per_seq), np.int32)
            starts = np.zeros((nb,), np.int32)
            lens = np.zeros((nb,), np.int32)
            temps = np.zeros((nb,), np.float32)
            tps = np.ones((nb,), np.float32)
            tks = np.zeros((nb,), np.int32)
            slot_ids = np.zeros((nb,), np.int32)
            lidx = np.zeros((nb,), np.int32)
            for i, (slot, req, suffix, cached_len, S) in enumerate(wave):
                ids[i, :S] = suffix
                rows[i] = self.page_table[slot]
                starts[i] = cached_len
                lens[i] = S
                temps[i] = req.temperature
                tps[i] = req.top_p
                tks[i] = req.top_k
                slot_ids[i] = slot
                lidx[i] = self.lora_idx[slot]
            rich, want_lp = self._sampling_flags(
                [entries[j][1] for j in batch])
            dev_toks, lp = self.runner.prefill(ids, rows, starts, lens,
                                               temps, tps, tks, slot_ids,
                                               lidx, rich, want_lp)
            for i, (slot, req, _, _, _) in enumerate(wave):
                pending.append((slot, req, dev_toks, lp, i))
            done.update(batch)
            remaining = [j for j in remaining if j not in done]
        host: Dict[int, Any] = {}  # id(dev_toks) -> host copies
        for slot, req, dev_toks, lp, i in pending:
            if id(dev_toks) not in host:  # sync: all waves in flight
                host[id(dev_toks)] = self._host(dev_toks, lp)
            toks_h, lp_h = host[id(dev_toks)]
            tok = int(toks_h[i])
            self.last_tokens[slot] = tok
            finished = (req.generated >= req.max_tokens
                        or (req.stop_token is not None
                            and tok == req.stop_token))
            so = StepOutput(req.request_id, tok, finished)
            if lp_h is not None and req.logprobs > 0:
                so.logprob = float(lp_h[0][i])
                so.top_logprobs = [(int(lp_h[2][i, k]), float(lp_h[1][i, k]))
                                   for k in range(req.logprobs)]
            out.append(so)
            if finished:
                self._release(slot)
        return admitted

    def _ensure_decode_pages(self, k: int = 1) -> None:
        """Each running slot is about to append up to k tokens starting at
        seq_lens[slot]; grow its page list to cover them. Cache-held prefix
        pages are evictable fuel here too — decode growth must not die on
        MemoryError while reclaimable pages exist."""
        for slot in list(self.running):
            need = int(self.seq_lens[slot]) + k
            try:
                pages = self.allocator.ensure(slot, need)
            except MemoryError:
                if self.prefix_cache is None:
                    raise
                deficit = (self.allocator.pages_needed(need)
                           - len(self.allocator.slot_pages[slot])
                           - self.allocator.num_free)
                self.prefix_cache.evict(max(1, deficit))
                pages = self.allocator.ensure(slot, need)
            row = self.page_table[slot]
            row[:len(pages)] = pages

    def _release(self, slot: int) -> None:
        self.running.pop(slot, None)
        self.allocator.release(slot)
        self._free_slots.append(slot)
        self.seq_lens[slot] = 0
        self.lora_idx[slot] = 0
        self.top_ps[slot] = 1.0
        self.top_ks[slot] = 0
