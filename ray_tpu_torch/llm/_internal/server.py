"""LLMServer: one engine replica behind a thread. Port of
ray_tpu/llm/_internal/server.py.

The engine runs on a dedicated thread; request handlers enqueue work and
stream tokens back through per-request queues. The Serve deployment around
it (``build_llm_deployment``) waits for the slice that ports Serve's glue.

``tensor_parallel_size=N`` (or a port ``Mesh`` under "mesh", whose axes
above 1 are "tensor" and/or "expert") serves through N rank processes
(llm/_internal/tp.py), as the reference's engine shards over its mesh.
"""

from __future__ import annotations

import contextlib
import pickle
import queue
import threading
import time
import uuid
from typing import Any, Dict, Iterator, List, Optional

import torch

from ray_tpu_torch.llm._internal.engine import EngineConfig, LLMEngine, Request
from ray_tpu_torch.llm._internal.runner import SeededParams
from ray_tpu_torch.llm._internal.tp import RankError
from ray_tpu_torch.models.convert import convert_params
from ray_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaModel,
    init_params,
    load_params,
)
from ray_tpu_torch.parallel.mesh import create_mesh
from ray_tpu_torch.utils.device import resolve_device
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def load_model_and_params(llm_config: Dict[str, Any], device=None):
    """Resolve an llm_config dict to (model, params) on ``device`` (the card
    unless the caller names one). ``params`` is the model's state dict.

    - ``model``: "tiny" (``model_config`` goes to LlamaConfig.tiny),
      "llama3-8b", or anything else (``model_config`` builds LlamaConfig);
    - ``params_path``: a pickle of the JAX model's params as numpy arrays,
      converted by models/convert.py (only load pickles you wrote);
    - else seeded random weights from ``seed`` (a torch.Generator on the
      device)."""
    device = resolve_device(device)
    model = LlamaModel(model_config(llm_config), device=device)
    params = weights(llm_config)
    if isinstance(params, SeededParams):
        init_params(model, torch.Generator(device=device).manual_seed(
            params.seed))
    else:
        load_params(model, params)
    return model, dict(model.state_dict())


def model_config(llm_config: Dict[str, Any]) -> LlamaConfig:
    model_cfg = llm_config.get("model_config") or {}
    preset = llm_config.get("model", "tiny")
    if preset == "tiny":
        return LlamaConfig.tiny(**model_cfg)
    if preset == "llama3-8b":
        return LlamaConfig.llama3_8b()
    return LlamaConfig(**model_cfg)


def weights(llm_config: Dict[str, Any]):
    """The converted state dict of ``params_path`` (numpy, on the host), or
    the seed's ``SeededParams``."""
    params_path = llm_config.get("params_path")
    if params_path:
        with open(params_path, "rb") as f:
            return convert_params(pickle.load(f))
    return SeededParams(int(llm_config.get("seed", 0)))


def rank_devices(device: torch.device, n: int) -> List[torch.device]:
    """The devices of n TP ranks that follow ``device``: the CPU's for CPU
    ranks; on CUDA, rank r on card r modulo the card count."""
    if device.type == "cpu":
        return [device] * n
    count = torch.cuda.device_count()
    return [torch.device("cuda", r % count) for r in range(n)]


class LLMServer:
    """One engine replica behind a thread.

    ``tensor_parallel_size=N`` builds ``create_mesh({"tensor": N})`` over N
    rank devices that follow ``device`` (``rank_devices``); a port ``Mesh``
    under "mesh" is taken as given. The ranks' backend is "tp_backend":
    NCCL by default, gloo for CPU ranks; ranks that share a card need
    "gloo" named. Each rank draws or loads its shard of the weights itself
    (the caller holds none). ``close()`` stops the engine thread and the
    ranks."""

    def __init__(self, llm_config: Dict[str, Any], device=None):
        device = resolve_device(device)
        eng_cfg = EngineConfig(**(llm_config.get("engine_config") or {}))
        mesh = llm_config.get("mesh")
        tp = int(llm_config.get("tensor_parallel_size") or 1)
        if mesh is None and tp > 1:
            mesh = create_mesh({"tensor": tp},
                               devices=rank_devices(device, tp))
        if mesh is not None and mesh.size > 1:
            self.model = LlamaModel(model_config(llm_config), device="meta")
            self.params = None
            self.engine = LLMEngine(self.model, weights(llm_config), eng_cfg,
                                    mesh=mesh,
                                    tp_backend=llm_config.get("tp_backend"))
        else:
            self.model, self.params = load_model_and_params(llm_config,
                                                            device)
            # The model already holds its weights: the engine loads nothing.
            self.engine = LLMEngine(self.model, None, eng_cfg, device=device)
        self._failed: Optional[BaseException] = None
        self._queues: Dict[str, "queue.Queue"] = {}
        self._lock = threading.Lock()
        # Held by the engine thread while it moves pending requests into
        # the engine, and by paused().
        self._admission = threading.Lock()
        self._pending: "queue.Queue" = queue.Queue()
        self._aborts: "queue.Queue" = queue.Queue()
        self._running = True
        self._thread = threading.Thread(target=self._engine_loop,
                                        daemon=True, name="llm-engine")
        self._thread.start()

    # ------------------------------------------------------------------
    def _engine_loop(self) -> None:
        while self._running:
            moved = False
            with self._admission:
                while True:
                    try:
                        req = self._pending.get_nowait()
                    except queue.Empty:
                        break
                    self.engine.add_request(req)
                    moved = True
            while True:
                try:
                    rid = self._aborts.get_nowait()
                except queue.Empty:
                    break
                self.engine.finish_request(rid)
            if not self.engine.has_work():
                time.sleep(0.005 if moved else 0.01)
                continue
            try:
                outputs = self.engine.step()
            except Exception as e:
                logger.exception("engine step failed")
                with self._lock:
                    if isinstance(e, RankError):
                        # The ranks are gone: no later step can run.
                        self._failed = e
                        self._running = False
                    for q in self._queues.values():
                        q.put(("error", str(e)))
                    self._queues.clear()
                continue
            for so in outputs:
                with self._lock:
                    q = self._queues.get(so.request_id)
                if q is not None:
                    q.put(("token", so))

    @contextlib.contextmanager
    def paused(self):
        """Hold the engine thread before its next admission until the
        block exits. Requests that other threads submit meanwhile reach the
        engine together, as one admission wave (one batched prefill).
        ``generate`` blocks for its tokens, so calling it from the thread
        that holds the pause waits forever."""
        with self._admission:
            yield

    def shutdown(self, timeout: float = 30.0) -> None:
        """Stop the engine thread (after its current step)."""
        self._running = False
        self._thread.join(timeout)

    def close(self, timeout: float = 30.0) -> None:
        """Stop the engine thread, then the engine's rank processes:
        each destroys its process group and exits, and any left after the
        runner's deadline is killed."""
        self.shutdown(timeout)
        self.engine.close()

    # ------------------------------------------------------------------
    def generate(self, prompt_ids: List[int], max_tokens: int = 64,
                 temperature: float = 0.0,
                 stop_token: Optional[int] = None,
                 lora_id: str = "", top_p: float = 1.0, top_k: int = 0,
                 seed: Optional[int] = None,
                 logprobs: int = 0) -> Iterator[Dict[str, Any]]:
        """Streaming generation — one dict per token. lora_id selects a
        loaded adapter. Closing the generator early (stop string matched,
        client gone) aborts the request in the engine so its slot stops
        burning decode steps."""
        rid = uuid.uuid4().hex[:12]
        q: "queue.Queue" = queue.Queue()
        with self._lock:
            if self._failed is not None:
                raise RuntimeError(f"engine failed: {self._failed}")
            self._queues[rid] = q
        t0 = time.perf_counter()
        self._pending.put(Request(rid, list(prompt_ids),
                                  max_tokens=max_tokens,
                                  temperature=temperature,
                                  stop_token=stop_token,
                                  lora_id=lora_id, top_p=top_p,
                                  top_k=top_k, seed=seed,
                                  logprobs=logprobs))
        first = True
        finished = False
        try:
            while True:
                item = q.get(timeout=600)
                if item[0] == "error":
                    raise RuntimeError(f"engine failed: {item[1]}")
                _, so = item
                out = {"token": int(so.token)}
                if so.logprob is not None:
                    out["logprob"] = so.logprob
                    out["top_logprobs"] = so.top_logprobs
                if first:
                    out["ttft_s"] = time.perf_counter() - t0
                    first = False
                finished = so.finished
                yield out
                if finished:
                    return
        finally:
            if not finished:
                self._aborts.put(rid)
            with self._lock:
                self._queues.pop(rid, None)

    def generate_all(self, prompt_ids: List[int], max_tokens: int = 64,
                     temperature: float = 0.0,
                     stop_token: Optional[int] = None,
                     lora_id: str = "", top_p: float = 1.0,
                     top_k: int = 0, seed: Optional[int] = None,
                     logprobs: int = 0) -> Dict[str, Any]:
        """Unary variant: returns all tokens at once."""
        toks = []
        lps: List[Any] = []
        tops: List[Any] = []
        ttft = None
        for item in self.generate(prompt_ids, max_tokens, temperature,
                                  stop_token, lora_id, top_p, top_k,
                                  seed, logprobs):
            toks.append(item["token"])
            if "logprob" in item:
                lps.append(item["logprob"])
                tops.append(item["top_logprobs"])
            ttft = ttft if ttft is not None else item.get("ttft_s")
        out = {"tokens": toks, "ttft_s": ttft}
        if lps:
            out["logprobs"] = lps
            out["top_logprobs"] = tops
        return out

    def load_lora(self, name: str, adapter: Dict[str, Any],
                  scale: float = 1.0) -> int:
        """Install a LoRA adapter into the engine's banks."""
        return self.engine.load_lora(name, adapter, scale)

    def stats(self) -> Dict[str, Any]:
        return {
            "running": self.engine.num_running(),
            "waiting": len(self.engine.waiting),
            # submitted, not yet moved into the engine by its thread
            "pending": self._pending.qsize(),
            "free_pages": self.engine.allocator.num_free,
        }

    def check_health(self) -> bool:
        return True
