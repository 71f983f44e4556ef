"""Batch LLM inference. Port of ray_tpu/llm/_internal/batch.py.

Shape: preprocess (stateless map) → engine stage (stateful actor pool, one
engine per actor, continuous batching WITHIN each block) → postprocess.

Input rows carry token ids in `prompt_ids` (a list/array per row), and may
carry a per-row `max_tokens`. Output rows gain `generated_ids` and
`num_generated`. Tokenization is the caller's preprocess job.

`Processor` duck-types the dataset: it calls `map` and `map_batches` with
the Data API's arguments and imports no Data, which waits for the copy of
the runtime (ROADMAP Queue 1 item 5). `_EngineStage` is a plain callable
class and runs on a dict of numpy columns without it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.llm._internal.engine import EngineConfig, LLMEngine, Request
from ray_tpu_torch.llm._internal.server import load_model_and_params
from ray_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class ProcessorConfig:
    llm_config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    batch_size: int = 32
    concurrency: int = 1  # engine-stage actor pool size
    num_gpus: float = 0.0  # per engine actor (the reference's num_tpus)
    max_tokens: int = 32  # default generation budget per row
    temperature: float = 0.0
    stop_token: Optional[int] = None


def _object_column(values: List[Any]) -> np.ndarray:
    """A 1-D object column of per-row arrays, even when every row has the
    same length: a dense (n, k) column would not concatenate with a ragged
    block downstream."""
    arr = np.empty(len(values), dtype=object)
    arr[:] = values
    return arr


class _EngineStage:
    """Callable class run on Data's actor pool: one engine per actor, on
    ``device`` (the card unless the caller names one)."""

    def __init__(self, cfg: ProcessorConfig, device=None):
        device = resolve_device(device)
        self.cfg = cfg
        model, _ = load_model_and_params(cfg.llm_config, device)
        eng_cfg = EngineConfig(
            **(cfg.llm_config.get("engine_config") or {}))
        # The model already holds its weights: the engine loads nothing.
        self.engine = LLMEngine(model, None, eng_cfg, device=device)

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        prompts = batch["prompt_ids"]
        n = len(prompts)
        max_tokens = batch.get("max_tokens")
        outputs: Dict[int, list] = {i: [] for i in range(n)}
        # Continuous batching within the block: the engine admits from its
        # waiting queue as slots free up; collect until every row finishes.
        for i in range(n):
            self.engine.add_request(Request(
                request_id=str(i),
                prompt_ids=[int(t) for t in prompts[i]],
                max_tokens=int(max_tokens[i]) if max_tokens is not None
                else self.cfg.max_tokens,
                temperature=self.cfg.temperature,
                stop_token=self.cfg.stop_token,
            ))
        done = 0
        while done < n:
            for out in self.engine.step():
                i = int(out.request_id)
                outputs[i].append(out.token)
                if out.finished:
                    done += 1
        out_batch = dict(batch)
        out_batch["generated_ids"] = _object_column(
            [np.array(outputs[i], np.int32) for i in range(n)])
        out_batch["num_generated"] = np.array(
            [len(outputs[i]) for i in range(n)], np.int64)
        return out_batch


class Processor:
    """ds → ds pipeline. ``device`` reaches each engine stage through
    ``fn_constructor_kwargs``; the default None puts each stage's engine on
    the card (``resolve_device``), never on the CPU unless named."""

    def __init__(self, config: ProcessorConfig,
                 preprocess: Optional[Callable] = None,
                 postprocess: Optional[Callable] = None, device=None):
        self.config = config
        self.preprocess = preprocess
        self.postprocess = postprocess
        self.device = device

    def __call__(self, ds):
        cfg = self.config
        if self.preprocess is not None:
            ds = ds.map(self.preprocess)
        ds = ds.map_batches(
            _EngineStage,
            batch_size=cfg.batch_size,
            concurrency=cfg.concurrency,
            num_gpus=cfg.num_gpus,
            fn_constructor_args=(cfg,),
            fn_constructor_kwargs={"device": self.device},
        )
        if self.postprocess is not None:
            ds = ds.map(self.postprocess)
        return ds


def build_llm_processor(config: ProcessorConfig,
                        preprocess: Optional[Callable] = None,
                        postprocess: Optional[Callable] = None,
                        device=None) -> Processor:
    return Processor(config, preprocess, postprocess, device)
