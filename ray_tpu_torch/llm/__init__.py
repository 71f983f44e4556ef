"""ray_tpu_torch.llm — LLM serving and batch inference on the port
(counterpart of ray_tpu/llm): a continuous-batching engine over a paged KV
cache (_internal/engine.py, _internal/paged.py), the LLMServer that hosts one
engine replica (tensor- and expert-parallel over rank processes:
_internal/tp.py), the OpenAI-compatible surface over it (OpenAIServer), batch
inference (Processor, whose engine stage runs on a dict of numpy columns)
and the byte-level BPE tokenizer with its chat template.

The two Serve builders, ``build_llm_deployment`` and ``build_openai_app``,
are not ported: they return Serve applications, and Serve is part of the
runtime the port copies last (ROADMAP Queue 1 item 5). Data's actor pool,
which runs ``Processor``'s engine stage in the reference, waits for the
same copy."""

from ray_tpu_torch.llm._internal.batch import (
    Processor,
    ProcessorConfig,
    build_llm_processor,
)
from ray_tpu_torch.llm._internal.engine import (
    EngineConfig,
    LLMEngine,
    Request,
    StepOutput,
)
from ray_tpu_torch.llm._internal.openai import OpenAIServer
from ray_tpu_torch.llm._internal.paged import (
    PagedCacheConfig,
    paged_attention,
    paged_gather,
    paged_write,
)
from ray_tpu_torch.llm._internal.runner import SeededParams
from ray_tpu_torch.llm._internal.server import LLMServer, load_model_and_params
from ray_tpu_torch.llm._internal.tokenizer import (
    ByteBPETokenizer,
    apply_chat_template,
    get_tokenizer,
)

__all__ = [
    "ByteBPETokenizer",
    "EngineConfig",
    "LLMEngine",
    "LLMServer",
    "OpenAIServer",
    "PagedCacheConfig",
    "Processor",
    "ProcessorConfig",
    "Request",
    "SeededParams",
    "StepOutput",
    "apply_chat_template",
    "build_llm_processor",
    "get_tokenizer",
    "load_model_and_params",
    "paged_attention",
    "paged_gather",
    "paged_write",
]
