"""ray_tpu_torch.llm — LLM serving on the port (counterpart of
ray_tpu/llm): a continuous-batching engine over a paged KV cache
(_internal/engine.py, _internal/paged.py) and the LLMServer that hosts one
engine replica. The Serve deployment, the OpenAI app, batch inference and
the tokenizer are not ported yet."""

from ray_tpu_torch.llm._internal.engine import (
    EngineConfig,
    LLMEngine,
    Request,
    StepOutput,
)
from ray_tpu_torch.llm._internal.paged import (
    PagedCacheConfig,
    paged_attention,
    paged_gather,
    paged_write,
)
from ray_tpu_torch.llm._internal.server import LLMServer, load_model_and_params

__all__ = [
    "EngineConfig",
    "LLMEngine",
    "LLMServer",
    "PagedCacheConfig",
    "Request",
    "StepOutput",
    "load_model_and_params",
    "paged_attention",
    "paged_gather",
    "paged_write",
]
