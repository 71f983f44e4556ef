"""Entry point of the port's cacheless Llama forward (counterpart of
__graft_entry__.entry)."""

from __future__ import annotations

import dataclasses

import torch

from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel, init_params
from ray_tpu_torch.utils.device import resolve_device


def entry(device=None):
    """(fn, example_args): a Llama forward with flash attention (K1 on the
    card) on the tiny config, batch 2 × 256 tokens, seeded weights."""
    device = resolve_device(device)
    cfg = dataclasses.replace(LlamaConfig.tiny(), attention_impl="flash")
    model = LlamaModel(cfg, device=device)
    init_params(model, torch.Generator(device=device).manual_seed(0))
    ids = torch.zeros((2, 256), dtype=torch.int32, device=device)
    params = {k: v.detach() for k, v in model.named_parameters()}

    def forward(params, input_ids):
        with torch.no_grad():
            return torch.func.functional_call(model, params, (input_ids,))

    return forward, (params, ids)
