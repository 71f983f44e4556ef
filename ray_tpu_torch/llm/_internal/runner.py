"""The device half of the serving engine (llm/_internal/engine.py).

``ModelRunner`` holds the model and its weights, the paged KV cache, the
per-slot sampling generators and the LoRA banks, and runs one dispatch at a
time: a batched prefill, a decode window of K steps, or a cacheless forward,
sampling included. Its inputs are the host arrays the scheduler builds (or,
for a chained decode window, the previous window's device outputs), so the
same object serves the engine in its own process and each rank process of an
engine over a mesh (llm/_internal/tp.py). A rank runs over its shard of the
model (``model.mesh``, ``model.rank``): only rank 0 samples, and at every
decode step its tokens are broadcast to the other ranks, whose next step
reads them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.llm._internal.paged import (
    PagedCacheConfig,
    init_paged_cache,
    to_device,
)
from ray_tpu_torch.models.convert import is_qleaf
from ray_tpu_torch.models.llama import (
    init_params,
    load_params,
    shard_params,
)
from ray_tpu_torch.models.quant import WeightsAtUse, tree_to
from ray_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SeededParams:
    """Weights that ``init_params`` draws from ``seed`` on the device that
    holds them (a mesh rank draws each full parameter and keeps its slice)."""
    seed: int


class ModelRunner:
    """``params``: a state dict (arrays or tensors; a mesh shard takes its
    slice of a full one), ``SeededParams``, or None to use the model's own
    weights. With ``param_transform`` the runner keeps ``params`` as given
    on the device and runs every forward on ``param_transform(params)`` (one
    module's sub-tree at a time for a quantized tree, ``WeightsAtUse``);
    ``model``'s own parameters are then not read. Runs on ``device``: the
    card unless the caller names one."""

    def __init__(self, model, params, cfg, cache_cfg: PagedCacheConfig,
                 param_transform: Optional[Callable] = None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.param_transform = param_transform
        self.params = None
        self._weights: Optional[WeightsAtUse] = None
        mesh = getattr(model, "mesh", None)
        # Whether this runner is one of a mesh's rank processes.
        self.ranked = mesh is not None and mesh.size > 1
        self.rank = model.rank if self.ranked else 0
        if param_transform is not None:
            self.model = model
            self.params = tree_to(params, self.device)
            if any(is_qleaf(v) for v in self.params.values()):
                self._weights = WeightsAtUse(self.params, param_transform)
        else:
            self.model = model.to(self.device)
            if isinstance(params, SeededParams):
                init_params(self.model, torch.Generator(
                    device=self.device).manual_seed(params.seed))
            elif params is not None:
                load_params(self.model, shard_params(self.model, params))
        mcfg = model.cfg
        self.caches = init_paged_cache(
            cache_cfg, mcfg.num_layers, model.kv_heads, mcfg.head_dim,
            mcfg.dtype, device=self.device)
        # Per-slot generators (seeded at admission), on the device.
        self._gens = [torch.Generator(device=self.device).manual_seed(i)
                      for i in range(cfg.max_seqs)]
        # LoRA banks (slot 0 = zero adapter = base model).
        self.lora_banks: Optional[Dict[str, Any]] = None
        if cfg.lora_rank > 0:
            self.lora_banks = self._init_lora_banks()

    @property
    def samples(self) -> bool:
        """Whether this runner samples tokens (every runner but the ranks
        of a mesh other than 0)."""
        return self.rank == 0

    def seed(self, slot: int, seed: int) -> None:
        self._gens[slot].manual_seed(seed)

    # ------------------------------------------------------------------
    # LoRA multiplexing
    # ------------------------------------------------------------------
    def _init_lora_banks(self) -> Dict[str, Any]:
        cfg, mcfg = self.cfg, self.model.cfg
        K = cfg.max_loras + 1  # + the zero adapter
        r = cfg.lora_rank
        out_dims = {
            "q_proj": mcfg.num_heads * mcfg.head_dim,
            "k_proj": mcfg.num_kv_heads * mcfg.head_dim,
            "v_proj": mcfg.num_kv_heads * mcfg.head_dim,
            "o_proj": mcfg.hidden_size,
        }
        in_dims = {"q_proj": mcfg.hidden_size, "k_proj": mcfg.hidden_size,
                   "v_proj": mcfg.hidden_size,
                   "o_proj": mcfg.num_heads * mcfg.head_dim}
        zeros = lambda *s: torch.zeros(s, dtype=torch.float32,
                                       device=self.device)
        banks: Dict[str, Any] = {}
        for i in range(mcfg.num_layers):
            banks[f"layers_{i}"] = {
                t: {"a": zeros(K, r, in_dims[t]),
                    "b": zeros(K, out_dims[t], r),
                    # per-SLOT scale: adapters share the bank, so a scalar
                    # here would let the last load rescale every other
                    # adapter's delta
                    "scale": torch.ones(K, dtype=torch.float32,
                                        device=self.device)}
                for t in cfg.lora_targets}
        return banks

    def load_lora(self, slot: int, adapter: Dict[str, Any],
                  scale: float) -> None:
        """Install adapter weights into bank slot ``slot``."""
        for layer, projs in adapter.items():
            bank_layer = self.lora_banks.get(layer)
            if bank_layer is None:
                continue
            for proj, (a, b) in projs.items():
                if proj not in bank_layer:
                    continue
                bank = bank_layer[proj]
                bank["a"][slot] = torch.as_tensor(np.asarray(a, np.float32))
                bank["b"][slot] = torch.as_tensor(np.asarray(b, np.float32))
                bank["scale"][slot] = float(scale)

    # ------------------------------------------------------------------
    # Device steps
    # ------------------------------------------------------------------
    def _forward(self, *args, **kwargs):
        if self.param_transform is None:
            return self.model(*args, **kwargs)
        if self._weights is not None:
            return self.model(*args, weights=self._weights, **kwargs)
        return torch.func.functional_call(
            self.model, self.param_transform(self.params), args, kwargs)

    def _sample(self, logits, temps, top_ps, top_ks, draws, rich: bool,
                want_lp: bool):
        """Sample one token per row of logits [n,V] (f32, device).

        temps/top_ps/top_ks are [n] device tensors; ``draws`` lists the
        (row, slot) pairs that sample (temperature > 0): each draws its
        noise from its slot's generator, so only those generators advance.
        rich=True applies top-k then top-p truncation (a [n,V] sort).
        Returns (toks [n] int32, lp) where lp is None or (chosen_logp [n],
        top_vals [n,L], top_ids [n,L])."""
        toks = logits.argmax(dim=-1)
        if draws:
            scaled = logits / temps.clamp_min(1e-3)[:, None]
            if rich:
                V = logits.shape[-1]
                # top-k: drop strictly below the k-th largest (k=0 off)
                desc = scaled.sort(dim=-1, descending=True).values
                kth = desc.gather(
                    1, (top_ks.long() - 1).clamp(0, V - 1)[:, None])
                scaled = torch.where(
                    (top_ks[:, None] > 0) & (scaled < kth),
                    float("-inf"), scaled)
                # top-p over the surviving mass: keep a token iff the
                # cumulative prob of STRICTLY higher-ranked tokens is
                # still < p (the argmax token always survives)
                desc = scaled.sort(dim=-1, descending=True).values
                probs = torch.softmax(desc, dim=-1)
                cum = probs.cumsum(dim=-1)
                keep = (cum - probs) < top_ps[:, None]
                cutoff = torch.where(keep, desc, float("inf")).amin(
                    dim=-1, keepdim=True)
                scaled = torch.where(scaled >= cutoff, scaled, float("-inf"))
            # Gumbel-max: argmax(scaled + G) samples softmax(scaled).
            gumbel = torch.zeros_like(logits)
            for row, slot in draws:
                u = torch.rand(logits.shape[-1], generator=self._gens[slot],
                               device=self.device)
                gumbel[row] = -torch.log(-torch.log(u))
            toks = torch.where(temps > 0, (scaled + gumbel).argmax(dim=-1),
                               toks)
        toks = toks.to(torch.int32)
        lp = None
        if want_lp:
            # OpenAI logprobs report the UNSCALED model distribution
            logp = torch.log_softmax(logits, dim=-1)
            chosen = logp.gather(1, toks.long()[:, None])[:, 0]
            # Equal values lowest id first, as jax.lax.top_k orders them
            # (so a greedy token heads its alternatives): topk leaves the
            # order of ties open, and bf16 logits tie often.
            L = max(1, self.cfg.max_logprobs)
            top_vals, top_ids = logp.sort(dim=-1, descending=True,
                                          stable=True)
            lp = (chosen, top_vals[:, :L], top_ids[:, :L].to(torch.int32))
        return toks, lp

    @torch.no_grad()
    def decode_window(self, last_tokens, page_table, seq_lens, active,
                      temps, top_ps, top_ks, lora_idx, rich: bool,
                      want_lp: bool):
        """Enqueue K decode steps over all slots. last_tokens/seq_lens [B]
        int32 are host arrays or the device outputs of the previous window;
        page_table [B,MP] and the slots' control state (active, temps,
        top_ps, top_ks, lora_idx [B]) are host arrays, copied now. Returns
        (tokens [K,B], final last_tokens [B], final seq_lens [B], logprob
        arrays or None), on the device; a mesh rank other than 0 returns no
        tokens of its own (None) but the final last_tokens it decoded."""
        B = self.cfg.max_seqs
        K = max(1, self.cfg.decode_steps)
        L = max(1, self.cfg.max_logprobs)
        toks, lens = self._dev(last_tokens), self._dev(seq_lens)
        page_table = self._dev(page_table)
        temps_d, top_ps_d, top_ks_d = (self._dev(temps), self._dev(top_ps),
                                       self._dev(top_ks))
        lora_idx = self._dev(lora_idx)
        # A host mask: the paged writes filter lanes without a device sync.
        write_mask = torch.from_numpy(np.array(active, bool))[:, None]
        draws = [(s, s) for s in range(B) if active[s] and temps[s] > 0]
        out = lps = None
        if self.samples:
            out = torch.zeros((K, B), dtype=torch.int32, device=self.device)
            if want_lp:
                lps = (torch.zeros((K, B), device=self.device),
                       torch.zeros((K, B, L), device=self.device),
                       torch.zeros((K, B, L), dtype=torch.int32,
                                   device=self.device))
        for j in range(K):
            # positions of the NEW token = current length (before write).
            logits, _ = self._forward(
                toks[:, None], positions=lens[:, None], paged_kv=self.caches,
                page_table=page_table, write_mask=write_mask,
                seq_lens=lens + 1, lora=self.lora_banks, lora_idx=lora_idx)
            if self.samples:
                toks, lp = self._sample(logits[:, 0].float(), temps_d,
                                        top_ps_d, top_ks_d, draws, rich,
                                        want_lp)
                out[j] = toks
                if lp is not None:
                    for dst, src in zip(lps, lp):
                        dst[j] = src
            else:
                toks = torch.empty((B,), dtype=torch.int32,
                                   device=self.device)
            if self.ranked:
                dist.broadcast(toks, 0)
            lens = lens + 1
        # Final last_tokens/seq_lens feed the NEXT window's dispatch without
        # a host round trip (pipeline_dispatch).
        return out, toks, lens, lps

    @torch.no_grad()
    def prefill(self, ids, rows, starts, true_lens, temps, top_ps, top_ks,
                slots, lidx, rich: bool, want_lp: bool):
        """Batched prefill: ``nb`` sequences in ONE pass over the weights.
        ids [nb, bucket] = each prompt's SUFFIX from absolute position
        starts[i] (>0 when a cached prefix run was shared into its
        page-table row); causal within each sequence. Host arrays in,
        device tokens out (None, None on a mesh rank other than 0)."""
        nb, bucket = ids.shape
        positions = (self._dev(starts)[:, None]
                     + torch.arange(bucket, device=self.device)[None, :])
        mask = (torch.arange(bucket)[None, :]
                < torch.from_numpy(true_lens)[:, None])
        logits, _ = self._forward(
            self._dev(ids), positions=positions, paged_kv=self.caches,
            page_table=self._dev(rows), write_mask=mask,
            seq_lens=self._dev(starts + true_lens), lora=self.lora_banks,
            lora_idx=self._dev(lidx))
        if not self.samples:
            return None, None
        last = logits[torch.arange(nb, device=self.device),
                      self._dev(true_lens - 1).long()].float()  # [nb, V]
        draws = [(i, int(slots[i])) for i in range(nb) if temps[i] > 0]
        return self._sample(last, self._dev(temps), self._dev(top_ps),
                            self._dev(top_ks), draws, rich, want_lp)

    @torch.no_grad()
    def forward(self, ids) -> torch.Tensor:
        """The cacheless forward's logits [B, S, V] of ids [B, S]."""
        return self._forward(self._dev(ids))

    def _dev(self, x) -> torch.Tensor:
        """Host → device, copied at call time; a tensor already on the
        device (a chained window's outputs) as it is."""
        if isinstance(x, torch.Tensor) and x.device.type == self.device.type:
            return x
        return to_device(x, self.device)


def to_host(toks, lp) -> Tuple[np.ndarray, Optional[Tuple[np.ndarray, ...]]]:
    """A dispatch's device tokens and logprob arrays on the host (blocks
    until the device has them)."""
    return (toks.cpu().numpy(),
            None if lp is None else tuple(a.cpu().numpy() for a in lp))
