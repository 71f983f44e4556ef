"""Paged KV cache primitives. Port of ray_tpu/llm/_internal/paged.py.

Layout as in the JAX module:
- pages:      [kv_heads, num_pages, page_size, head_dim] per layer,
- page_table: [max_seqs, max_pages_per_seq] int32 (host-managed allocator),
- seq_lens:   [max_seqs] int32.

Two differences from the JAX module, both about PyTorch:
- Pages update IN PLACE (``paged_write`` writes into the tensor it is given
  and returns it); JAX got the same effect by donating the cache.
- The JAX scatter sends masked lanes out of bounds and drops them. A torch
  scatter would raise or device-assert, so masked lanes are filtered out
  before the write.

Decode (one query token per sequence) on a CUDA tensor runs K4
(csrc/paged_decode.cu), the counterpart of the Pallas
``_paged_decode_kernel``; everything else is plain PyTorch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from ray_tpu_torch import native
from ray_tpu_torch.ops.attention import exp_f32

NEG_INF = -1e30


@dataclasses.dataclass
class PagedCacheConfig:
    num_pages: int
    page_size: int = 16
    max_seqs: int = 8
    max_pages_per_seq: int = 64

    @property
    def max_context(self) -> int:
        return self.page_size * self.max_pages_per_seq


def init_paged_cache(cfg: PagedCacheConfig, num_layers: int, kv_heads: int,
                     head_dim: int, dtype=torch.bfloat16, device=None):
    """Per-layer (k_pages, v_pages) list, layout [HK, P, ps, D]."""
    shape = (kv_heads, cfg.num_pages, cfg.page_size, head_dim)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(num_layers)]


def to_device(x, device: torch.device) -> torch.Tensor:
    """A host array (or CPU tensor) copied to ``device`` now. The copy is
    taken at call time, so the caller may mutate its buffer right after;
    to a CUDA device it goes through a fresh pinned buffer without a
    stream synchronize."""
    t = torch.as_tensor(x)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


def write_lanes(mask: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Flat indices of the enabled lanes of a [B, S] write mask, on
    ``device``. A mask built on the host costs no device sync here."""
    lanes = torch.nonzero(mask.reshape(-1)).reshape(-1)
    return lanes if lanes.device == device else to_device(lanes, device)


def paged_write_lanes(pages: torch.Tensor, new_kv: torch.Tensor,
                      page_table: torch.Tensor, positions: torch.Tensor,
                      lanes: torch.Tensor) -> torch.Tensor:
    """``paged_write`` with the enabled lanes given as flat indices (see
    ``write_lanes``), so a model computes them once for all its layers."""
    ps = pages.shape[2]
    b, s, hk, d = new_kv.shape
    pos = positions.reshape(-1).index_select(0, lanes).long()
    rows = torch.div(lanes, s, rounding_mode="floor")
    page_idx = page_table.long()[rows, torch.div(pos, ps,
                                                 rounding_mode="floor")]
    values = new_kv.reshape(b * s, hk, d).index_select(0, lanes)
    pages[:, page_idx, pos % ps] = values.transpose(0, 1).to(pages.dtype)
    return pages


def paged_write(pages: torch.Tensor, new_kv: torch.Tensor,
                page_table: torch.Tensor, positions: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Scatter new_kv [B,S,HK,D] into pages [HK,P,ps,D], in place.

    positions [B,S]: absolute token index of each entry; mask [B,S]: write
    enable (False lanes are not written)."""
    positions = torch.broadcast_to(positions, mask.shape)
    return paged_write_lanes(pages, new_kv, page_table, positions,
                             write_lanes(mask, pages.device))


def paged_gather(pages: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """[HK,P,ps,D] + [B,MP] -> [B, MP*ps, HK, D] (each row's full context
    window, garbage beyond seq_len — callers mask)."""
    b, mp = page_table.shape
    hk, _, ps, d = pages.shape
    gathered = pages[:, page_table.long()]  # [HK,B,MP,ps,D]
    return gathered.reshape(hk, b, mp * ps, d).permute(1, 2, 0, 3)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    q_positions: torch.Tensor, seq_lens: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention of q [B,S,H,D] over paged KV (causal by absolute position).

    q_positions [B,S]: absolute position of each query token; keys at
    absolute positions <= q_position and < seq_len are visible. Decode
    (S == 1) on CUDA runs K4, which reads only each sequence's real pages;
    the gather path below materializes [B, max_ctx] keys (prefill, and
    decode on the CPU, as the JAX module does off the TPU)."""
    if q.shape[1] == 1 and q.is_cuda:
        return paged_attention_decode_kernel(
            q, k_pages, v_pages, page_table, seq_lens, scale=scale)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    h, hk = q.shape[2], k_pages.shape[0]
    k = paged_gather(k_pages, page_table)  # [B,C,HK,D]
    v = paged_gather(v_pages, page_table)
    if hk != h:
        k = k.repeat_interleave(h // hk, dim=2)
        v = v.repeat_interleave(h // hk, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    k_pos = torch.arange(k.shape[1], device=q.device)[None, None, :]
    visible = (k_pos <= q_positions[:, :, None]) & (
        k_pos < seq_lens[:, None, None])
    logits = torch.where(visible[:, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# Decode attention: plain version and K4
# ---------------------------------------------------------------------------
def paged_decode_plain(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_table: torch.Tensor,
                       seq_lens: torch.Tensor,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of K4: q [B,1,H,D] over the keys at positions
    < seq_len (clamped to the page-table row's capacity) of each
    sequence's pages. As the Pallas kernel does, P is rounded to v's dtype
    before P·V while the denominator sums the unrounded P, so a bf16 decode
    matches it bit for bit where it takes one chunk (MP <= 16). A sequence
    with seq_len 0 gets zeros, as in the kernel."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    h, hk = q.shape[2], k_pages.shape[0]
    k = paged_gather(k_pages, page_table)  # [B,C,HK,D]
    v = paged_gather(v_pages, page_table)
    visible = (torch.arange(k.shape[1], device=q.device)[None, :]
               < seq_lens.long()[:, None])  # [B,C]
    v = torch.where(visible[:, :, None, None], v, torch.zeros_like(v))
    k = k.repeat_interleave(h // hk, dim=2)
    v = v.repeat_interleave(h // hk, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = torch.where(visible[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = exp_f32(s - m) * visible[:, None, None, :]
    denom = p.sum(dim=-1).clamp_min(1e-30)  # [B,H,1]
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return (acc / denom.transpose(1, 2)[..., None]).to(q.dtype)


_DECODE_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                + [ctypes.c_float, ctypes.c_void_p])
# K4's grid (csrc/paged_decode.cu): a block takes the query heads of one kv
# group as the rows of one 16-row tile, and one split (consecutive pages) of
# one sequence's page-table row, which its 4 warps walk in 16-key tiles.
_DECODE_ROWS = 16
# Measured on the H100 (chip_smoke.py, phase k4_splits): one wave of about
# 2 blocks an SM streams long contexts fastest, and a row short enough for
# one split skips the merge's round trip.
_DECODE_MIN_SPLIT_KEYS = 256
_DECODE_BLOCKS_PER_SM = 2
_DECODE_MAX_D = 256
# Per device: the counters with which K4's blocks find the last split of a
# row; each launch leaves them at 0.
_decode_counters: Dict[torch.device, torch.Tensor] = {}


def decode_split(b: int, hk: int, hg: int, mp: int, ps: int,
                 num_sms: int) -> Tuple[int, int]:
    """K4's split of a page-table row: (pages a split, splits a row).

    A pure function of the shapes and the SM count: it never reads
    seq_lens' values, which would stall the stream on a device sync (and
    break the capture of a decode window into a CUDA graph). The row's MP
    pages are cut so that the grid has about ``_DECODE_BLOCKS_PER_SM``
    blocks an SM over all (sequence, kv head, 16-head tile)s, with at least
    ``_DECODE_MIN_SPLIT_KEYS`` keys a split; splits past a sequence's
    seq_len return at once on the card."""
    row_blocks = b * hk * -(-hg // _DECODE_ROWS)
    want = max(1, _DECODE_BLOCKS_PER_SM * num_sms // row_blocks)
    pps = min(mp, max(-(-_DECODE_MIN_SPLIT_KEYS // ps), -(-mp // want)))
    return pps, -(-mp // pps)


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """At least n int32 counters on ``device``, zeroed when made."""
    c = _decode_counters.get(device)
    if c is None or c.numel() < n:
        c = torch.zeros(n, dtype=torch.int32, device=device)
        _decode_counters[device] = c
    return c


def paged_attention_decode_kernel(
        q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
        page_table: torch.Tensor, seq_lens: torch.Tensor,
        scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention q [B,1,H,D] over paged KV without materializing the
    gathered context. On CUDA tensors this launches K4 once
    (csrc/paged_decode.cu: each row's context split across blocks as
    ``decode_split`` says, the splits merged by the row's last block); on
    CPU tensors it is ``paged_decode_plain``. Any H % HK == 0, and D up to
    256 in whole 16-byte rows. Launches on one device share its counters,
    so they run in one stream."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        return paged_decode_plain(q, k_pages, v_pages, page_table, seq_lens,
                                  scale=scale)
    b, s, h, d = q.shape
    hk, num_pages, ps, _ = k_pages.shape
    if s != 1:
        raise ValueError("decode kernel expects one query token per sequence")
    if not (q.dtype == k_pages.dtype == v_pages.dtype) or q.dtype not in (
            torch.bfloat16, torch.float32):
        raise TypeError(f"paged decode kernel takes bf16 or f32, got "
                        f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if k_pages.shape != v_pages.shape or k_pages.shape[3] != d:
        raise ValueError("k/v pages shape mismatch")
    if hk < 1 or h % hk:
        raise ValueError(f"paged decode kernel takes a whole number of query "
                         f"heads per kv head, got H={h} HK={hk}")
    if d > _DECODE_MAX_D or (d * q.element_size()) % 16:
        raise ValueError(f"paged decode kernel takes head_dim up to "
                         f"{_DECODE_MAX_D} in whole 16-byte rows, got {d}")
    if page_table.dim() != 2 or page_table.shape[0] != b or \
            page_table.shape[1] < 1 or seq_lens.shape != (b,) or ps < 1:
        raise ValueError("page_table must be [B,MP] with MP >= 1, seq_lens "
                         "[B], and pages at least one slot")
    page_table = page_table.to(torch.int32).contiguous()
    seq_lens = seq_lens.to(torch.int32).contiguous()
    q, k_pages, v_pages = q.contiguous(), k_pages.contiguous(), \
        v_pages.contiguous()
    for t in (q, k_pages, v_pages, page_table, seq_lens):
        if not t.is_cuda or t.data_ptr() % 16:
            raise ValueError("paged decode kernel takes 16-byte aligned "
                             "CUDA tensors")
    hg, mp = h // hk, page_table.shape[1]
    pps, splits = decode_split(
        b, hk, hg, mp, ps,
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    out = torch.empty_like(q)
    # Each split's partial sums [B,HK,splits,Hg,D] and (max, denominator).
    acc_ws = torch.empty(b * hk * splits * hg * d, dtype=torch.float32,
                         device=q.device)
    ml_ws = torch.empty(b * hk * splits * hg * 2, dtype=torch.float32,
                        device=q.device)
    counters = _counters(q.device, b * hk * -(-hg // _DECODE_ROWS))
    name = ("paged_decode_bf16" if q.dtype == torch.bfloat16
            else "paged_decode_f32")
    fn = native.function("paged_decode", name, _DECODE_ARGS)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
             acc_ws.data_ptr(), ml_ws.data_ptr(), counters.data_ptr(),
             b, hk, hg, num_pages, ps, mp, d, pps, splits, scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    native.check(err, name)
    paged_attention_decode_kernel.launches += 1
    return out


paged_attention_decode_kernel.launches = 0


class PageAllocator:
    """Host-side page bookkeeping with refcounts (the scheduler's half of
    paged attention; reference: vLLM BlockManager). A page may appear in
    several slots' page lists at once (prefix sharing) and is returned to
    the free list only when its last holder lets go. Shared pages are only
    ever FULL prompt pages, so no holder writes into them — sharing needs
    no copy-on-write (divergent suffixes land in fresh pages by position
    arithmetic)."""

    def __init__(self, cfg: PagedCacheConfig):
        self.cfg = cfg
        self.free = list(range(cfg.num_pages))
        # slot -> list of page ids
        self.slot_pages: List[List[int]] = [[] for _ in range(cfg.max_seqs)]
        self.ref: dict = {}  # page id -> holder count

    def pages_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.cfg.page_size)

    def can_allocate(self, num_tokens: int) -> bool:
        return len(self.free) >= self.pages_needed(num_tokens)

    def share(self, slot: int, pages: List[int]) -> None:
        """Append already-allocated pages to slot's list (prefix reuse)."""
        for p in pages:
            self.ref[p] = self.ref.get(p, 0) + 1
        self.slot_pages[slot].extend(pages)

    def adopt(self, slot: int, pages: List[int]) -> None:
        """Like share(), but the caller already holds a ref per page (a
        pin taken with retain()) and transfers it to the slot."""
        self.slot_pages[slot].extend(pages)

    def retain(self, page: int) -> None:
        self.ref[page] = self.ref.get(page, 0) + 1

    def unref(self, page: int) -> None:
        n = self.ref.get(page, 0) - 1
        if n <= 0:
            self.ref.pop(page, None)
            self.free.append(page)
        else:
            self.ref[page] = n

    def ensure(self, slot: int, num_tokens: int) -> List[int]:
        """Grow slot's page list to cover num_tokens. Returns the page list.
        Raises if out of pages (caller preempts/queues/evicts)."""
        need = self.pages_needed(num_tokens)
        pages = self.slot_pages[slot]
        while len(pages) < need:
            if not self.free:
                raise MemoryError("out of KV cache pages")
            p = self.free.pop()
            self.ref[p] = self.ref.get(p, 0) + 1
            pages.append(p)
        return pages

    def release(self, slot: int) -> None:
        for p in self.slot_pages[slot]:
            self.unref(p)
        self.slot_pages[slot] = []

    @property
    def num_free(self) -> int:
        return len(self.free)


class PrefixCache:
    """Hash-chained full-page prefix index (reference: the prefix reuse
    vLLM provides under ray.llm's prefix-aware router — here native).

    Key for page i of a prompt: sha1(key[i-1] || tokens[i*ps:(i+1)*ps]),
    so a lookup can only match a contiguous prefix run. The cache holds
    one allocator ref per indexed page; eviction (LRU) drops entries whose
    pages no live sequence shares."""

    def __init__(self, allocator: PageAllocator):
        from collections import OrderedDict

        self._alloc = allocator
        self._entries: "OrderedDict[bytes, int]" = OrderedDict()
        self.lookups = 0
        self.hit_pages = 0

    @staticmethod
    def page_digests(prompt_ids, page_size: int) -> List[bytes]:
        import hashlib

        import numpy as np

        n_full = len(prompt_ids) // page_size
        digests = []
        prev = b""
        arr = np.asarray(prompt_ids[:n_full * page_size], np.int32)
        for i in range(n_full):
            h = hashlib.sha1(prev)
            h.update(arr[i * page_size:(i + 1) * page_size].tobytes())
            prev = h.digest()
            digests.append(prev)
        return digests

    def match(self, digests: List[bytes]) -> List[int]:
        """Longest cached prefix run → page ids (refreshes LRU order)."""
        self.lookups += 1
        pages = []
        for d in digests:
            page = self._entries.get(d)
            if page is None:
                break
            self._entries.move_to_end(d)
            pages.append(page)
        self.hit_pages += len(pages)
        return pages

    def insert(self, digests: List[bytes], pages: List[int]) -> None:
        for d, p in zip(digests, pages):
            if d not in self._entries:
                self._alloc.retain(p)
                self._entries[d] = p

    def evict(self, n_pages: int) -> int:
        """Free up to n_pages cache-only pages (LRU first). Pages still
        shared by running sequences stay indexed."""
        freed = 0
        for d in list(self._entries):
            if freed >= n_pages:
                break
            p = self._entries[d]
            if self._alloc.ref.get(p, 0) == 1:  # only the cache holds it
                del self._entries[d]
                self._alloc.unref(p)
                freed += 1
        return freed

    def __len__(self) -> int:
        return len(self._entries)
