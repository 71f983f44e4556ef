"""Byte-level BPE tokenizer + chat templating. Port of
ray_tpu/llm/_internal/tokenizer.py, a copy (the port imports nothing of
ray_tpu): the same merges from the same corpus, the same ids, the same JSON
files, so a vocabulary saved by either package loads in the other.

The reference delegates tokenization to HuggingFace tokenizers downloaded at
runtime (python/ray/llm/_internal/serve/deployments/llm/vllm/vllm_models.py
resolves model ids to HF repos). This build is zero-egress, so the tokenizer
is self-contained: a byte-level BPE (GPT-2/llama-3 family algorithm —
operate on a reversible unicode remapping of raw bytes, merge the
highest-rank pair repeatedly) with

- `train()` to learn merges from a corpus (tests train tiny vocabularies),
- JSON save/load for bundled vocabularies,
- `byte_fallback()` — the no-merge tokenizer (256 byte tokens + specials),
  always available, exact roundtrip, used when no vocab file is configured,
- llama-3-style chat templating (`apply_chat_template`).

Encode applies merges with a rank-ordered agenda per word (O(n log n) per
word), words split on a GPT-2-like pretokenization boundary.
"""

from __future__ import annotations

import json
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Special tokens (llama-3 naming; ids placed after the byte/merge vocab).
BOS = "<|begin_of_text|>"
EOS = "<|end_of_text|>"
START_HEADER = "<|start_header_id|>"
END_HEADER = "<|end_header_id|>"
EOT = "<|eot_id|>"
PAD = "<|pad|>"
SPECIAL_TOKENS = (BOS, EOS, START_HEADER, END_HEADER, EOT, PAD)

# GPT-2-style pretokenizer: contractions, letter runs (with one leading
# space), number runs, punctuation runs, whitespace runs.
_PRETOK = re.compile(
    r"'(?:[sdmt]|ll|ve|re)| ?[A-Za-z]+| ?[0-9]+| ?[^\sA-Za-z0-9]+|\s+(?!\S)|\s+"
)


def _byte_to_unicode() -> Dict[int, str]:
    """The reversible byte→printable-unicode map (GPT-2's trick: BPE tables
    store strings, but every byte must be representable)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_B2U = _byte_to_unicode()
_U2B = {u: b for b, u in _B2U.items()}


class ByteBPETokenizer:
    def __init__(self, merges: Sequence[Tuple[str, str]],
                 specials: Sequence[str] = SPECIAL_TOKENS):
        # Base vocab: the 256 byte symbols, ids 0-255 in byte order.
        self._id_of: Dict[str, int] = {
            _B2U[b]: b for b in range(256)}
        self._ranks: Dict[Tuple[str, str], int] = {}
        for a, b in merges:
            self._ranks[(a, b)] = len(self._ranks)
            merged = a + b
            if merged not in self._id_of:
                self._id_of[merged] = len(self._id_of)
        self._specials: Dict[str, int] = {}
        for s in specials:
            self._specials[s] = len(self._id_of) + len(self._specials)
        self._tok_of = {i: t for t, i in self._id_of.items()}
        self._tok_of.update({i: s for s, i in self._specials.items()})
        if specials:
            pat = "|".join(re.escape(s) for s in specials)
            self._special_re = re.compile(f"({pat})")
        else:
            self._special_re = None
        self.merges = list(merges)

    # -- properties ------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return len(self._id_of) + len(self._specials)

    @property
    def bos_id(self) -> int:
        return self._specials[BOS]

    @property
    def eos_id(self) -> int:
        return self._specials[EOS]

    @property
    def eot_id(self) -> int:
        return self._specials[EOT]

    @property
    def pad_id(self) -> int:
        return self._specials[PAD]

    def special_id(self, token: str) -> int:
        return self._specials[token]

    # -- encode / decode -------------------------------------------------
    def encode(self, text: str, *, add_bos: bool = False) -> List[int]:
        ids: List[int] = [self.bos_id] if add_bos else []
        if self._special_re is not None:
            parts = self._special_re.split(text)
        else:
            parts = [text]
        for part in parts:
            if not part:
                continue
            if part in self._specials:
                ids.append(self._specials[part])
                continue
            for word in _PRETOK.findall(part):
                ids.extend(self._encode_word(word))
        return ids

    def _encode_word(self, word: str) -> List[int]:
        sym = [_B2U[b] for b in word.encode("utf-8")]
        if len(sym) > 1 and self._ranks:
            while True:
                best_rank = None
                best_i = -1
                for i in range(len(sym) - 1):
                    r = self._ranks.get((sym[i], sym[i + 1]))
                    if r is not None and (best_rank is None or r < best_rank):
                        best_rank, best_i = r, i
                if best_rank is None:
                    break
                sym[best_i:best_i + 2] = [sym[best_i] + sym[best_i + 1]]
        return [self._id_of[s] for s in sym]

    def decode(self, ids: Iterable[int], *,
               skip_specials: bool = True) -> str:
        out: List[str] = []
        byte_acc: List[int] = []
        for i in ids:
            tok = self._tok_of.get(int(i))
            if tok is None:
                continue
            if tok in self._specials:
                if not skip_specials:
                    if byte_acc:
                        out.append(bytes(byte_acc).decode("utf-8", "replace"))
                        byte_acc = []
                    out.append(tok)
                continue
            byte_acc.extend(_U2B[c] for c in tok)
        if byte_acc:
            out.append(bytes(byte_acc).decode("utf-8", "replace"))
        return "".join(out)

    # -- training --------------------------------------------------------
    @classmethod
    def train(cls, corpus: Iterable[str], vocab_size: int,
              specials: Sequence[str] = SPECIAL_TOKENS
              ) -> "ByteBPETokenizer":
        """Learn merges until vocab_size (= 256 + merges + specials)."""
        from collections import Counter

        words: Counter = Counter()
        for text in corpus:
            for w in _PRETOK.findall(text):
                words[tuple(_B2U[b] for b in w.encode("utf-8"))] += 1
        merges: List[Tuple[str, str]] = []
        target_merges = max(0, vocab_size - 256 - len(specials))
        seqs = dict(words)
        while len(merges) < target_merges:
            pairs: Counter = Counter()
            for seq, cnt in seqs.items():
                for i in range(len(seq) - 1):
                    pairs[(seq[i], seq[i + 1])] += cnt
            if not pairs:
                break
            (a, b), cnt = pairs.most_common(1)[0]
            if cnt < 2:
                break
            merges.append((a, b))
            merged = a + b
            new_seqs: Dict[tuple, int] = {}
            for seq, c in seqs.items():
                out = []
                i = 0
                while i < len(seq):
                    if (i < len(seq) - 1 and seq[i] == a
                            and seq[i + 1] == b):
                        out.append(merged)
                        i += 2
                    else:
                        out.append(seq[i])
                        i += 1
                t = tuple(out)
                new_seqs[t] = new_seqs.get(t, 0) + c
            seqs = new_seqs
        return cls(merges, specials)

    @classmethod
    def byte_fallback(cls) -> "ByteBPETokenizer":
        """No merges: every byte is a token. Exact roundtrip, zero setup."""
        return cls([])

    # -- persistence -----------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"merges": self.merges,
                       "specials": list(self._specials)}, f)

    @classmethod
    def load(cls, path: str) -> "ByteBPETokenizer":
        with open(path) as f:
            data = json.load(f)
        return cls([tuple(m) for m in data["merges"]],
                   tuple(data.get("specials", SPECIAL_TOKENS)))


def get_tokenizer(llm_config: Optional[Dict] = None) -> ByteBPETokenizer:
    """Resolve a tokenizer from an llm_config: `tokenizer_path` (saved
    vocab) or the byte-fallback default."""
    path = (llm_config or {}).get("tokenizer_path")
    if path:
        return ByteBPETokenizer.load(path)
    return ByteBPETokenizer.byte_fallback()


def apply_chat_template(tok: ByteBPETokenizer,
                        messages: Sequence[Dict[str, str]],
                        add_generation_prompt: bool = True) -> List[int]:
    """llama-3-style chat encoding:
    <|begin_of_text|>(<|start_header_id|>role<|end_header_id|>\\n\\ncontent
    <|eot_id|>)* + assistant header."""
    ids: List[int] = [tok.bos_id]
    for m in messages:
        ids.append(tok.special_id(START_HEADER))
        ids.extend(tok.encode(str(m.get("role", "user"))))
        ids.append(tok.special_id(END_HEADER))
        ids.extend(tok.encode("\n\n" + str(m.get("content", ""))))
        ids.append(tok.eot_id)
    if add_generation_prompt:
        ids.append(tok.special_id(START_HEADER))
        ids.extend(tok.encode("assistant"))
        ids.append(tok.special_id(END_HEADER))
        ids.extend(tok.encode("\n\n"))
    return ids
