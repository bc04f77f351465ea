"""Byte-level BPE tokenizer (GPT-2 family) for the whisper transcriber
(port of ``msa_tpu/host/bpe.py``, pure Python, the same algorithm).

``vocab.json`` + ``merges.txt`` assets load when present; without assets a
deterministic byte-direct scheme (one id per UTF-8 byte, exactly
invertible) keeps the transcription path runnable offline.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte ↔ printable-unicode table: the 188 printable
    latin-1 bytes map to themselves, the rest shift up past 255."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


# GPT-2 pre-tokenization. The canonical pattern uses \p{L}/\p{N}; stdlib
# `re` equivalents: [^\W\d_] = unicode letters, \d = unicode digits.
_PRETOK = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?[^\s\w]+|\s+(?!\S)|\s+",
    re.UNICODE,
)

_SPECIAL = re.compile(r"^<\|.*\|>$")


class ByteLevelBPE:
    """Encode/decode text ↔ token ids.

    With assets: standard byte-level BPE over ``vocab.json``/``merges.txt``
    (Whisper/GPT-2 format). Without assets: deterministic byte-direct ids in
    ``[byte_offset, byte_offset + 256)`` — lossless roundtrip for any UTF-8
    text, so decoding a (random-weight) model's ids still exercises the real
    text path end-to-end.
    """

    def __init__(
        self,
        vocab_file: Optional[str] = None,
        merges_file: Optional[str] = None,
        vocab_size: int = 51865,
        byte_offset: int = 1000,
    ):
        self._byte_encoder = bytes_to_unicode()
        self._byte_decoder = {v: k for k, v in self._byte_encoder.items()}
        self._cache: Dict[str, List[str]] = {}
        self.byte_offset = byte_offset
        self.vocab: Optional[Dict[str, int]] = None
        self.vocab_size = vocab_size

        if vocab_file and Path(vocab_file).exists():
            with open(vocab_file, encoding="utf-8") as f:
                self.vocab = json.load(f)
            self.vocab_size = len(self.vocab)
            self._id_to_token = {i: t for t, i in self.vocab.items()}
            self._special_ids = {
                i for t, i in self.vocab.items() if _SPECIAL.match(t)
            }
            self._ranks: Dict[Tuple[str, str], int] = {}
            if merges_file and Path(merges_file).exists():
                with open(merges_file, encoding="utf-8") as f:
                    for rank, line in enumerate(f):
                        line = line.strip("\n")
                        if not line or line.startswith("#version"):
                            continue
                        a, _, b = line.partition(" ")
                        self._ranks[(a, b)] = rank
        else:
            if vocab_size < byte_offset + 256:
                raise ValueError("vocab_size too small for byte-direct fallback")
            self._id_to_token = {}
            self._special_ids = set()
            self._ranks = {}

    # --- BPE core -------------------------------------------------------------

    def _bpe(self, token: str) -> List[str]:
        """Merge the unicode-mapped byte string by ascending merge rank."""
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        parts = list(token)
        while len(parts) > 1:
            pairs = {(parts[i], parts[i + 1]) for i in range(len(parts) - 1)}
            best = min(pairs, key=lambda p: self._ranks.get(p, 1 << 30))
            if best not in self._ranks:
                break
            merged: List[str] = []
            i = 0
            while i < len(parts):
                if (
                    i < len(parts) - 1
                    and parts[i] == best[0]
                    and parts[i + 1] == best[1]
                ):
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        if len(self._cache) < 1 << 16:
            self._cache[token] = parts
        return parts

    # --- public API -------------------------------------------------------------

    def encode(self, text: str) -> List[int]:
        if self.vocab is None:
            return [self.byte_offset + b for b in text.encode("utf-8")]
        ids: List[int] = []
        for tok in _PRETOK.findall(text):
            mapped = "".join(self._byte_encoder[b] for b in tok.encode("utf-8"))
            tok_ids: List[int] = []
            for piece in self._bpe(mapped):
                pid = self.vocab.get(piece)
                if pid is None:
                    # full byte coverage means this only happens for pieces
                    # our stdlib pre-tokenizer splits differently from the
                    # canonical \p{L} pattern (or a truncated vocab) — fall
                    # back to raw bytes for the WHOLE token, discarding any
                    # pieces already collected (they would duplicate)
                    tok_ids = [self.vocab[c] for c in mapped if c in self.vocab]
                    break
                tok_ids.append(pid)
            ids.extend(tok_ids)
        return ids

    def decode(self, ids) -> str:
        if self.vocab is None:
            data = bytes(
                i - self.byte_offset
                for i in ids
                if self.byte_offset <= int(i) < self.byte_offset + 256
            )
            return data.decode("utf-8", errors="replace")
        chars: List[str] = []
        for i in ids:
            i = int(i)
            if i in self._special_ids:
                continue
            tok = self._id_to_token.get(i)
            if tok is None or _SPECIAL.match(tok):
                continue  # added/timestamp tokens outside vocab.json
            chars.append(tok)
        data = bytes(
            self._byte_decoder[c] for c in "".join(chars) if c in self._byte_decoder
        )
        return data.decode("utf-8", errors="replace")


def load_whisper_tokenizer(asset_dir: Optional[str]) -> Optional[ByteLevelBPE]:
    """Build a ByteLevelBPE from ``{asset_dir}/vocab.json`` (+ optional
    ``merges.txt``). Returns None when the assets are absent — callers fall
    back to the byte-direct tokenizer or the stub transcriber."""
    if not asset_dir:
        return None
    d = Path(asset_dir)
    vocab = d / "vocab.json"
    if not vocab.exists():
        return None
    merges = d / "merges.txt"
    return ByteLevelBPE(str(vocab), str(merges) if merges.exists() else None)
