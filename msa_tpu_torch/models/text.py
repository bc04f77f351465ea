"""Text model: one BERT trunk, four heads and coherence (port of
``msa_tpu/models/text.py``), the host-side pieces the processors run before
it (the completeness and relevance heuristics and
:class:`WordPieceTokenizer`), and :func:`params_from_hf_bert`, the importer
of a pretrained BERT trunk."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from msa_tpu_torch.models.transformer import DropoutRng, EncoderConfig, LayerNorm, TransformerEncoder, dropout


@dataclasses.dataclass(frozen=True)
class TextModelConfig:
    vocab_size: int = 29794  # neuralmind/bert-base-portuguese-cased
    max_positions: int = 512
    type_vocab_size: int = 2
    # lexicon-trained heads over the JAX package's deterministic trunk
    head_weights: Optional[str] = "checkpoints/text_heads.msgpack"
    encoder: EncoderConfig = dataclasses.field(default_factory=EncoderConfig)

    @classmethod
    def tiny(cls) -> "TextModelConfig":
        """Small config for tests (``msa_tpu/models/text.py:58``); no head
        checkpoint, which would not fit the tiny trunk."""
        return cls(vocab_size=128, max_positions=64, head_weights=None, encoder=EncoderConfig.tiny())


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: TextModelConfig):
        super().__init__()
        d = cfg.encoder.d_model
        self.word_embeddings = nn.Embedding(cfg.vocab_size, d)
        self.position_embeddings = nn.Embedding(cfg.max_positions, d)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, d)
        self.ln = LayerNorm(d, cfg.encoder.layer_norm_eps, fast=True)
        self.encoder_cfg = cfg.encoder

    def forward(
        self, input_ids: torch.Tensor, deterministic: bool = True, dropout_rng: Optional[DropoutRng] = None
    ) -> torch.Tensor:
        """The embeddings' sum through the LayerNorm, then in training
        ``nn.Dropout(encoder.dropout)`` (``Dropout_0``), as JAX's."""
        positions = torch.arange(input_ids.shape[-1], device=input_ids.device)[None, :]
        x = (
            self.word_embeddings(input_ids)
            + self.position_embeddings(positions)
            + self.token_type_embeddings(torch.zeros_like(input_ids))
        )
        return dropout(self.ln(x), self.encoder_cfg.dropout, deterministic, dropout_rng, 0)


class TextModel(nn.Module):
    """Trunk + heads: emotion 7, sarcasm 2, humor 2, sentiment 3 on [CLS];
    polarity/intensity from the sentiment softmax (D4); coherence as the
    masked mean cosine of consecutive token states (D12)."""

    def __init__(self, cfg: TextModelConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.encoder.d_model
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = TransformerEncoder(cfg.encoder)
        self.emotion_head = nn.Linear(d, 7)
        self.sarcasm_head = nn.Linear(d, 2)
        self.humor_head = nn.Linear(d, 2)
        self.sentiment_head = nn.Linear(d, 3)

    def forward(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor, deterministic: bool = True,
        dropout_rng: "int | DropoutRng | None" = None,
    ) -> Dict[str, torch.Tensor]:
        """``deterministic=False`` is training mode; with ``dropout > 0`` it
        needs ``dropout_rng``, the seed of JAX's ``rngs={"dropout":
        PRNGKey(seed)}``."""
        rng = DropoutRng.of(dropout_rng)
        x = self.embeddings(input_ids, deterministic, rng and rng.child("embeddings"))
        hidden = self.encoder(x, attention_mask, deterministic, rng and rng.child("encoder")).float()
        cls = hidden[:, 0, :]
        emotion_probs = torch.softmax(self.emotion_head(cls), dim=-1)
        sarcasm = torch.softmax(self.sarcasm_head(cls), dim=-1)[:, 1:2]
        humor = torch.softmax(self.humor_head(cls), dim=-1)[:, 1:2]
        sentiment = torch.softmax(self.sentiment_head(cls), dim=-1)
        polarity = (sentiment[:, 2] - sentiment[:, 0])[:, None]
        intensity = (1.0 - sentiment[:, 1])[:, None]

        a, b = hidden[:, :-1, :], hidden[:, 1:, :]
        cos = (a * b).sum(dim=-1) / (
            torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(b, dim=-1) + 1e-8
        )
        pair_mask = (attention_mask[:, :-1] * attention_mask[:, 1:]).float()
        coherence = (cos * pair_mask).sum(dim=-1) / torch.clamp(pair_mask.sum(dim=-1), min=1.0)
        return {
            "last_hidden_state": hidden,
            "context_embedding": cls,
            "emotion_probs": emotion_probs,
            "sarcasm_score": sarcasm,
            "humor_score": humor,
            "sentiment": sentiment,
            "polarity": polarity,
            "intensity": intensity,
            "coherence": coherence,
        }


# --- host-side text quality heuristics (string ops stay on the host) ---------


def completeness(text: str) -> float:
    """Subject/verb-suffix/punctuation heuristic, the reference's formula
    (Portuguese verb endings -ar/-er/-ir)."""
    try:
        words = text.split()
        has_subject = len([t for t in words if t.isalpha()]) > 0
        has_verb = len([t for t in words if t.endswith(("ar", "er", "ir"))]) > 0
        has_punct = any(c in text for c in (".", "!", "?"))
        return float(0.4 * has_subject + 0.4 * has_verb + 0.2 * has_punct)
    except Exception:
        return 0.0


RELEVANT_WORDS = ("emoção", "sentimento", "expressão", "reação", "comportamento")


def relevance(text: str) -> float:
    """Keyword density, the reference's formula."""
    try:
        count = sum(1 for w in RELEVANT_WORDS if w in text.lower())
        total = len(text.split())
        if total == 0:
            return 0.0
        return float(min(count / total, 1.0))
    except Exception:
        return 0.0


def text_quality(coherence: float, completeness_: float, relevance_: float) -> float:
    """0.4·coherence + 0.3·completeness + 0.3·relevance."""
    return 0.4 * coherence + 0.3 * completeness_ + 0.3 * relevance_


# --- tokenizer ---------------------------------------------------------------


class WordPieceTokenizer:
    """Minimal WordPiece tokenizer compatible with BERT vocab files.

    Loads a ``vocab.txt`` when given (one token per line, HF format);
    without one it falls back to a deterministic FNV-1a hashing tokenizer
    over ``vocab_size``, as JAX's does, so the ids match the JAX package's
    bit for bit. Truncates to ``max_length`` (512 by default)."""

    CLS = "[CLS]"
    SEP = "[SEP]"
    PAD = "[PAD]"
    UNK = "[UNK]"

    def __init__(self, vocab_file: Optional[str] = None, vocab_size: int = 29794, do_lower_case: bool = False):
        # the reference's BERT is cased; case is kept unless a lowercase
        # vocab asks otherwise
        self.do_lower_case = do_lower_case
        self.vocab: Optional[Dict[str, int]] = None
        self.vocab_size = vocab_size
        if vocab_file:
            vocab = {}
            with open(vocab_file, encoding="utf-8") as f:
                for i, line in enumerate(f):
                    vocab[line.rstrip("\n")] = i
            self.vocab = vocab
            self.vocab_size = len(vocab)
        # special ids: HF BERT's when hashing
        self.pad_id = self._tok_id(self.PAD, 0)
        self.unk_id = self._tok_id(self.UNK, 100)
        self.cls_id = self._tok_id(self.CLS, 101)
        self.sep_id = self._tok_id(self.SEP, 102)

    def _tok_id(self, token: str, default: int) -> int:
        if self.vocab is not None:
            return self.vocab.get(token, default)
        return default

    def _hash_id(self, token: str) -> int:
        # FNV-1a over the UTF-8 bytes; the low ids stay reserved for
        # specials (1000, HF BERT's unused range, for a big vocab; else 104)
        lo = 1000 if self.vocab_size > 2000 else 104
        h = 2166136261
        for ch in token.encode("utf-8"):
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        return lo + h % (self.vocab_size - lo)

    def _wordpiece(self, word: str):
        """Greedy longest-match-first WordPiece (BERT's algorithm)."""
        if len(word) > 100:
            return [self.unk_id]
        out, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            out.append(cur)
            start = end
        return out

    def encode(self, text: str, max_length: int = 512) -> Tuple[np.ndarray, np.ndarray]:
        """→ (input_ids[max_length], attention_mask[max_length]) int32,
        padded or truncated to the static length."""
        # hash mode lowers case for determinism; vocab mode keeps it
        words = text.lower().split() if self.do_lower_case or self.vocab is None else text.split()
        ids = [self.cls_id]
        for w in words:
            w = "".join(ch for ch in w if ch.isalnum() or ch in "#'-")
            if not w:
                continue
            if self.vocab is not None:
                ids.extend(self._wordpiece(w))
            else:
                ids.append(self._hash_id(w))
            if len(ids) >= max_length - 1:
                break
        ids = ids[: max_length - 1] + [self.sep_id]
        mask = [1] * len(ids)
        pad = max_length - len(ids)
        return np.asarray(ids + [self.pad_id] * pad, np.int32), np.asarray(mask + [0] * pad, np.int32)


# --- HF weight import --------------------------------------------------------


def _numpy(x) -> np.ndarray:
    """A torch tensor (any device) or array-like → numpy."""
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x)


def params_from_hf_bert(state_dict: Dict[str, Any], cfg: TextModelConfig) -> Dict[str, Any]:
    """A ``transformers`` BertModel state dict (torch tensors or numpy
    arrays under HF's ``embeddings.`` / ``encoder.layer.N.`` names) → the
    text trunk's flax tree with numpy leaves (``embeddings`` and
    ``encoder``), which :func:`msa_tpu_torch.weights.load_flax_tree` reads.
    A copy of the JAX package's ``msa_tpu/models/text.py:322``; q, k and v
    are concatenated into the trunk's fused [d, 3d] projection. The heads
    are not populated (the reference loads base BERT under random heads).
    ``transformers`` is not needed: the dict is all it reads."""

    def g(name):
        return _numpy(state_dict[name])

    p: Dict[str, Any] = {
        "embeddings": {
            "word_embeddings": {"embedding": g("embeddings.word_embeddings.weight")},
            "position_embeddings": {"embedding": g("embeddings.position_embeddings.weight")},
            "token_type_embeddings": {"embedding": g("embeddings.token_type_embeddings.weight")},
            "ln": {"scale": g("embeddings.LayerNorm.weight"), "bias": g("embeddings.LayerNorm.bias")},
        },
        "encoder": {},
    }
    for i in range(cfg.encoder.num_layers):
        hf = f"encoder.layer.{i}."
        p["encoder"][f"layer_{i}"] = {
            "attention": {
                "qkv": {
                    "kernel": np.concatenate(
                        [g(hf + f"attention.self.{n}.weight").T for n in ("query", "key", "value")], axis=1
                    ),
                    "bias": np.concatenate([g(hf + f"attention.self.{n}.bias") for n in ("query", "key", "value")]),
                },
                "attn_out": {
                    "kernel": g(hf + "attention.output.dense.weight").T,
                    "bias": g(hf + "attention.output.dense.bias"),
                },
            },
            "attn_ln": {
                "scale": g(hf + "attention.output.LayerNorm.weight"),
                "bias": g(hf + "attention.output.LayerNorm.bias"),
            },
            "fc_in": {"kernel": g(hf + "intermediate.dense.weight").T, "bias": g(hf + "intermediate.dense.bias")},
            "fc_out": {"kernel": g(hf + "output.dense.weight").T, "bias": g(hf + "output.dense.bias")},
            "ffn_ln": {"scale": g(hf + "output.LayerNorm.weight"), "bias": g(hf + "output.LayerNorm.bias")},
        }
    return p
