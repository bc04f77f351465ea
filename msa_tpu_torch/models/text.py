"""Text model: one BERT trunk, four heads and coherence (port of
``msa_tpu/models/text.py``; the tokenizer and the host text heuristics wait
for the processor slice)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from msa_tpu_torch.models.transformer import EncoderConfig, LayerNorm, TransformerEncoder


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

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        positions = torch.arange(input_ids.shape[-1], device=input_ids.device)[None, :]
        x = (
            self.word_embeddings(input_ids)
            + self.position_embeddings(positions)
            + self.token_type_embeddings(torch.zeros_like(input_ids))
        )
        return self.ln(x)


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

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.embeddings(input_ids)
        hidden = self.encoder(x, attention_mask).float()
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
