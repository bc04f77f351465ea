"""Audio emotion encoder, wav2vec2-style (port of ``msa_tpu/models/audio.py``,
the ``positional="conv"`` architecture the serving graph runs):

conv extractor (7 convs, GroupNorm after conv0, exact GELU) →
``post_extract_ln`` → ``proj`` → ``x + pos_conv(x)`` → ``encoder_pre_ln`` →
transformer encoder (no mask) → attentive-stats pool → 4-class head, whose
probabilities are duplicated to the 8-dim contract (D7).

The convs run in the encoder's compute dtype with f32 GroupNorm/LayerNorm,
as in JAX; tensors are NCW inside the convs and [B, T, C] elsewhere.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from msa_tpu_torch.core.emotions import duplicate_4_to_8
from msa_tpu_torch.models.transformer import (
    AttentiveStatsPool,
    EncoderConfig,
    LayerNorm,
    TransformerEncoder,
)


@dataclasses.dataclass(frozen=True)
class AudioModelConfig:
    conv_channels: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernels: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_strides: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    num_classes: int = 4
    pool_hidden: int = 128
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    # prosody-trained pool + head over the JAX package's deterministic trunk
    head_weights: Optional[str] = "checkpoints/audio_emotion_head.msgpack"
    encoder: EncoderConfig = dataclasses.field(default_factory=EncoderConfig)


class ConvFeatureExtractor(nn.Module):
    def __init__(self, cfg: AudioModelConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.encoder.dtype
        cin = 1
        for i, (ch, k, s) in enumerate(zip(cfg.conv_channels, cfg.conv_kernels, cfg.conv_strides)):
            self.add_module(f"conv_{i}", nn.Conv1d(cin, ch, k, stride=s, bias=False).to(dt))
            cin = ch
        # wav2vec2: per-channel GroupNorm after conv0, exact variance, f32
        self.gn = nn.GroupNorm(cfg.conv_channels[0], cfg.conv_channels[0], eps=1e-5)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        """[B, T] → [B, T', C] in the compute dtype."""
        dt = self.cfg.encoder.dtype
        x = wav[:, None, :].to(dt)
        for i in range(len(self.cfg.conv_channels)):
            x = getattr(self, f"conv_{i}")(x)
            if i == 0:
                x = self.gn(x.float()).to(dt)
            x = F.gelu(x)
        return x.transpose(1, 2)


class ConvPositionalEmbedding(nn.Module):
    """Grouped conv over time (kernel 128, 16 groups, padding k/2; an even
    kernel yields one extra frame, which is trimmed) + exact GELU."""

    def __init__(self, d_model: int, kernel: int, groups: int, dtype: torch.dtype):
        super().__init__()
        self.kernel = kernel
        self.conv = nn.Conv1d(d_model, d_model, kernel, padding=kernel // 2, groups=groups).to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x.to(self.conv.weight.dtype).transpose(1, 2)).transpose(1, 2)
        if self.kernel % 2 == 0:
            h = h[:, :-1, :]
        return F.gelu(h)


class AudioEmotionModel(nn.Module):
    def __init__(self, cfg: AudioModelConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.encoder.d_model
        self.feature_extractor = ConvFeatureExtractor(cfg)
        self.post_extract_ln = LayerNorm(cfg.conv_channels[-1], 1e-5, fast=False)
        self.proj = nn.Linear(cfg.conv_channels[-1], d)
        self.pos_conv = ConvPositionalEmbedding(d, cfg.pos_conv_kernel, cfg.pos_conv_groups, cfg.encoder.dtype)
        self.encoder_pre_ln = LayerNorm(d, 1e-5, fast=False)
        self.encoder = TransformerEncoder(cfg.encoder)
        self.pool = AttentiveStatsPool(d, cfg.pool_hidden)
        self.emotion_head = nn.Linear(2 * d, cfg.num_classes)

    def forward(self, wav: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = self.post_extract_ln(self.feature_extractor(wav))  # f32
        x = self.proj(feats)
        x = self.encoder_pre_ln(x + self.pos_conv(x))
        hidden = self.encoder(x, None)
        pooled = self.pool(hidden)
        logits = self.emotion_head(pooled.float())
        probs4 = torch.softmax(logits, dim=-1)
        return {
            "hidden": hidden,
            "pooled": pooled,
            "logits": logits,
            "probs4": probs4,
            "emotion_probs": duplicate_4_to_8(probs4),
        }
