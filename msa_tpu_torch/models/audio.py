"""Audio emotion encoder, wav2vec2-style (port of ``msa_tpu/models/audio.py``):

conv extractor (7 convs, GroupNorm after conv0, exact GELU) →
``post_extract_ln`` → ``proj`` → positions → transformer encoder (no mask)
→ attentive-stats pool → 4-class head, whose probabilities are duplicated
to the 8-dim contract (D7). Positions are ``x + pos_conv(x)`` then
``encoder_pre_ln`` under ``positional="conv"`` (the serving graph's), or a
fixed sinusoidal table added to x under ``positional="sinusoidal"`` (the
tiny test config's).

The convs run in the encoder's compute dtype with f32 GroupNorm/LayerNorm,
as in JAX; tensors are NCW inside the convs and [B, T, C] elsewhere.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
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
    positional: str = "conv"  # "conv" | "sinusoidal"
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    # prosody-trained pool + head over the JAX package's deterministic trunk
    head_weights: Optional[str] = "checkpoints/audio_emotion_head.msgpack"
    encoder: EncoderConfig = dataclasses.field(default_factory=EncoderConfig)

    @classmethod
    def tiny(cls) -> "AudioModelConfig":
        """Small config for tests (``msa_tpu/models/audio.py:68``); no head
        checkpoint, which would not fit the tiny trunk."""
        return cls(
            conv_channels=(8, 8),
            conv_kernels=(10, 8),
            conv_strides=(5, 4),
            pool_hidden=8,
            positional="sinusoidal",
            head_weights=None,
            encoder=EncoderConfig.tiny(),
        )


def sinusoidal_positions(t: int, d: int) -> np.ndarray:
    """[t, d] f32 table: sin on even, cos on odd columns (float64 inside)."""
    pos = np.arange(t)[:, None]
    dim = np.arange(d // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * dim / d)
    out = np.zeros((t, d), np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    return out


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
        if cfg.positional == "conv":
            self.pos_conv = ConvPositionalEmbedding(d, cfg.pos_conv_kernel, cfg.pos_conv_groups, cfg.encoder.dtype)
            self.encoder_pre_ln = LayerNorm(d, 1e-5, fast=False)
        elif cfg.positional != "sinusoidal":
            raise ValueError(f"positional={cfg.positional!r}: expected 'conv' or 'sinusoidal'")
        self.encoder = TransformerEncoder(cfg.encoder)
        self.pool = AttentiveStatsPool(d, cfg.pool_hidden)
        self.emotion_head = nn.Linear(2 * d, cfg.num_classes)

    def forward(self, wav: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = self.post_extract_ln(self.feature_extractor(wav))  # f32
        x = self.proj(feats)
        if self.cfg.positional == "conv":
            x = self.encoder_pre_ln(x + self.pos_conv(x))
        else:
            x = x + torch.from_numpy(sinusoidal_positions(x.shape[1], x.shape[2])).to(x.device)
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
