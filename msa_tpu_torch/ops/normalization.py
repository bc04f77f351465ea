"""Feature normalizers: pad/truncate to a fixed width, then a parameter-free
LayerNorm whose statistics include the zero padding (port of
``msa_tpu/ops/normalization.py``; torch semantics, eps 1e-5, float32)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

LN_EPS = 1e-5

AUDIO_TARGET_DIM = 8 + 1 + 1 + 13 + 1 + 3 + 4  # 31
FACE_TARGET_DIM = 7 + 5 + 3 + 4 + 4 + 4  # 27
TEXT_TARGET_DIM = 7 + 1 + 1 + 1 + 1 + 768 + 4  # 783


def layer_norm(x: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    """Biased variance, eps inside the sqrt, over the last axis, in f32."""
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def pad_or_truncate(x: torch.Tensor, target_dim: int) -> torch.Tensor:
    d = x.shape[-1]
    if d < target_dim:
        return F.pad(x, (0, target_dim - d))
    return x[..., :target_dim]


def normalize_features(x: torch.Tensor, target_dim: int) -> torch.Tensor:
    return layer_norm(pad_or_truncate(x, target_dim))


def normalize_audio(x: torch.Tensor) -> torch.Tensor:
    return normalize_features(x, AUDIO_TARGET_DIM)


def normalize_face(x: torch.Tensor) -> torch.Tensor:
    return normalize_features(x, FACE_TARGET_DIM)


def normalize_text(x: torch.Tensor) -> torch.Tensor:
    return normalize_features(x, TEXT_TARGET_DIM)
