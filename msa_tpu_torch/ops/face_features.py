"""Landmark-geometry feature ops, batched over a leading axis (port of
``msa_tpu/ops/face_features.py``). Landmarks are ``[B, 478, 3]`` in
MediaPipe's normalized convention; every per-frame statistic of the JAX
version is taken per row here."""

from __future__ import annotations

from typing import Tuple

import torch

from msa_tpu_torch.ops.audio_features import zscore

NUM_LANDMARKS = 478

_MICRO_PAIRS = ((10, 151), (105, 334), (33, 133), (1, 4), (61, 291))
_TENSION_REGIONS = (
    (10, 151, 9, 8),
    (33, 133, 145, 159),
    (1, 4, 5, 6),
    (61, 291, 0, 17),
)
_MOVEMENT_IDS = (10, 105, 33, 1, 61, 0)


def _dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((a - b).square().sum(dim=-1))


def bbox(landmarks: torch.Tensor, frame_h: int, frame_w: int) -> torch.Tensor:
    """[B, 478, 3] → [B, 4] = [x, y, w, h] pixels, clamped to the frame."""
    x_min, x_max = landmarks[..., 0].min(dim=-1).values, landmarks[..., 0].max(dim=-1).values
    y_min, y_max = landmarks[..., 1].min(dim=-1).values, landmarks[..., 1].max(dim=-1).values
    x = torch.clamp(torch.floor(x_min * frame_w), 0, frame_w)
    y = torch.clamp(torch.floor(y_min * frame_h), 0, frame_h)
    w = torch.clamp(torch.floor((x_max - x_min) * frame_w), min=0)
    w = torch.minimum(w, frame_w - x)
    h = torch.clamp(torch.floor((y_max - y_min) * frame_h), min=0)
    h = torch.minimum(h, frame_h - y)
    return torch.stack([x, y, w, h], dim=-1).float()


def micro_expressions(lm: torch.Tensor) -> torch.Tensor:
    d = torch.stack([_dist(lm[:, i], lm[:, j]) for i, j in _MICRO_PAIRS], dim=-1)
    return zscore(d)


def gaze(lm: torch.Tensor) -> torch.Tensor:
    left = torch.stack(
        [lm[:, 33, 0] - lm[:, 133, 0], lm[:, 159, 1] - lm[:, 145, 1], lm[:, 33, 2] - lm[:, 133, 2]],
        dim=-1,
    )
    right = torch.stack(
        [lm[:, 362, 0] - lm[:, 263, 0], lm[:, 386, 1] - lm[:, 374, 1], lm[:, 362, 2] - lm[:, 263, 2]],
        dim=-1,
    )
    return zscore((left + right) / 2.0)


def muscle_tension(lm: torch.Tensor) -> torch.Tensor:
    vals = []
    for region in _TENSION_REGIONS:
        pts = lm[:, list(region)]
        vals.append(_dist(pts[:, :-1], pts[:, 1:]).mean(dim=-1))
    return zscore(torch.stack(vals, dim=-1))


def movement(lm: torch.Tensor, prev: torch.Tensor, has_prev: torch.Tensor) -> torch.Tensor:
    ids = list(_MOVEMENT_IDS)
    d = _dist(lm[:, ids], prev[:, ids]) * has_prev.to(lm.dtype)[:, None]
    return zscore(d)


def landmark_quality(lm: torch.Tensor) -> torch.Tensor:
    """1 − min(CV of consecutive-landmark distances, 1), biased std."""
    d = _dist(lm[:, :-1], lm[:, 1:])
    mean = d.mean(dim=-1)
    std = torch.sqrt((d - mean[:, None]).square().mean(dim=-1))
    return 1.0 - torch.clamp(std / (mean + 1e-6), max=1.0)


def expression_quality(lm: torch.Tensor) -> torch.Tensor:
    left_eye = lm[:, 33, 1] - lm[:, 133, 1]
    right_eye = lm[:, 362, 1] - lm[:, 263, 1]
    eye_symmetry = 1.0 - (left_eye - right_eye).abs()
    mouth_quality = 1.0 - ((lm[:, 61, 1] - lm[:, 291, 1]) - 0.1).abs()
    return (eye_symmetry + mouth_quality) / 2.0


def movement_quality(lm: torch.Tensor, prev: torch.Tensor, has_prev: torch.Tensor) -> torch.Tensor:
    total = _dist(lm, prev).sum(dim=-1)
    return (1.0 - torch.clamp(total, max=1.0)) * has_prev.to(lm.dtype)


def face_feature_stack(
    landmarks: torch.Tensor,
    prev_landmarks: torch.Tensor,
    face_present: torch.Tensor,
    has_prev: torch.Tensor,
    frame_h: int,
    frame_w: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (geometry [B, 18] = micro 5, gaze 3, tension 4, movement 6;
    position [B, 4]; quality [B, 4]), all zero where no face is present."""
    present = face_present.float()[:, None]
    geometry = torch.cat(
        [
            micro_expressions(landmarks),
            gaze(landmarks),
            muscle_tension(landmarks),
            movement(landmarks, prev_landmarks, has_prev),
        ],
        dim=-1,
    ) * present
    position = bbox(landmarks, frame_h, frame_w) * present
    quality = torch.stack(
        [
            face_present.float(),
            landmark_quality(landmarks),
            expression_quality(landmarks),
            movement_quality(landmarks, prev_landmarks, has_prev),
        ],
        dim=-1,
    )
    quality = torch.cat([quality[:, :1], quality[:, 1:] * present], dim=-1)
    return geometry, position, quality
