"""Canonical emotion taxonomy and label-order adapters (port of
``msa_tpu/core/emotions.py``; same orders and index tuples)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

CANONICAL: Tuple[str, ...] = (
    "neutral",
    "happy",
    "sad",
    "angry",
    "fearful",
    "disgusted",
    "surprised",
)
# order emitted by the face emotion CNN (DeepFace dict order)
DEEPFACE: Tuple[str, ...] = (
    "angry",
    "disgust",
    "fear",
    "happy",
    "sad",
    "surprise",
    "neutral",
)
PT_UI: Tuple[str, ...] = (
    "feliz",
    "triste",
    "raiva",
    "medo",
    "surpresa",
    "nojo",
    "neutro",
)
# IEMOCAP 4-class audio convention, duplicated to the 8-dim contract (D7)
IEMOCAP4: Tuple[str, ...] = ("neutral", "angry", "happy", "sad")

_SYNONYMS = {
    "fear": "fearful",
    "fearful": "fearful",
    "medo": "fearful",
    "disgust": "disgusted",
    "disgusted": "disgusted",
    "nojo": "disgusted",
    "surprise": "surprised",
    "surprised": "surprised",
    "surpresa": "surprised",
    "happy": "happy",
    "feliz": "happy",
    "sad": "sad",
    "triste": "sad",
    "angry": "angry",
    "raiva": "angry",
    "neutral": "neutral",
    "neutro": "neutral",
}


def _norm(label: str) -> str:
    try:
        return _SYNONYMS[label.lower()]
    except KeyError as e:
        raise ValueError(f"unknown emotion label: {label!r}") from e


def permutation(src: Sequence[str], dst: Sequence[str]) -> Tuple[int, ...]:
    """Index tuple ``p`` such that ``probs_dst = probs_src[..., p]``."""
    src_n = [_norm(s) for s in src]
    dst_n = [_norm(d) for d in dst]
    if sorted(src_n) != sorted(dst_n):
        raise ValueError(f"orders are not permutations: {src} vs {dst}")
    return tuple(src_n.index(d) for d in dst_n)


DEEPFACE_TO_CANONICAL = permutation(DEEPFACE, CANONICAL)
CANONICAL_TO_DEEPFACE = permutation(CANONICAL, DEEPFACE)
PT_UI_TO_CANONICAL = permutation(PT_UI, CANONICAL)
CANONICAL_TO_PT_UI = permutation(CANONICAL, PT_UI)

_IEMOCAP4_SLOTS: Tuple[int, ...] = tuple(
    CANONICAL.index(_norm(lbl)) for lbl in IEMOCAP4
)


def reorder(probs: torch.Tensor, perm: Tuple[int, ...]) -> torch.Tensor:
    """Apply a precomputed permutation along the last axis."""
    return probs[..., list(perm)]


def reorder_np(probs, perm: Tuple[int, ...]) -> np.ndarray:
    """:func:`reorder` on the host: numpy along the last axis."""
    return np.take(np.asarray(probs), perm, axis=-1)


def label_of(index: int, order: Sequence[str] = CANONICAL) -> str:
    """The label of class ``index`` in ``order``."""
    return order[int(index)]


def duplicate_4_to_8(probs4: torch.Tensor) -> torch.Tensor:
    """[..., 4] → [..., 8]: concatenated with itself and renormalized (D7)."""
    probs8 = torch.cat([probs4, probs4], dim=-1)
    return probs8 / probs8.sum(dim=-1, keepdim=True)


def iemocap4_to_canonical7(probs4: torch.Tensor) -> torch.Tensor:
    """[..., 4] IEMOCAP probabilities → [..., 7] canonical order, zeros in
    the three slots the audio model cannot express."""
    out = probs4.new_zeros(probs4.shape[:-1] + (len(CANONICAL),))
    out[..., list(_IEMOCAP4_SLOTS)] = probs4
    return out
