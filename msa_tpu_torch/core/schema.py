"""Result schemas (port of ``msa_tpu/core/schema.py``).

The reference's analysis dataclasses and the function that builds the
canonical streaming output dict, whose field layout the streaming processor
preserves. The values are numpy arrays (host copies of the hostpack's
columns). JAX registers the array-carrying dataclasses as pytrees so that
they can flow through jitted functions; nothing in the port needs that, so
they are plain dataclasses here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np


class DictMixin:
    """Dict-style access, as the reference's DictMixin."""

    def __getitem__(self, key: str) -> Any:
        return getattr(self, key)

    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclass
class FaceAnalysis(DictMixin):
    """Per-frame face result."""

    speaker_id: str
    emotion_probs: Any  # [..., 7]
    micro_expressions: Any  # [..., 5]
    gaze_direction: Any  # [..., 3]
    muscle_tension: Any  # [..., 4]
    movement_patterns: Any  # [..., 4]
    face_position: Dict[str, int]  # {x, y, w, h}
    detection_confidence: float
    landmark_quality: float
    expression_quality: float
    movement_quality: float


@dataclass
class AudioAnalysis(DictMixin):
    """Per-clip audio result."""

    speaker_id: str
    emotion_probs: Any  # [..., 8]
    pitch: Any  # [..., 1]
    intensity: Any  # [..., 1]
    timbre: Any  # [..., 13]
    speech_rate: Any  # [..., 1]
    rhythm: Any  # [..., 3]
    audio_quality: float
    signal_noise_ratio: float
    clarity: float
    consistency: float


@dataclass
class TextAnalysis(DictMixin):
    """Per-utterance text result."""

    speaker_id: str
    emotion_probs: Any  # [..., 7]
    sarcasm_score: Any  # [..., 1]
    humor_score: Any  # [..., 1]
    polarity: Any  # [..., 1]
    intensity: Any  # [..., 1]
    context_embedding: Any  # [..., 768]
    text_quality: float
    coherence: float
    completeness: float
    relevance: float


@dataclass
class SegmentAnalysis(DictMixin):
    """One diarized segment."""

    start_time: float
    end_time: float
    speaker_id: str
    face_analysis: Optional[FaceAnalysis]
    audio_analysis: Optional[AudioAnalysis]
    text_analysis: Optional[TextAnalysis]
    fused_vector: Any  # [7] logits
    transcript: Optional[str]
    confidence: float
    dominant_emotion: str


@dataclass
class SpeakerAnalysis(DictMixin):
    """Per-speaker aggregate."""

    speaker_id: str
    segments: List[SegmentAnalysis]
    dominant_emotion: str
    emotion_patterns: List[str]
    average_confidence: float
    emotion_timeline: List[Dict[str, Union[float, str]]]


@dataclass
class VideoAnalysis(DictMixin):
    """Whole-video aggregate."""

    video_path: Path
    duration: float
    speakers: List[SpeakerAnalysis]
    global_emotion: str
    emotion_transitions: List[Dict[str, Union[float, str]]]
    confidence: float


@dataclass
class StreamingAnalysis(DictMixin):
    """Live result snapshot."""

    current_emotion: str
    current_confidence: float
    emotion_history: List[Dict[str, Union[float, str]]]
    speaker_id: str
    timestamp: float
    is_speaking: bool
    face_detected: bool
    audio_quality: float


@dataclass
class CompleteAnalysisResult(DictMixin):
    """Top-level result."""

    video_path: Path
    duration: float
    speakers: List[SpeakerAnalysis]
    global_emotion: str
    emotion_transitions: List[Dict[str, Union[float, str]]]
    confidence: float
    processing_time: float
    error: Optional[str] = None


def _np(x) -> Optional[np.ndarray]:
    if x is None:
        return None
    return np.asarray(x).squeeze()


def build_streaming_output(
    face: Optional[FaceAnalysis],
    audio: Optional[AudioAnalysis],
    text: Optional[TextAnalysis],
    fused_vector: Optional[Any],
    weights: Optional[Dict[str, float]],
    speaker_id: Optional[str],
) -> Dict:
    """The canonical streaming output dict: per-modality sub-dicts (None
    when the modality is unavailable), the fused vector (or the raw vector
    of the one modality there is, resolved by the caller), the softmaxed
    modality weights, and the speaker id."""
    return {
        "face": None
        if face is None
        else {
            "emotion_probs": _np(face.emotion_probs),
            "micro_expressions": _np(face.micro_expressions),
            "gaze_direction": _np(face.gaze_direction),
            "muscle_tension": _np(face.muscle_tension),
            "movement_patterns": _np(face.movement_patterns),
            "face_position": face.face_position,
            "face_quality": {
                "detection_confidence": face.detection_confidence,
                "landmark_quality": face.landmark_quality,
                "expression_quality": face.expression_quality,
                "movement_quality": face.movement_quality,
            },
        },
        "audio": None
        if audio is None
        else {
            "emotion_probs": _np(audio.emotion_probs),
            "pitch": _np(audio.pitch),
            "intensity": _np(audio.intensity),
            "timbre": _np(audio.timbre),
            "speech_rate": _np(audio.speech_rate),
            "rhythm": _np(audio.rhythm),
            "audio_quality": {
                "quality": audio.audio_quality,
                "signal_noise_ratio": audio.signal_noise_ratio,
                "clarity": audio.clarity,
                "consistency": audio.consistency,
            },
        },
        "text": None
        if text is None
        else {
            "emotion_probs": _np(text.emotion_probs),
            "sarcasm_score": _np(text.sarcasm_score),
            "humor_score": _np(text.humor_score),
            "polarity": _np(text.polarity),
            "intensity": _np(text.intensity),
            "context_embedding": _np(text.context_embedding),
            "text_quality": {
                "quality": text.text_quality,
                "coherence": text.coherence,
                "completeness": text.completeness,
                "relevance": text.relevance,
            },
        },
        "fused_emotion": _np(fused_vector),
        "weights": weights,
        "speaker_id": speaker_id,
    }


EMPTY_STREAMING_OUTPUT: Dict = {
    "face": None,
    "audio": None,
    "text": None,
    "fused_emotion": None,
    "weights": None,
    "speaker_id": None,
}
