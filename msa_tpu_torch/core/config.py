"""The configuration fields the segment graph reads (port of
``SystemConfig.audio`` and ``SystemConfig.pipeline.segment_samples`` of
``msa_tpu/core/config.py``; same names and defaults)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class AudioAnalysisConfig:
    sample_rate: int = 16000
    # D8 switch: "reference" keeps the pitch slot at 0.0, "acf" estimates F0
    pitch_mode: str = "reference"


@dataclass(frozen=True)
class PipelineConfig:
    segment_samples: int = 80_000  # 5 s @ 16 kHz


@dataclass(frozen=True)
class SystemConfig:
    audio: AudioAnalysisConfig = field(default_factory=AudioAnalysisConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
