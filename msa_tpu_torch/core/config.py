"""The configuration tree (port of ``msa_tpu/core/config.py``): the same
dataclasses, field names, defaults and environment overrides, except that
``ModelConfig.device`` names the card."""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    # "cuda" where JAX's says "tpu": the port's entry points run on the card
    # unless the caller asks for the CPU
    device: str = "cuda"
    face_model: str = "msa_tpu/face-emotion-cnn"
    audio_model: str = "msa_tpu/audio-emotion-encoder"
    text_model: str = "msa_tpu/bert-trunk"
    # user-trained fusion weights; the shipped checkpoint loads when absent
    fusion_checkpoint: str = "checkpoints/best_model.msgpack"
    weights: Tuple[float, float, float] = (0.4, 0.3, 0.3)  # (face, audio, text)
    hf_token: Optional[str] = None


@dataclass(frozen=True)
class ProcessingConfig:
    segment_duration: float = 5.0
    min_speech_duration: float = 0.5
    min_pause_duration: float = 0.5
    output_dir: str = "output"
    temp_dir: str = "temp"


@dataclass(frozen=True)
class StreamingConfig:
    video_source: int = 0
    audio_source: int = 0
    sample_rate: int = 16000
    channels: int = 1
    chunk_size: int = 1024
    # transcribe each streaming window (False: text="" live, the reference)
    live_transcription: bool = False


@dataclass(frozen=True)
class DiarizationConfig:
    # "neural" = the shipped speaker embedder + agglomerative clustering;
    # the factory falls back to "clustering" when the checkpoint is missing
    model: str = "neural"
    min_speakers: int = 1
    max_speakers: int = 4
    speaker_weights: str = "checkpoints/speaker_embedder.msgpack"
    # merging stops when the best pair's cosine similarity falls below this
    clustering_threshold: float = 0.6


@dataclass(frozen=True)
class TranscriptionConfig:
    # "auto": whisper assets under data/assets/whisper, else the shipped ASR
    # if its recorded eval passes the bar, else the stub (empty text)
    model: str = "auto"
    language: str = "pt"
    task: str = "transcribe"


@dataclass(frozen=True)
class FaceAnalysisConfig:
    max_num_faces: int = 1
    min_detection_confidence: float = 0.5
    landmark_count: int = 478
    frame_size: int = 192
    crop_size: int = 48
    history_size: int = 10


@dataclass(frozen=True)
class AudioAnalysisConfig:
    sample_rate: int = 16000
    channels: int = 1
    window_size: float = 0.025
    hop_length: float = 0.010
    n_mfcc: int = 13
    n_fft: int = 400
    mel_hop: int = 200
    n_mels: int = 128
    # D8 switch: "reference" keeps the pitch slot at 0.0, "acf" estimates F0
    pitch_mode: str = "reference"


@dataclass(frozen=True)
class TextAnalysisConfig:
    max_length: int = 512
    truncation: bool = True
    padding: bool = True


@dataclass(frozen=True)
class MeshConfig:
    data_parallel: int = -1
    model_parallel: int = 1
    axis_names: Tuple[str, str] = ("data", "model")


@dataclass(frozen=True)
class PipelineConfig:
    segment_samples: int = 80_000  # 5 s @ 16 kHz
    max_tokens: int = 512
    batch_size: int = 8
    compute_dtype: str = "bfloat16"
    feature_dtype: str = "float32"
    # "full" = production encoder sizes; "tiny" = test scale (MSA_MODEL_SCALE)
    model_scale: str = "full"
    # None → resolved by scale (should_precompile); MSA_PRECOMPILE=1/0
    precompile: Optional[bool] = None

    def should_precompile(self) -> bool:
        if self.precompile is not None:
            return self.precompile
        return self.model_scale == "full"


@dataclass(frozen=True)
class DirectoryConfig:
    data_dir: str = "data"
    checkpoints_dir: str = "checkpoints"
    output_dir: str = "output"
    temp_dir: str = "temp"


@dataclass(frozen=True)
class SystemConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    processing: ProcessingConfig = field(default_factory=ProcessingConfig)
    streaming: StreamingConfig = field(default_factory=StreamingConfig)
    diarization: DiarizationConfig = field(default_factory=DiarizationConfig)
    transcription: TranscriptionConfig = field(default_factory=TranscriptionConfig)
    face: FaceAnalysisConfig = field(default_factory=FaceAnalysisConfig)
    audio: AudioAnalysisConfig = field(default_factory=AudioAnalysisConfig)
    text: TextAnalysisConfig = field(default_factory=TextAnalysisConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    dirs: DirectoryConfig = field(default_factory=DirectoryConfig)
    seed: int = 0

    @classmethod
    def from_env(cls, **overrides) -> "SystemConfig":
        """The config with JAX's environment overrides applied: HF_TOKEN,
        MODEL_DEVICE, FACE_MODEL, AUDIO_MODEL, MSA_MODEL_SCALE and
        MSA_PRECOMPILE."""
        cfg = cls(**overrides)
        model_updates = {
            name: os.environ[var]
            for name, var in (
                ("hf_token", "HF_TOKEN"),
                ("device", "MODEL_DEVICE"),
                ("face_model", "FACE_MODEL"),
                ("audio_model", "AUDIO_MODEL"),
            )
            if os.getenv(var)
        }
        if model_updates:
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model_updates))
        pipeline_updates = {}
        if os.getenv("MSA_MODEL_SCALE"):
            pipeline_updates["model_scale"] = os.environ["MSA_MODEL_SCALE"]
        if os.getenv("MSA_PRECOMPILE"):
            pipeline_updates["precompile"] = os.environ["MSA_PRECOMPILE"] not in ("0", "false", "")
        if pipeline_updates:
            cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(cfg.pipeline, **pipeline_updates))
        return cfg

    def ensure_directories(self) -> None:
        """Create the working directories."""
        for d in (self.dirs.data_dir, self.dirs.checkpoints_dir, self.dirs.output_dir, self.dirs.temp_dir):
            Path(d).mkdir(parents=True, exist_ok=True)
