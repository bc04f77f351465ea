"""Synthetic audio-visual "meetings", the training media of the fusion model
(port of ``msa_tpu/training/synth_av.py``).

A meeting directory holds a video and its sidecar ``meeting.wav`` whose
segments carry CORRELATED face and audio emotion:

- each segment draws one of the four emotions both modalities express
  (neutral/angry/happy/sad): the video shows a procedurally rendered face
  with that expression (:mod:`msa_tpu_torch.training.face_synth`) and the
  audio SPEAKS sentences around an emotion word of the class
  (:mod:`msa_tpu_torch.training.speech_synth`) under the class's prosody
  (:mod:`msa_tpu_torch.training.train_audio_emotion`);
- a fraction of segments show face-only expressions (fear, disgust,
  surprise) over neutral prosody;
- pauses separate segments, and the voice alternates between two speakers.

:func:`render_meeting` computes the frames (uint8 BGR, the gray face
replicated, as ``cv2.cvtColor(GRAY2BGR)`` gives them) and the waveform
once, numpy, byte-equal to JAX's from the same generator;
:func:`make_meeting` writes them: ``meeting.mp4`` through cv2's
``VideoWriter`` (mp4v) where cv2 is installed, as JAX's, else a frame
archive ``meeting.npz`` (``frames``, ``fps``) that
:class:`msa_tpu_torch.host.video.VideoReader` reads. Feeding the meetings
through :class:`msa_tpu_torch.training.preprocess_ami.AMIPreprocessor`
gives the fusion trainer's records.
"""

from __future__ import annotations

import importlib.util
import logging
from pathlib import Path
from typing import Tuple

import numpy as np

from msa_tpu_torch.models.speaker import random_voice
from msa_tpu_torch.training import face_synth
from msa_tpu_torch.training.speech_synth import spoken_sentence, synth_spoken_clip
from msa_tpu_torch.training.text_synth import EMOTION_WORDS
from msa_tpu_torch.training.train_audio_emotion import CLASS_PROSODY, _jitter

logger = logging.getLogger(__name__)

SR = 16_000
# (face class in DeepFace order, prosody class in IEMOCAP4 order)
_SHARED = (
    ("neutral", 0),
    ("angry", 1),
    ("happy", 2),
    ("sad", 3),
)
_FACE_ONLY = ("fear", "disgust", "surprise")
# face class name → canonical emotion index (core/emotions.py order:
# neutral, happy, sad, angry, fearful, disgusted, surprised) — selects the
# emotion-lexicon pool the segment's SPOKEN sentence draws from
_CANONICAL_IDX = {
    "neutral": 0, "happy": 1, "sad": 2, "angry": 3,
    "fear": 4, "disgust": 5, "surprise": 6,
}
VIDEO_FORMATS = ("auto", "mp4", "npz")


def _render_single(rng: np.random.Generator, e, size: int) -> np.ndarray:
    """One rendered face frame [size, size, 3] for a given expression."""
    jj, ii = np.meshgrid(np.arange(size), np.arange(size))
    px = (jj + 0.5) / size
    py = (ii + 0.5) / size
    scale = rng.uniform(0.65, 0.9)
    theta = rng.uniform(-0.25, 0.25)
    m = 0.45 * scale
    tx = rng.uniform(m, 1 - m)
    ty = rng.uniform(m, 1 - m)
    c, s = np.cos(-theta), np.sin(-theta)
    ux = (px - tx) / scale
    uy = (py - ty) / scale
    qx = c * ux - s * uy + 0.5
    qy = s * ux + c * uy + 0.5
    bg = rng.uniform(0.05, 0.45)
    skin = rng.uniform(0.6, 0.85)
    img = face_synth._shade(qx, qy, e, skin, bg)
    img = np.clip(img + rng.normal(0.0, 0.03, img.shape), 0, 1)
    return img[..., None].repeat(3, -1).astype(np.float32)


def render_meeting(
    rng: np.random.Generator,
    n_segments: int = 10,
    segment_seconds: float = 5.0,
    pause_seconds: float = 0.5,
    fps: float = 4.0,
    frame_hw: Tuple[int, int] = (240, 320),
    face_size: int = 160,
    p_face_only: float = 0.2,
) -> Tuple[np.ndarray, np.ndarray]:
    """One meeting's frames (uint8 [N, h, w, 3], BGR) and waveform (f32 at
    16 kHz), with JAX's draws in JAX's order."""
    h, w = frame_hw
    voices = [random_voice(rng), random_voice(rng)]
    frames, wav_parts = [], []
    pause = np.full((h, w, 3), int(255 * 0.2), np.uint8)
    for seg in range(n_segments):
        if rng.uniform() < p_face_only:
            face_class = str(rng.choice(_FACE_ONLY))
            pros_idx = 0  # neutral prosody under a face-only expression
        else:
            face_class, pros_idx = _SHARED[rng.integers(0, len(_SHARED))]
        # video: a slowly jittering expression face for the whole segment
        e = face_synth.sample_expression(rng, face_synth.CLASS_NAMES.index(face_class))
        base = _render_single(rng, e, face_size)
        for f in range(int(segment_seconds * fps)):
            frame = np.full((h, w), float(base[..., 0].min()), np.float32)
            y0 = (h - face_size) // 2
            x0 = (w - face_size) // 2
            frame[y0 : y0 + face_size, x0 : x0 + face_size] = np.roll(base[..., 0], shift=f % 3, axis=1)
            img = (np.clip(frame, 0, 1) * 255).astype(np.uint8)
            frames.append(np.repeat(img[..., None], 3, axis=-1))  # GRAY2BGR
        # pause frames (background only) between segments
        frames.extend(pause for _ in range(int(pause_seconds * fps)))
        # audio: SPOKEN sentences around a lexicon word of the segment's
        # class, under its prosody and the alternating speaker
        pros = _jitter(rng, CLASS_PROSODY[pros_idx])
        pool = EMOTION_WORDS[_CANONICAL_IDX[face_class]]
        texts = [spoken_sentence(rng, str(pool[int(rng.integers(0, len(pool)))])) for _ in range(2)]
        wav_parts.append(0.6 * synth_spoken_clip(rng, voices[seg % 2], texts, segment_seconds, SR, prosody=pros))
        wav_parts.append(np.zeros(int(pause_seconds * SR), np.float32))
    return np.stack(frames), np.concatenate(wav_parts)


def make_meeting(
    rng: np.random.Generator,
    out_dir: Path,
    n_segments: int = 10,
    segment_seconds: float = 5.0,
    pause_seconds: float = 0.5,
    fps: float = 4.0,
    frame_hw: Tuple[int, int] = (240, 320),
    face_size: int = 160,
    p_face_only: float = 0.2,
    video: str = "auto",
) -> Path:
    """Write one meeting: the video and its ``meeting.wav`` sidecar.
    ``video``: ``"mp4"`` (cv2's VideoWriter), ``"npz"`` (a frame archive)
    or ``"auto"`` (mp4 where cv2 is installed). → the video's path."""
    if video not in VIDEO_FORMATS:
        raise ValueError(f"video={video!r}: expected one of {VIDEO_FORMATS}")
    from msa_tpu_torch.host.audio_io import save_wav

    frames, wav = render_meeting(
        rng, n_segments, segment_seconds, pause_seconds, fps, frame_hw, face_size, p_face_only
    )
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if video == "auto":
        video = "mp4" if importlib.util.find_spec("cv2") is not None else "npz"
    if video == "mp4":
        import cv2

        video_path = out_dir / "meeting.mp4"
        h, w = frame_hw
        writer = cv2.VideoWriter(str(video_path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        for frame in frames:
            writer.write(frame)
        writer.release()
    else:
        video_path = out_dir / "meeting.npz"
        np.savez(video_path, frames=frames, fps=np.float64(fps))
    # sidecar naming: extract_audio_track looks for <video stem>.wav
    save_wav(str(video_path.with_suffix(".wav")), wav, SR)
    return video_path


def build_corpus(out_dir: str, meetings: int = 12, segments: int = 10, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    root = Path(out_dir)
    for i in range(meetings):
        make_meeting(rng, root / f"meeting_{i:03d}", n_segments=segments)
        logger.info("meeting %d/%d written", i + 1, meetings)


def main(argv=None):
    """JAX's CLI; the videos are mp4 where cv2 is installed, else frame
    archives."""
    import argparse

    parser = argparse.ArgumentParser(description="Gera reuniões audiovisuais sintéticas para o treino da fusão")
    parser.add_argument("--out", default="data/ami_raw")
    parser.add_argument("--meetings", type=int, default=12)
    parser.add_argument("--segments", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    build_corpus(args.out, args.meetings, args.segments, args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
