"""Host-side video ingest (port of ``msa_tpu/host/video.py``): a video is
opened once, the frames of every segment are read in one ordered pass, and
each is resized on the host to the landmark net's input.

:class:`VideoReader` has two backends, chosen by the file's suffix:

- a container (``.mp4``, ``.avi``, ...) is decoded by cv2, as in JAX; where
  cv2 is not installed, opening one raises an ``ImportError``;
- a frame archive (``.npz``) holds the frames already decoded: ``frames``,
  uint8 [N, H, W, 3] in BGR order as cv2 decodes them, and ``fps``, a
  scalar. It is a test route for a machine with no video decoder (the
  archive is to frames what the sidecar WAV is to audio), not an analysis
  feature: a seek gives the frame cv2 gives for a container of those
  frames at that rate.

:func:`preprocess_frame` is ``cv2.resize(..., INTER_LINEAR)`` of the RGB
frame, bit for bit, in numpy, so the resize needs no cv2 either.
:func:`extract_audio_track` reads a sidecar ``.wav``, else runs ffmpeg
where it is on the PATH, else gives None (the audio modality is then
unavailable).
"""

from __future__ import annotations

import math
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from msa_tpu_torch.host.audio_io import load_wav, resample

#: cv2's answer to a seek past the last frame, and the reference's fallback
BLACK_FRAME_HW = (480, 640)
ARCHIVE_SUFFIX = ".npz"


def _black() -> np.ndarray:
    return np.zeros((*BLACK_FRAME_HW, 3), np.uint8)


class VideoReader:
    """One-pass frame access over a video file or a frame archive (see the
    module docstring). ``fps``, ``frame_count``, ``width``, ``height`` and
    ``duration`` as JAX's; frames are BGR uint8."""

    def __init__(self, path: str):
        self.path = str(path)
        self._cap = None
        self._frames: Optional[np.ndarray] = None
        if Path(self.path).suffix.lower() == ARCHIVE_SUFFIX:
            self._open_archive()
        else:
            self._open_container()
        self.duration = self.frame_count / self.fps if self.fps else 0.0

    def _open_archive(self) -> None:
        with np.load(self.path) as z:
            frames, fps = z["frames"], float(z["fps"])
        if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
            raise ValueError(f"{self.path}: frames must be uint8 [N, H, W, 3], got {frames.dtype} {frames.shape}")
        frames.setflags(write=False)  # frame_at hands out views
        self._frames = frames
        self.fps = max(fps, 0.0) or 30.0
        self.frame_count = frames.shape[0]
        self.height, self.width = frames.shape[1:3]

    def _open_container(self) -> None:
        try:
            import cv2
        except ImportError as e:
            raise ImportError(
                f"reading {self.path} needs cv2, which is not installed; a frame archive "
                f"({ARCHIVE_SUFFIX}: frames uint8 [N, H, W, 3] BGR and fps) needs no decoder"
            ) from e
        self._cv2 = cv2
        self._cap = cv2.VideoCapture(self.path)
        if not self._cap.isOpened():
            # cv2 returns -1 for every property on a failed open
            raise IOError(f"cannot open video: {self.path}")
        self.fps = max(float(self._cap.get(cv2.CAP_PROP_FPS)), 0.0) or 30.0
        self.frame_count = max(int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT)), 0)
        self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH)) or 640
        self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) or 480

    def close(self):
        if self._cap is not None:
            self._cap.release()
        self._frames = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def frame_at(self, time_sec: float) -> np.ndarray:
        """The frame at ``time_sec``, BGR uint8; a black 480×640 frame past
        the end or where the decode fails (the reference's fallback). A
        seek in an archive takes frame ``floor(t·fps + 0.5)``, as cv2's
        millisecond seek does in a container."""
        t = max(time_sec, 0.0)
        if self._frames is not None:
            i = math.floor(t * self.fps + 0.5)
            return self._frames[i] if i < self.frame_count else _black()
        self._cap.set(self._cv2.CAP_PROP_POS_MSEC, t * 1000.0)
        ret, frame = self._cap.read()
        if not ret or frame is None:
            return _black()
        return frame

    def frames_at(self, times: List[float]) -> List[np.ndarray]:
        """The frames at ``times``, read in one pass in time order."""
        frames: List[Optional[np.ndarray]] = [None] * len(times)
        for i in np.argsort(times):
            frames[i] = self.frame_at(float(times[i]))
        return frames  # type: ignore[return-value]


def _taps(dst: int, src: int) -> Tuple[np.ndarray, np.ndarray]:
    """cv2's source index and f32 fraction of each destination pixel."""
    f = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    s = np.floor(f)
    return s.astype(np.int64), (f - s).astype(np.float32)


def _coefficients(f: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The two 11-bit fixed-point weights of a fraction."""
    scale = np.float32(2048)
    return np.rint((np.float32(1) - f) * scale).astype(np.int32), np.rint(f * scale).astype(np.int32)


def resize_linear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=INTER_LINEAR)`` on a
    uint8 [H, W, C] image, bit for bit: cv2's fixed-point arithmetic, its
    horizontal pass in int32, its vertical pass as the SIMD path computes
    it (each row sum shifted by 4, multiplied by its 16-bit weight and
    shifted by 16, the two added, then rounded off by 2 bits)."""
    h, w = img.shape[:2]
    sx, fx = _taps(out_w, w)
    lo, hi = sx < 0, sx >= w - 1
    fx[lo | hi] = 0  # the edges take the edge pixel alone
    sx = np.where(lo, 0, np.where(hi, w - 1, sx))
    a0, a1 = _coefficients(fx)
    sx1 = np.minimum(sx + 1, w - 1)
    sy, fy = _taps(out_h, h)
    b0, b1 = _coefficients(fy)  # the vertical weights keep the unclamped fraction

    def horizontal(rows: np.ndarray) -> np.ndarray:
        x = img[rows].astype(np.int32)
        return x[:, sx] * a0[None, :, None] + x[:, sx1] * a1[None, :, None]

    r0 = horizontal(np.clip(sy, 0, h - 1)) >> 4
    r1 = horizontal(np.clip(sy + 1, 0, h - 1)) >> 4
    t = ((r0 * b0[:, None, None]) >> 16) + ((r1 * b1[:, None, None]) >> 16)
    return np.clip((t + 2) >> 2, 0, 255).astype(np.uint8)


def preprocess_frame(frame_bgr: np.ndarray, size: int) -> np.ndarray:
    """BGR uint8 → RGB uint8 resized to the landmark net's ``size``²
    input, equal to ``cv2.resize(cv2.cvtColor(frame, COLOR_BGR2RGB),
    (size, size), INTER_LINEAR)``. Stays uint8: the device normalises."""
    return resize_linear(np.ascontiguousarray(frame_bgr[..., ::-1]), size, size)


def extract_audio_track(video_path: str, temp_dir: str, sample_rate: int = 16_000) -> Optional[Tuple[np.ndarray, int]]:
    """The mono audio track of a video, as JAX's:

    1. a sidecar ``<video>.wav`` next to the file, resampled to ``sample_rate``;
    2. ffmpeg where it is on the PATH (pcm_s16le, ``sample_rate``, mono);
    3. None: the audio modality is unavailable for this video.
    """
    sidecar = Path(video_path).with_suffix(".wav")
    if sidecar.exists():
        x, sr = load_wav(str(sidecar))
        return resample(x, sr, sample_rate), sample_rate

    if shutil.which("ffmpeg"):
        out = Path(temp_dir) / "extracted_audio.wav"
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = ["ffmpeg", "-y", "-i", str(video_path), "-acodec", "pcm_s16le", "-ar", str(sample_rate), "-ac", "1", str(out)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        if proc.returncode == 0 and out.exists():
            return load_wav(str(out))
    return None
