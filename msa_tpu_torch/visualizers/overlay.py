"""Streaming overlay drawing (port of ``msa_tpu/visualizers/overlay.py``).

The reference's cv2 overlay: the face box coloured by the argmax emotion,
a line per modality with its emotion, confidence and quality, the fused
emotion, and the speaker id, with the reference's Portuguese labels, BGR
colour map and per-speaker colours.

cv2 draws where it is installed; without it the visualizer returns the
frame untouched.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from msa_tpu_torch.core import emotions

# the Portuguese label order shared with the evaluator
PT_EMOTIONS = list(emotions.PT_UI)

# BGR colour map
PT_COLORS: Dict[str, Tuple[int, int, int]] = {
    "feliz": (0, 255, 0),
    "triste": (255, 0, 0),
    "raiva": (0, 0, 255),
    "medo": (128, 0, 128),
    "surpresa": (255, 255, 0),
    "nojo": (0, 128, 0),
    "neutro": (128, 128, 128),
}


class StreamingVisualizer:
    window_name = "msa_tpu streaming"

    def __init__(self):
        self._speaker_colors: Dict[str, Tuple[int, int, int]] = {}
        try:
            import cv2  # noqa: F401

            self._cv2 = cv2
        except ImportError:
            self._cv2 = None

    def _speaker_color(self, speaker_id: str) -> Tuple[int, int, int]:
        """A colour per speaker, fixed for the process."""
        if speaker_id not in self._speaker_colors:
            rng = np.random.default_rng(abs(hash(speaker_id)) % (2**32))
            self._speaker_colors[speaker_id] = tuple(int(c) for c in rng.integers(64, 255, 3))
        return self._speaker_colors[speaker_id]

    @staticmethod
    def _dominant(probs) -> Tuple[str, float]:
        probs = np.asarray(probs).reshape(-1)
        idx = int(np.argmax(probs[:7]))
        return PT_EMOTIONS[idx], float(probs[idx])

    def visualize(self, frame: np.ndarray, analysis: Dict) -> np.ndarray:
        """The overlay drawn onto a copy of the frame."""
        if self._cv2 is None or analysis is None:
            return frame
        cv2 = self._cv2
        out = frame.copy()
        y = 24

        face = analysis.get("face")
        if face and face.get("emotion_probs") is not None:
            emo, conf = self._dominant(face["emotion_probs"])
            color = PT_COLORS.get(emo, (255, 255, 255))
            pos = face.get("face_position") or {}
            w, h = int(pos.get("w", 0)), int(pos.get("h", 0))
            if w > 0 and h > 0:
                x0, y0 = int(pos.get("x", 0)), int(pos.get("y", 0))
                cv2.rectangle(out, (x0, y0), (x0 + w, y0 + h), color, 2)
            q = (face.get("face_quality") or {}).get("detection_confidence", 0.0)
            cv2.putText(out, f"face: {emo} ({conf:.2f}) q={q:.2f}", (8, y), cv2.FONT_HERSHEY_SIMPLEX, 0.55, color, 2)
            y += 22

        audio = analysis.get("audio")
        if audio and audio.get("emotion_probs") is not None:
            probs = np.asarray(audio["emotion_probs"]).reshape(-1)
            idx = int(np.argmax(probs))
            q = (audio.get("audio_quality") or {}).get("quality", 0.0)
            cv2.putText(
                out, f"audio: class {idx} ({float(probs[idx]):.2f}) q={q:.2f}", (8, y),
                cv2.FONT_HERSHEY_SIMPLEX, 0.55, (200, 200, 0), 2,
            )
            y += 22

        text = analysis.get("text")
        if text and text.get("emotion_probs") is not None:
            emo, conf = self._dominant(text["emotion_probs"])
            cv2.putText(
                out, f"texto: {emo} ({conf:.2f})", (8, y), cv2.FONT_HERSHEY_SIMPLEX, 0.55,
                PT_COLORS.get(emo, (255, 255, 255)), 2,
            )
            y += 22

        fused = analysis.get("fused_emotion")
        if fused is not None:
            emo, conf = self._dominant(fused)
            cv2.putText(
                out, f"fusao: {emo} ({conf:.2f})", (8, y), cv2.FONT_HERSHEY_SIMPLEX, 0.7,
                PT_COLORS.get(emo, (255, 255, 255)), 2,
            )
            y += 26

        speaker = analysis.get("speaker_id")
        if speaker:
            cv2.putText(
                out, f"speaker: {speaker}", (8, y), cv2.FONT_HERSHEY_SIMPLEX, 0.55,
                self._speaker_color(str(speaker)), 2,
            )
        return out

    def draw_emotion_bars(
        self, frame: np.ndarray, probs, origin: Tuple[int, int] = (8, 8), width: int = 80, height: int = 10,
    ) -> np.ndarray:
        """Horizontal per-emotion probability bars."""
        if self._cv2 is None:
            return frame
        cv2 = self._cv2
        out = frame.copy()
        probs = np.asarray(probs).reshape(-1)[:7]
        x0, y0 = origin
        for i, (label, p) in enumerate(zip(PT_EMOTIONS, probs)):
            y = y0 + i * (height + 4)
            cv2.rectangle(out, (x0, y), (x0 + width, y + height), (64, 64, 64), 1)
            fill = int(max(0.0, min(float(p), 1.0)) * width)
            cv2.rectangle(out, (x0, y), (x0 + fill, y + height), PT_COLORS.get(label, (255, 255, 255)), -1)
            cv2.putText(out, label, (x0 + width + 6, y + height), cv2.FONT_HERSHEY_SIMPLEX, 0.35, (220, 220, 220), 1)
        return out
