"""AMI corpus preprocessing → fusion-training JSON (port of
``msa_tpu/training/preprocess_ami.py``).

Per-meeting segment records with the full-width feature vectors (face 27 /
audio 31 / text 783) and a pseudo-label target, the renormalized
0.4/0.3/0.3 weighted average of the unimodal emotion probabilities,
shuffled with numpy's ``default_rng(seed)`` and split 70/15/15 into
``{split}/data.json``. With ``models`` the real segment pipeline runs over
each meeting's videos (the port's
:class:`~msa_tpu_torch.processors.offline.OfflineProcessor` on ``device``);
without, each media file gives one uniform placeholder record.

A meeting's videos are JAX's ``*.mp4``; the port also takes frame
archives (``*.npz`` beside a sidecar WAV, which
:class:`~msa_tpu_torch.host.video.VideoReader` reads), the route the tests
and the card's machine (no cv2 there) use.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

PSEUDO_LABEL_WEIGHTS = np.asarray([0.4, 0.3, 0.3])  # face, audio, text
VIDEO_SUFFIXES = (".mp4", ".npz")


def pseudo_label(face_emotions: np.ndarray, audio_emotions: np.ndarray, text_emotions: np.ndarray) -> np.ndarray:
    """Renormalized weighted average of unimodal 7-dim emotion vectors
    (the reference's formula)."""
    target = (
        PSEUDO_LABEL_WEIGHTS[0] * face_emotions
        + PSEUDO_LABEL_WEIGHTS[1] * audio_emotions
        + PSEUDO_LABEL_WEIGHTS[2] * text_emotions
    )
    return target / target.sum()


class AMIPreprocessor:
    def __init__(
        self,
        ami_dir: str,
        output_dir: str,
        split_ratios: Tuple[float, float, float] = (0.7, 0.15, 0.15),
        models=None,
        config=None,
        seed: int = 0,
        device: "str | torch.device" = "cuda",
    ):
        self.ami_dir = Path(ami_dir)
        self.output_dir = Path(output_dir)
        self.split_ratios = split_ratios
        self.models = models
        self.config = config
        self.seed = seed
        self.device = device
        for split in ("train", "val", "test"):
            (self.output_dir / split).mkdir(parents=True, exist_ok=True)

    # --- extraction ---------------------------------------------------------

    def _uniform(self, dim: int) -> np.ndarray:
        """The reference's placeholder: a uniform emotion vector padded into
        the full feature width (emotions uniform, other slots zero)."""
        v = np.zeros(dim, np.float32)
        n = 8 if dim == 31 else 7
        v[:n] = 1.0 / n
        return v

    def _process_meeting(self, meeting_dir: Path) -> List[Dict]:
        """One meeting directory → segment records."""
        videos = sorted(p for p in meeting_dir.glob("*") if p.suffix in VIDEO_SUFFIXES)
        segments: List[Dict] = []

        if videos and self.models is not None:
            from msa_tpu_torch.processors.offline import OfflineProcessor

            proc = OfflineProcessor(config=self.config, models=self.models, device=self.device)
            for video in videos:
                try:
                    for speaker in proc.process_video(str(video)):
                        for seg in speaker["raw_analysis"]:
                            # the target from the probability vectors (the
                            # *_vec slices are post-LayerNorm, as in JAX)
                            target = pseudo_label(
                                np.asarray(seg["face_probs"], np.float32),
                                np.asarray(seg["audio_probs"], np.float32),
                                np.asarray(seg["text_probs"], np.float32),
                            )
                            segments.append(
                                {
                                    "face_vec": np.asarray(seg["face_vec"], np.float32).tolist(),
                                    "audio_vec": np.asarray(seg["audio_vec"], np.float32).tolist(),
                                    "text_vec": np.asarray(seg["text_vec"], np.float32).tolist(),
                                    "target": target.tolist(),
                                }
                            )
                except Exception as e:  # JAX's policy: a failed video is logged and skipped
                    logger.warning("meeting %s failed: %s", video, e, exc_info=True)
        else:
            # placeholder path: one uniform record per media file, so the
            # training pipeline runs end to end
            count = max(len(videos), len(sorted(meeting_dir.glob("*.wav"))), 1)
            for _ in range(count):
                face = self._uniform(27)
                audio = self._uniform(31)
                text = self._uniform(783)
                target = pseudo_label(face[:7], audio[:7] * (8 / 7), text[:7])
                segments.append(
                    {
                        "face_vec": face.tolist(),
                        "audio_vec": audio.tolist(),
                        "text_vec": text.tolist(),
                        "target": (target / target.sum()).tolist(),
                    }
                )
        return segments

    # --- the corpus -----------------------------------------------------------

    def process(self) -> Dict[str, int]:
        """Process every meeting; shuffle; split 70/15/15; write JSON.
        Returns counts per split."""
        meeting_dirs = sorted(d for d in self.ami_dir.glob("*") if d.is_dir())
        all_segments: List[Dict] = []
        for meeting in meeting_dirs:
            all_segments.extend(self._process_meeting(meeting))

        rng = np.random.default_rng(self.seed)
        rng.shuffle(all_segments)
        n = len(all_segments)
        train_end = int(n * self.split_ratios[0])
        val_end = train_end + int(n * self.split_ratios[1])
        splits = {
            "train": all_segments[:train_end],
            "val": all_segments[train_end:val_end],
            "test": all_segments[val_end:],
        }
        for split, segs in splits.items():
            out = self.output_dir / split / "data.json"
            out.write_text(json.dumps(segs, indent=2))
            logger.info("wrote %d segments to %s", len(segs), out)
        return {k: len(v) for k, v in splits.items()}


def main(argv=None):
    """JAX's CLI, plus ``--device``."""
    import argparse

    parser = argparse.ArgumentParser(description="Pré-processa o dataset AMI")
    parser.add_argument("--ami-dir", default="data/ami_raw")
    parser.add_argument("--output-dir", default="data/ami")
    parser.add_argument(
        "--real-extraction",
        action="store_true",
        help="run the full segment pipeline per meeting (default: placeholder)",
    )
    parser.add_argument("--device", default="cuda", help="torch device of the pipeline (--real-extraction)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    models = None
    if args.real_extraction:
        from msa_tpu_torch.pipeline.graph import PipelineModels

        models = PipelineModels.initialize(device=args.device)
    counts = AMIPreprocessor(args.ami_dir, args.output_dir, models=models, device=args.device).process()
    logger.info("splits: %s", counts)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
