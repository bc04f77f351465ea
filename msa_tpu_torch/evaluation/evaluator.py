"""Evaluation harness (port of ``msa_tpu/evaluation/evaluator.py``):
ground-truth comparison per modality.

For each modality in {face, audio, text, fused}: accuracy, a
classification report and per-emotion ROC-AUC on the probability scores;
per-modality confusion-matrix heatmaps and a 4-line emotion timeline; and
``metrics.json``. Labels are the reference's Portuguese order. The videos
go through the port's :class:`~msa_tpu_torch.processors.offline.OfflineProcessor`.

Ground truth (the reference's format): ``{"0.0-5.0": ["feliz", ...]}``, a
segment's ``start-end`` key → its annotations; a segment without one
counts as ``["neutro"]``.

The metrics are numpy copies of scikit-learn's
(:mod:`msa_tpu_torch.evaluation.metrics`). The plots import matplotlib
when they are drawn, as JAX's do.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from msa_tpu_torch.core import emotions
from msa_tpu_torch.evaluation import metrics as M

logger = logging.getLogger(__name__)

PT_EMOTIONS = list(emotions.PT_UI)
MODALITIES = ("face", "audio", "text", "fused")


def _dominant_label(vec: List[float]) -> str:
    """argmax over the first 7 dims, labeled in the reference UI order."""
    v = np.asarray(vec, np.float32).reshape(-1)[:7]
    return PT_EMOTIONS[int(np.argmax(v))]


def _key_of(r: Dict) -> str:
    return f"{r['start']:.1f}-{r['end']:.1f}"


class ModelEvaluator:
    def __init__(self, processor=None, config=None, models=None, device: "str | torch.device" = "cuda"):
        if processor is None:
            from msa_tpu_torch.processors.offline import OfflineProcessor

            processor = OfflineProcessor(config=config, models=models, device=device)
        self.processor = processor
        self.emotions = PT_EMOTIONS

    # ------------------------------------------------------------------

    def evaluate_video(
        self,
        video_path: str,
        ground_truth: Dict[str, List[str]],
        output_dir: str = "evaluation",
    ) -> Dict[str, Dict]:
        """Process a video, compare against ground truth, write the plots
        and ``metrics.json``."""
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)

        segments: List[Dict] = []
        for sp in self.processor.process_video(video_path):
            segments.extend(sp["raw_analysis"])

        metrics = {m: self._calculate_metrics(segments, ground_truth, m) for m in MODALITIES}
        self._generate_visualizations(segments, ground_truth, out)
        (out / "metrics.json").write_text(json.dumps(metrics, indent=2))
        return metrics

    # ------------------------------------------------------------------

    def _pairs(self, segments, ground_truth, modality):
        """(y_true, y_pred): each segment's annotations, the prediction
        repeated once per annotation."""
        y_true: List[str] = []
        y_pred: List[str] = []
        for r in segments:
            truth = ground_truth.get(_key_of(r), ["neutro"])
            pred = _dominant_label(r[f"{modality}_vec"])
            y_true.extend(truth)
            y_pred.extend([pred] * len(truth))
        return y_true, y_pred

    def _scores(self, segments, ground_truth, modality):
        """(y_true labels, [n, 7] probability scores in PT-UI order) for the
        score-based AUC: the modality's probability vector (canonical order)
        reordered; for ``fused``, the softmax of the fused logits, or on a
        segment with fewer than two modalities the one modality's
        probabilities (uniform where it has none). (None, None) where the
        records carry no probabilities (the binarized fallback applies)."""
        y_true: List[str] = []
        scores: List[np.ndarray] = []
        for r in segments:
            truth = ground_truth.get(_key_of(r), ["neutro"])
            if modality == "fused":
                combo = r.get("modalities")
                if combo is not None and int(combo).bit_count() < 2:
                    probs = {0b100: r.get("face_probs"), 0b010: r.get("audio_probs"), 0b001: r.get("text_probs")}.get(int(combo))
                    if probs is None:
                        s = np.full(7, 1 / 7.0)
                    else:
                        s = emotions.reorder_np(np.asarray(probs, np.float64)[:7], emotions.CANONICAL_TO_PT_UI)
                else:
                    v = np.asarray(r["fused_vec"], np.float64)[:7]
                    e = np.exp(v - v.max())
                    s = e / e.sum()
            else:
                probs = r.get(f"{modality}_probs")
                if probs is None:
                    return None, None
                s = emotions.reorder_np(np.asarray(probs, np.float64)[:7], emotions.CANONICAL_TO_PT_UI)
            y_true.extend(truth)
            scores.extend([s] * len(truth))
        return y_true, np.asarray(scores)

    def _calculate_metrics(self, segments, ground_truth, modality) -> Dict:
        """Accuracy, the classification report and per-emotion ROC-AUC on
        the probability scores (the binarized argmax form where the records
        carry none)."""
        y_true, y_pred = self._pairs(segments, ground_truth, modality)
        if not y_true:
            return {"accuracy": 0.0}
        result: Dict = {
            "accuracy": M.accuracy_score(y_true, y_pred),
            "classification_report": M.classification_report(
                y_true, y_pred, labels=self.emotions, output_dict=True, zero_division=0
            ),
        }
        ys, scores = self._scores(segments, ground_truth, modality)
        for i, emotion in enumerate(self.emotions):
            if scores is not None:
                t = [1 if e == emotion else 0 for e in ys]
                p = scores[:, i]
            else:
                t = [1 if e == emotion else 0 for e in y_true]
                p = [1 if e == emotion else 0 for e in y_pred]
            try:
                result[f"roc_auc_{emotion}"] = M.roc_auc_score(t, p)
            except ValueError:
                result[f"roc_auc_{emotion}"] = 0.0
        return result

    def _generate_visualizations(self, segments, ground_truth, out: Path):
        """Confusion-matrix heatmaps + the emotion timeline."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        for modality in MODALITIES:
            y_true, y_pred = self._pairs(segments, ground_truth, modality)
            if not y_true:
                continue
            cm = M.confusion_matrix(y_true, y_pred, labels=self.emotions)
            fig, ax = plt.subplots(figsize=(10, 8))
            im = ax.imshow(cm, cmap="Blues")
            ax.set_xticks(range(len(self.emotions)), self.emotions, rotation=45)
            ax.set_yticks(range(len(self.emotions)), self.emotions)
            for i in range(cm.shape[0]):
                for j in range(cm.shape[1]):
                    ax.text(j, i, str(cm[i, j]), ha="center", va="center")
            ax.set_title(f"Matriz de Confusão - {modality}")
            ax.set_xlabel("Predição")
            ax.set_ylabel("Ground Truth")
            fig.colorbar(im)
            fig.tight_layout()
            fig.savefig(out / f"confusion_matrix_{modality}.png")
            plt.close(fig)

        fig, ax = plt.subplots(figsize=(15, 5))
        for modality in MODALITIES:
            times = [r["start"] for r in segments]
            emos = [self.emotions.index(_dominant_label(r[f"{modality}_vec"])) for r in segments]
            ax.plot(times, emos, label=modality)
        ax.set_yticks(range(len(self.emotions)), self.emotions)
        ax.set_title("Timeline de Emoções")
        ax.set_xlabel("Tempo (s)")
        ax.set_ylabel("Emoção")
        ax.legend()
        fig.savefig(out / "emotion_timeline.png")
        plt.close(fig)
