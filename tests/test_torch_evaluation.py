"""The evaluator against the JAX package's on the CPU.

- the numpy metrics (``evaluation/metrics.py``) equal scikit-learn's within
  1e-12 over parametrised draws: labels missing from the truth, a label
  outside the report's list (the report's "micro avg" in place of
  "accuracy"), the default ``neutro``, tied scores and a single class;
- ``ModelEvaluator.evaluate_video`` on the JAX evaluator test's canned
  segments (``tests/test_training_eval.py``), and on segments that carry
  probability vectors and modality combos: JAX's ``metrics.json`` within
  1e-9 and the same PNG names.
"""

import json
import math
import warnings

import numpy as np
import pytest
import sklearn.metrics as skm

from msa_tpu.evaluation.evaluator import ModelEvaluator as JEvaluator
from msa_tpu_torch.core import emotions
from msa_tpu_torch.evaluation import ModelEvaluator
from msa_tpu_torch.evaluation import metrics as M

import torch_parity  # noqa: F401  (its import shares the CPU among xdist workers)

PT = list(emotions.PT_UI)


def _close(got, want, tol=1e-12, path=""):
    """Equal structure and key order; numbers within ``tol`` (NaN = NaN)."""
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _close(got[k], want[k], tol, f"{path}/{k}")
    elif isinstance(want, float) and math.isnan(want):
        assert isinstance(got, float) and math.isnan(got), path
    else:
        assert type(got) is type(want) and abs(got - want) <= tol, (path, got, want)


def _draw(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    truth_labels = list(rng.choice(PT, size=int(rng.integers(1, 8)), replace=False))
    if seed % 4 == 3:
        truth_labels.append("outro")  # a label outside the report's list
    y_true = [str(x) for x in rng.choice(truth_labels, size=n)]
    if seed % 5 == 0:
        y_true = ["neutro"] * n  # the default annotation only
    y_pred = [str(x) for x in rng.choice(PT if seed % 3 else PT[:2], size=n)]
    return rng, y_true, y_pred


@pytest.mark.parametrize("seed", range(16))
def test_metrics_equal_sklearn(seed):
    rng, y_true, y_pred = _draw(seed)
    assert M.accuracy_score(y_true, y_pred) == pytest.approx(skm.accuracy_score(y_true, y_pred), abs=1e-12)
    want = skm.classification_report(y_true, y_pred, labels=PT, output_dict=True, zero_division=0)
    got = M.classification_report(y_true, y_pred, labels=PT, output_dict=True, zero_division=0)
    _close(got, want)
    assert ("accuracy" in got) == (set(y_true) <= set(PT))
    for emotion in PT:
        t = [1 if e == emotion else 0 for e in y_true]
        scores = np.round(rng.random(len(y_true)), int(rng.integers(0, 3)))  # ties at 0-2 decimals
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _close(M.roc_auc_score(t, scores), float(skm.roc_auc_score(t, scores)))
            _close(M.roc_auc_score(t, [1 if e == emotion else 0 for e in y_pred]),
                   float(skm.roc_auc_score(t, [1 if e == emotion else 0 for e in y_pred])))
    if set(y_true) & set(PT):
        np.testing.assert_array_equal(M.confusion_matrix(y_true, y_pred, labels=PT),
                                      skm.confusion_matrix(y_true, y_pred, labels=PT))
    else:
        with pytest.raises(ValueError):
            M.confusion_matrix(y_true, y_pred, labels=PT)


def test_single_class_auc_is_nan_with_a_warning():
    with pytest.warns(UserWarning, match="Only one class"):
        assert math.isnan(M.roc_auc_score([1, 1, 1], [0.1, 0.5, 0.9]))


def _segments(with_probs: bool):
    """The JAX evaluator test's canned segments (``with_probs=False``), or
    segments with probabilities and modality combos, degraded ones too."""
    rng = np.random.default_rng(0)
    segs = []
    for i in range(6 if with_probs else 4):
        seg = {
            "start": float(i * 5), "end": float(i * 5 + 5), "speaker": "A",
            "face_vec": rng.random(27).tolist(), "audio_vec": rng.random(31).tolist(),
            "text_vec": rng.random(783).tolist(), "fused_vec": rng.random(7).tolist(),
            "fused_emotion": "feliz", "transcript": "",
        }
        if with_probs:
            for m in ("face", "audio", "text"):
                p = rng.random(7)
                seg[f"{m}_probs"] = (p / p.sum()).tolist()
            seg["modalities"] = [0b111, 0b100, 0b011, 0b010, 0b001, 0b000][i]
        segs.append(seg)
    return segs


class _Canned:
    def __init__(self, segs):
        self.segs = segs

    def process_video(self, path):
        return [{"person": "A", "raw_analysis": self.segs}]


@pytest.mark.parametrize("with_probs", [False, True], ids=["canned", "probs"])
def test_evaluate_video_writes_jax_metrics(with_probs, tmp_path):
    segs = _segments(with_probs)
    gt = {"0.0-5.0": ["feliz", "neutro"], "5.0-10.0": ["triste"], "15.0-20.0": ["raiva", "raiva"]}
    want = JEvaluator(processor=_Canned(segs)).evaluate_video("x.mp4", gt, output_dir=str(tmp_path / "j"))
    got = ModelEvaluator(processor=_Canned(segs)).evaluate_video("x.npz", gt, output_dir=str(tmp_path / "p"))
    _close(got, want, tol=1e-9)
    _close(json.loads((tmp_path / "p" / "metrics.json").read_text()),
           json.loads((tmp_path / "j" / "metrics.json").read_text()), tol=1e-9)
    pngs = sorted(p.name for p in (tmp_path / "j").glob("*.png"))
    assert sorted(p.name for p in (tmp_path / "p").glob("*.png")) == pngs and len(pngs) == 5
