"""numpy copies of the four scikit-learn metrics the evaluator calls
(scikit-learn 1.9's results, which the JAX package's evaluator reads; the
card's machine has no scikit-learn):

- :func:`accuracy_score`;
- :func:`classification_report` with ``output_dict=True``: per label
  precision, recall, f1-score and support, then "accuracy" where
  ``labels`` covers every label seen in ``y_true`` and ``y_pred`` (else
  "micro avg"), "macro avg" and "weighted avg";
- binary :func:`roc_auc_score`: the trapezoid under the ROC curve over the
  distinct scores (tied scores share one point, which ranks them by their
  average); with one class present it warns and returns NaN, as
  scikit-learn 1.9 does;
- :func:`confusion_matrix` over ``labels``.
"""

from __future__ import annotations

import warnings
from typing import Dict, Sequence

import numpy as np


def accuracy_score(y_true: Sequence, y_pred: Sequence) -> float:
    return float(np.mean(np.asarray(y_true) == np.asarray(y_pred)))


def _divide(num, den, zero_division: float) -> np.ndarray:
    """num / den with ``zero_division`` where den is 0."""
    num, den = np.asarray(num, np.float64), np.asarray(den, np.float64)
    return np.where(den == 0, float(zero_division), num / np.where(den == 0, 1.0, den))


def _prf(tp, pred, true, zero_division):
    return (_divide(tp, pred, zero_division), _divide(tp, true, zero_division),
            _divide(2 * np.asarray(tp, np.float64), np.asarray(true, np.float64) + pred, zero_division))


def classification_report(y_true: Sequence, y_pred: Sequence, labels: Sequence, output_dict: bool = True,
                          zero_division: float = 0) -> Dict:
    """scikit-learn's ``classification_report(..., labels=labels,
    output_dict=True, zero_division=...)``."""
    if not output_dict:
        raise NotImplementedError("only the dict form is ported")
    y_true, y_pred, labels = np.asarray(y_true), np.asarray(y_pred), list(labels)
    tp = np.asarray([np.sum((y_true == l) & (y_pred == l)) for l in labels])
    pred = np.asarray([np.sum(y_pred == l) for l in labels])
    true = np.asarray([np.sum(y_true == l) for l in labels])
    p, r, f = _prf(tp, pred, true, zero_division)
    headers = ("precision", "recall", "f1-score", "support")
    report: Dict = {str(l): dict(zip(headers, map(float, row))) for l, *row in zip(labels, p, r, f, true)}
    support = float(np.sum(true))
    micro = [float(v[0]) for v in _prf([tp.sum()], [pred.sum()], [true.sum()], zero_division)]
    if set(labels) >= set(y_true.tolist()) | set(y_pred.tolist()):
        report["accuracy"] = micro[0]
    else:
        report["micro avg"] = dict(zip(headers, micro + [support]))
    report["macro avg"] = dict(zip(headers, [float(np.mean(v)) for v in (p, r, f)] + [support]))
    weights = true if true.sum() > 0 else None  # all-zero weights: the plain mean, as scikit-learn
    report["weighted avg"] = dict(zip(headers, [float(np.average(v, weights=weights)) for v in (p, r, f)] + [support]))
    return report


def roc_auc_score(y_true: Sequence, y_score: Sequence) -> float:
    """Binary ROC AUC (``y_true`` in {0, 1})."""
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score, np.float64)
    if len(np.unique(y_true)) != 2:
        warnings.warn("Only one class is present in y_true. ROC AUC score is not defined in that case.")
        return float("nan")
    pos = y_true == np.unique(y_true)[-1]
    order = np.argsort(y_score, kind="mergesort")[::-1]
    score, hit = y_score[order], pos[order].astype(np.float64)
    last = np.r_[np.where(np.diff(score))[0], hit.size - 1]  # the last index of each distinct score
    tps = np.cumsum(hit)[last]
    fps = 1 + last - tps
    tpr = np.r_[0.0, tps] / tps[-1]
    fpr = np.r_[0.0, fps] / fps[-1]
    return float(np.trapezoid(tpr, fpr))


def confusion_matrix(y_true: Sequence, y_pred: Sequence, labels: Sequence) -> np.ndarray:
    """[len(labels)]² counts, rows the truth, columns the prediction; pairs
    with a label outside ``labels`` are left out."""
    y_true, y_pred, labels = np.asarray(y_true), np.asarray(y_pred), list(labels)
    if not any(np.any(y_true == l) for l in labels):
        raise ValueError("At least one label specified must be in y_true")
    index = {l: i for i, l in enumerate(labels)}
    cm = np.zeros((len(labels), len(labels)), np.int64)
    for t, p in zip(y_true.tolist(), y_pred.tolist()):
        if t in index and p in index:
            cm[index[t], index[p]] += 1
    return cm
