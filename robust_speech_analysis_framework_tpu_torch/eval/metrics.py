"""Classification metrics (accuracy, macro P/R/F1, ROC-AUC, ROC curve).

Copy of ``robust_speech_analysis_framework_tpu/eval/metrics.py`` (pure numpy),
kept here so the port imports nothing of the JAX package.

Self-contained NumPy implementations with scikit-learn-compatible semantics
(the reference records acc/f1/precision/recall macro + AUC per fold:
src/cv_strategies.py:70-78, src/dl_cv_strategies.py:345-352). Verified
against installed scikit-learn in tests/test_metrics.py. These run host-side
on per-fold test sets of ~20 samples and accept any array-like.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def _as1d(a) -> np.ndarray:
    return np.asarray(a).reshape(-1)


def accuracy_score(y_true, y_pred) -> float:
    y_true, y_pred = _as1d(y_true), _as1d(y_pred)
    return float(np.mean(y_true == y_pred))


def precision_recall_f1_macro(
    y_true, y_pred, zero_division: float = 0.0
) -> Tuple[float, float, float]:
    """Macro-averaged precision, recall and F1.

    Classes are the union of labels seen in ``y_true`` and ``y_pred``. A class
    with zero predicted (resp. actual) instances contributes
    ``zero_division`` to precision (resp. recall), mirroring sklearn's
    ``zero_division=0`` used by the reference DL engine
    (src/dl_cv_strategies.py:349-350).
    """
    y_true, y_pred = _as1d(y_true), _as1d(y_pred)
    classes = np.union1d(np.unique(y_true), np.unique(y_pred))
    precisions, recalls, f1s = [], [], []
    for c in classes:
        tp = np.sum((y_pred == c) & (y_true == c))
        pred_c = np.sum(y_pred == c)
        true_c = np.sum(y_true == c)
        p = tp / pred_c if pred_c > 0 else zero_division
        r = tp / true_c if true_c > 0 else zero_division
        f = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
        precisions.append(p)
        recalls.append(r)
        f1s.append(f)
    return float(np.mean(precisions)), float(np.mean(recalls)), float(np.mean(f1s))


def f1_macro(y_true, y_pred) -> float:
    return precision_recall_f1_macro(y_true, y_pred)[2]


def _binary_pos_mask(y_true) -> np.ndarray:
    """Positive-class mask with sklearn's default semantics: the positive
    label is the GREATER of the two classes present (so {0,1}→1, {1,2}→2,
    {'Control','Patient'}→'Patient'); raises on >2 classes."""
    classes = np.unique(y_true)
    if len(classes) > 2:
        raise ValueError(f"binary metrics require ≤2 classes, got {classes!r}")
    if len(classes) == 1 and classes[0] in (0, 1):
        # degenerate single-class {0,1} input: keep 1-is-positive semantics
        return y_true == 1
    return y_true == classes[-1]


def roc_curve(y_true, y_score) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """ROC curve (fpr, tpr, thresholds) over distinct score thresholds.

    Points are emitted only at score boundaries (ties collapsed), descending
    thresholds, with the conventional (0, 0) origin prepended. ``y_score``
    is the score of the positive class (the greater label).
    """
    y_true, y_score = _as1d(y_true), _as1d(y_score)
    pos_mask = _binary_pos_mask(y_true)
    order = np.argsort(-y_score, kind="mergesort")
    y_true, y_score = y_true[order], y_score[order]
    # Indices where the score changes — curve vertices.
    distinct = np.where(np.diff(y_score))[0]
    idx = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(pos_mask[order])[idx]
    fps = 1 + idx - tps
    tps = np.r_[0, tps]
    fps = np.r_[0, fps]
    thresholds = np.r_[np.inf, y_score[idx]]
    P = tps[-1] if tps[-1] > 0 else 1
    N = fps[-1] if fps[-1] > 0 else 1
    return fps / N, tps / P, thresholds


def roc_auc_score(y_true, y_score) -> float:
    """Area under the ROC curve via the Mann-Whitney rank statistic.

    Handles score ties by average ranking, equivalent to trapezoidal
    integration of the tie-collapsed ROC curve.
    """
    y_true, y_score = _as1d(y_true), _as1d(y_score)
    pos = _binary_pos_mask(y_true)
    n_pos = int(pos.sum())
    n_neg = int(len(y_true) - n_pos)
    if n_pos == 0 or n_neg == 0:
        raise ValueError("ROC AUC requires both classes present in y_true")
    order = np.argsort(y_score, kind="mergesort")
    ranks = np.empty(len(y_score), dtype=float)
    sorted_scores = y_score[order]
    # Average ranks over tied scores.
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    auc = (ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
    return float(auc)


def classification_metrics(
    y_true, y_pred, y_prob, zero_division: float = 0.0
) -> Dict[str, float]:
    """The reference's standard per-fold metric dict."""
    p, r, f = precision_recall_f1_macro(y_true, y_pred, zero_division)
    return {
        "accuracy": accuracy_score(y_true, y_pred),
        "f1_score": f,
        "precision": p,
        "recall": r,
        "auc": roc_auc_score(y_true, y_prob),
    }


def mean_roc_interpolated(
    fold_predictions: Sequence[dict], grid_points: int = 100
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Mean ± std TPR over folds on a common FPR grid.

    Reproduces the reference's ROC-aggregation plot input (nb02 cell 11:
    interpolate each fold's ROC onto a 100-point FPR grid, average).
    Returns (fpr_grid, mean_tpr, std_tpr).
    """
    fpr_grid = np.linspace(0.0, 1.0, grid_points)
    tprs = []
    for fp in fold_predictions:
        fpr, tpr, _ = roc_curve(fp["y_true"], fp["y_prob"])
        interp = np.interp(fpr_grid, fpr, tpr)
        interp[0] = 0.0
        tprs.append(interp)
    tprs = np.asarray(tprs)
    mean_tpr = tprs.mean(axis=0)
    mean_tpr[-1] = 1.0
    return fpr_grid, mean_tpr, tprs.std(axis=0)
