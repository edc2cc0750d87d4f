"""Evaluation metrics in pure numpy (a copy of ``hriemo/utils/metrics.py``,
which the port does not import).

Semantics match the reference's sklearn-based metrics
(reference: scripts/fusion/train_mosei_fusion_seq_level_decoder.py:119-171):

  * truth binarisation at > 0 (raw MOSEI emotion intensities);
  * micro/macro F1 at a probability threshold (default 0.5);
  * macro ROC-AUC (classes with a single truth value are skipped from the
    macro average, like sklearn raising/NaN-ing on degenerate columns);
  * per-class threshold calibration sweeping 0.05..0.95 in 0.05 steps for
    best F1;
  * per-class BCE ``pos_weight = neg/pos`` computed on the train split.

Pure numpy so the metrics run identically on hosts without sklearn; the
test suite cross-checks them against sklearn when it is available.
"""

from __future__ import annotations

import numpy as np

THRESHOLD_GRID = np.arange(0.05, 0.951, 0.05)


def binarize_truth(y: np.ndarray, threshold: float = 0.0) -> np.ndarray:
    """MOSEI raw intensities → binary labels at > threshold."""
    return (np.asarray(y) > threshold).astype(np.int64)


def f1_binary(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    tp = float(np.sum((y_pred == 1) & (y_true == 1)))
    fp = float(np.sum((y_pred == 1) & (y_true == 0)))
    fn = float(np.sum((y_pred == 0) & (y_true == 1)))
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom > 0 else 0.0


def micro_f1(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Micro-averaged F1 over a multi-label [N, C] pair."""
    return f1_binary(np.asarray(y_true).ravel(), np.asarray(y_pred).ravel())


def macro_f1(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    return float(np.mean([f1_binary(y_true[:, c], y_pred[:, c]) for c in range(y_true.shape[1])]))


def roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Binary ROC-AUC via the Mann-Whitney U statistic (tie-aware).

    Returns NaN for degenerate columns (single-class truth).
    """
    y_true = np.asarray(y_true).astype(bool)
    y_score = np.asarray(y_score, dtype=np.float64)
    n_pos = int(y_true.sum())
    n_neg = int((~y_true).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(y_score, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_scores = y_score[order]
    # average ranks for ties
    i = 0
    n = len(y_score)
    while i < n:
        j = i
        while j + 1 < n and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    rank_sum_pos = ranks[y_true].sum()
    u = rank_sum_pos - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def macro_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Macro AUC over [N, C]; degenerate columns are excluded."""
    y_true, y_score = np.asarray(y_true), np.asarray(y_score)
    aucs = [roc_auc(y_true[:, c], y_score[:, c]) for c in range(y_true.shape[1])]
    aucs = [a for a in aucs if not np.isnan(a)]
    return float(np.mean(aucs)) if aucs else float("nan")


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Binary average precision (area under the PR curve, step-wise)."""
    y_true = np.asarray(y_true).astype(np.int64)
    y_score = np.asarray(y_score, dtype=np.float64)
    if y_true.sum() == 0:
        return float("nan")
    order = np.argsort(-y_score, kind="mergesort")
    y = y_true[order]
    tp = np.cumsum(y)
    precision = tp / np.arange(1, len(y) + 1)
    recall = tp / y_true.sum()
    # sum precision at each new positive
    return float(np.sum(precision * y) / y_true.sum())


def calibrate_thresholds(
    y_true: np.ndarray, y_prob: np.ndarray, grid: np.ndarray = THRESHOLD_GRID
) -> tuple[np.ndarray, np.ndarray]:
    """Per-class threshold sweep for best F1 (reference :154-171).

    Returns ``(thresholds [C], best_f1 [C])``.
    """
    y_true, y_prob = np.asarray(y_true), np.asarray(y_prob)
    n_classes = y_true.shape[1]
    ths = np.zeros(n_classes)
    best = np.zeros(n_classes)
    for c in range(n_classes):
        f1s = [f1_binary(y_true[:, c], (y_prob[:, c] >= t).astype(np.int64)) for t in grid]
        idx = int(np.argmax(f1s))
        ths[c] = grid[idx]
        best[c] = f1s[idx]
    return ths, best


def apply_thresholds(y_prob: np.ndarray, thresholds) -> np.ndarray:
    return (np.asarray(y_prob) >= np.asarray(thresholds)[None, :]).astype(np.int64)


def pos_weights(y_true_binary: np.ndarray) -> np.ndarray:
    """Per-class ``neg/pos`` BCE pos_weight (reference :142-152).

    Classes with no positives get weight 1.0.
    """
    y = np.asarray(y_true_binary)
    pos = y.sum(axis=0).astype(np.float64)
    neg = y.shape[0] - pos
    return np.where(pos > 0, neg / np.maximum(pos, 1), 1.0)


def summary_metrics(y_true_raw, y_prob, thresholds=None) -> dict:
    """The metric block printed each epoch / by the metrics CLI."""
    y_true = binarize_truth(y_true_raw)
    y_prob = np.asarray(y_prob)
    if thresholds is None:
        thresholds = np.full(y_true.shape[1], 0.5)
    y_pred = apply_thresholds(y_prob, thresholds)
    cal_ths, cal_f1 = calibrate_thresholds(y_true, y_prob)
    return {
        "micro_f1": micro_f1(y_true, y_pred),
        "macro_f1": macro_f1(y_true, y_pred),
        "macro_auc": macro_auc(y_true, y_prob),
        "calibrated_macro_f1": float(np.mean(cal_f1)),
        "calibrated_thresholds": cal_ths.tolist(),
        "per_class_f1": [f1_binary(y_true[:, c], y_pred[:, c]) for c in range(y_true.shape[1])],
        "support": y_true.sum(axis=0).tolist(),
    }
