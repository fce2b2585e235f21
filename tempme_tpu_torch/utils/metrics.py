"""Evaluation metrics (average precision, ROC-AUC, accuracy) in numpy, and
early stopping.

The port's copy of ``tempme_tpu/utils/metrics.py``: masked, sklearn-equal
binary AP and AUC, thresholded accuracy and ``EarlyStopMonitor``.
"""
from __future__ import annotations

import numpy as np


def _validate(y_true, y_score, mask=None):
    y_true = np.asarray(y_true, np.float64).ravel()
    y_score = np.asarray(y_score, np.float64).ravel()
    if mask is not None:
        m = np.asarray(mask, bool).ravel()
        y_true, y_score = y_true[m], y_score[m]
    return y_true, y_score


def roc_auc_score(y_true, y_score, mask=None) -> float:
    """Mann-Whitney U statistic with average-rank tie handling (matches
    sklearn.roc_auc_score for binary labels)."""
    y_true, y_score = _validate(y_true, y_score, mask)
    pos = y_true > 0.5
    n_pos = int(pos.sum())
    n_neg = len(y_true) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(y_score, kind="mergesort")
    ranks = np.empty(len(y_score), np.float64)
    sorted_scores = y_score[order]
    # average ranks for ties
    i = 0
    r = np.arange(1, len(y_score) + 1, dtype=np.float64)
    while i < len(y_score):
        j = i
        while j + 1 < len(y_score) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        r[i:j + 1] = 0.5 * (i + j) + 1.0
        i = j + 1
    ranks[order] = r
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def average_precision_score(y_true, y_score, mask=None) -> float:
    """AP = sum_n (R_n - R_{n-1}) P_n over descending-score thresholds
    (matches sklearn.average_precision_score for binary labels)."""
    y_true, y_score = _validate(y_true, y_score, mask)
    n_pos = float((y_true > 0.5).sum())
    if n_pos == 0:
        return float("nan")
    order = np.argsort(-y_score, kind="mergesort")
    yt = (y_true[order] > 0.5).astype(np.float64)
    ys = y_score[order]
    tp = np.cumsum(yt)
    fp = np.cumsum(1.0 - yt)
    # threshold boundaries: last index of each distinct score
    distinct = np.where(np.diff(ys))[0]
    idx = np.r_[distinct, len(ys) - 1]
    precision = tp[idx] / (tp[idx] + fp[idx])
    recall = tp[idx] / n_pos
    recall_prev = np.r_[0.0, recall[:-1]]
    return float(np.sum((recall - recall_prev) * precision))


def accuracy_score(y_true, y_score, threshold: float = 0.5, mask=None) -> float:
    y_true, y_score = _validate(y_true, y_score, mask)
    if len(y_true) == 0:
        return float("nan")
    return float(((y_score > threshold) == (y_true > 0.5)).mean())


class EarlyStopMonitor:
    """Relative-tolerance early stopping (the reference's
    utils/batch_loader.py:4-29)."""

    def __init__(self, max_round=3, higher_better=True, tolerance=1e-3):
        self.max_round = max_round
        self.num_round = 0
        self.epoch_count = 0
        self.best_epoch = 0
        self.last_best = None
        self.higher_better = higher_better
        self.tolerance = tolerance

    def state_dict(self) -> dict:
        return dict(num_round=self.num_round, epoch_count=self.epoch_count,
                    best_epoch=self.best_epoch, last_best=self.last_best)

    def load_state_dict(self, d: dict) -> None:
        self.num_round = d["num_round"]
        self.epoch_count = d["epoch_count"]
        self.best_epoch = d["best_epoch"]
        self.last_best = d["last_best"]

    def early_stop_check(self, curr_val: float) -> bool:
        self.epoch_count += 1
        if not self.higher_better:
            curr_val *= -1
        if self.last_best is None:
            self.last_best = curr_val
        elif (curr_val - self.last_best) / abs(self.last_best) > self.tolerance:
            self.last_best = curr_val
            self.num_round = 0
            self.best_epoch = self.epoch_count
        else:
            self.num_round += 1
        return self.num_round >= self.max_round
