"""Evaluation metrics (the JAX package's ``core/metrics.py``): the paper
reports F1-micro and, for multilabel OGB-Proteins, ROC-AUC.

Every function takes tensors (on any device) or numpy arrays and computes
on the host in numpy, as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


def f1_micro_multiclass(logits, labels) -> float:
    """Single-label multiclass micro-F1 == accuracy."""
    return float((_np(logits).argmax(-1) == _np(labels)).mean())


def f1_micro_multilabel(scores, labels, threshold: float = 0.0) -> float:
    """Micro-F1 over binary indicator matrices (N, C)."""
    pred = _np(scores) > threshold
    truth = _np(labels) > 0.5
    tp = float(np.logical_and(pred, truth).sum())
    fp = float(np.logical_and(pred, ~truth).sum())
    fn = float(np.logical_and(~pred, truth).sum())
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom else 0.0


def roc_auc(scores, labels) -> float:
    """Binary ROC-AUC via the rank statistic (ties averaged).

    scores: (N,) real-valued; labels: (N,) {0,1}.
    """
    s = _np(scores).astype(np.float64).ravel()
    y = _np(labels).ravel() > 0.5
    n_pos, n_neg = int(y.sum()), int((~y).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty_like(s)
    ranks[order] = np.arange(1, s.size + 1, dtype=np.float64)
    # average ranks over exact ties
    sorted_s = s[order]
    i = 0
    while i < s.size:
        j = i
        while j + 1 < s.size and sorted_s[j + 1] == sorted_s[i]:
            j += 1
        if j > i:
            ranks[order[i: j + 1]] = (i + 1 + j + 1) / 2.0
        i = j + 1
    auc = (ranks[y].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
    return float(auc)


def roc_auc_macro_multilabel(scores, labels) -> float:
    """Mean per-class AUC over classes with both labels present
    (the OGB-Proteins protocol)."""
    scores = _np(scores)
    labels = _np(labels)
    aucs = []
    for c in range(scores.shape[1]):
        a = roc_auc(scores[:, c], labels[:, c])
        if a == a:  # not NaN
            aucs.append(a)
    return float(np.mean(aucs)) if aucs else float("nan")


def perplexity(nll_per_token) -> float:
    return float(np.exp(min(float(nll_per_token), 30.0)))
