"""Validation metrics of ``Segment.fit`` in torch, on the tensors' device:
the port's replacements for the two sklearn calls of
``dynamorph_tpu/seg/model.py:254`` (reference NNsegmentation/layers.py:
118-143), since the card's machine has no sklearn.

- ``roc_auc_score(y_true, y_score)``: the area under the trapezoidal ROC
  curve with tied scores collapsed into one step, which is the
  Mann-Whitney U statistic with ties counted half,
  ``(R_pos - n_pos (n_pos + 1) / 2) / (n_pos n_neg)`` over average ranks.
  The ranks are counted in float64 (half-integers, exact up to 2**52).
- ``f1_score(y_true, y_pred)``: ``2 TP / (2 TP + FP + FN)``, 0 where that
  has no positive at all (sklearn's ``zero_division`` result).

Both raise ``ValueError`` when ``y_true`` holds one class, as sklearn's
``roc_auc_score`` does, so ``_validate`` reports NaN for both there.
"""
from __future__ import annotations

import torch


def _flat_bool(y: torch.Tensor) -> torch.Tensor:
    return y.reshape(-1).to(torch.bool)


def roc_auc_score(y_true: torch.Tensor, y_score: torch.Tensor) -> float:
    """ROC-AUC of ``y_score`` (any float dtype) for the binary ``y_true``."""
    t = _flat_bool(y_true)
    s = y_score.reshape(-1)
    n = t.numel()
    n_pos = int(t.sum())
    n_neg = n - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("Only one class present in y_true. ROC AUC score "
                         "is not defined in that case.")
    order = torch.argsort(s)
    s_sorted, t_sorted = s[order], t[order]
    _, counts = torch.unique_consecutive(s_sorted, return_counts=True)
    ends = torch.cumsum(counts, 0).to(torch.float64)
    # the average 1-based rank of a run of ties: (first + last) / 2
    avg = ends - (counts.to(torch.float64) - 1) / 2
    ranks = torch.repeat_interleave(avg, counts)
    r_pos = torch.sum(ranks[t_sorted])
    u = r_pos - n_pos * (n_pos + 1) / 2
    return float(u / (float(n_pos) * float(n_neg)))


def f1_score(y_true: torch.Tensor, y_pred: torch.Tensor) -> float:
    """F1 of the binary prediction ``y_pred`` for the binary ``y_true``."""
    t, p = _flat_bool(y_true), _flat_bool(y_pred)
    tp = int(torch.sum(t & p))
    fp = int(torch.sum(~t & p))
    fn = int(torch.sum(t & ~p))
    denom = 2 * tp + fp + fn
    return 0.0 if denom == 0 else 2 * tp / denom
