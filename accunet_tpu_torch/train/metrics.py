"""Host-side segmentation metrics (numpy): a copy of np_dice, np_iou and
np_confusion_metrics from accunet_tpu/train/metrics.py. The device-side
training metrics wait for the train slice of the port."""

from __future__ import annotations

import numpy as np

_SMOOTH = 1e-5


def np_dice(pred_bin: np.ndarray, gt_bin: np.ndarray) -> float:
    a = pred_bin.reshape(-1).astype(np.float64)
    b = gt_bin.reshape(-1).astype(np.float64)
    inter = float((a * b).sum())
    return (2 * inter + _SMOOTH) / (a.sum() + b.sum() + _SMOOTH)


def np_iou(pred_bin: np.ndarray, gt_bin: np.ndarray) -> float:
    a = pred_bin.reshape(-1) > 0
    b = gt_bin.reshape(-1) > 0
    union = float(np.logical_or(a, b).sum())
    if union == 0:
        return 1.0
    return float(np.logical_and(a, b).sum()) / union


def np_confusion_metrics(pred_bin: np.ndarray, gt_bin: np.ndarray) -> dict:
    p = pred_bin.reshape(-1) > 0
    t = gt_bin.reshape(-1) > 0
    tp = float(np.logical_and(p, t).sum())
    fp = float(np.logical_and(p, ~t).sum())
    fn = float(np.logical_and(~p, t).sum())
    tn = float(np.logical_and(~p, ~t).sum())
    eps = 1e-12
    sens = tp / (tp + fn + eps)
    spec = tn / (tn + fp + eps)
    prec = tp / (tp + fp + eps)
    f1 = 2 * prec * sens / (prec + sens + eps)
    acc = (tp + tn) / (tp + tn + fp + fn + eps)
    return {
        "sensitivity": sens,
        "specificity": spec,
        "precision": prec,
        "recall": sens,
        "f1": f1,
        "accuracy": acc,
    }
