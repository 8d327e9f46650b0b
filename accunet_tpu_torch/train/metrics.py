"""Segmentation metrics, counterpart of accunet_tpu/train/metrics.py:

  * torch metrics computed inside the train/eval step on the device
    (`batch_iou`, `multiclass_batch_iou`), with no host sync;
  * host-side numpy metrics: copies of np_dice, np_iou and
    np_confusion_metrics.
"""

from __future__ import annotations

import numpy as np
import torch

_SMOOTH = 1e-5


def hard_masks(pred, target, apply_sigmoid=True, threshold=0.5):
    p = torch.sigmoid(pred) if apply_sigmoid else pred
    p = (p >= threshold).float()
    t = (target > 0).float()
    return p, t


def batch_iou(pred, target, apply_sigmoid=True):
    """Mean per-image Jaccard of the thresholded prediction."""
    p, t = hard_masks(pred, target, apply_sigmoid)
    b = p.shape[0]
    p = p.reshape(b, -1)
    t = t.reshape(b, -1)
    inter = (p * t).sum(-1)
    union = p.sum(-1) + t.sum(-1) - inter
    return torch.where(union > 0, inter / union, torch.ones_like(union)).mean()


def multiclass_batch_iou(logits, target, smooth=1e-7):
    """Mean foreground IoU for (n_classes+1)-way heads (argmax)."""
    if target.ndim == logits.ndim:
        target = target[..., 0]
    k = logits.shape[-1]
    pred = logits.argmax(dim=-1)
    target = target.to(pred.dtype)
    ious = []
    for c in range(1, k):
        pc = (pred == c).float()
        tc = (target == c).float()
        inter = (pc * tc).sum(dim=(1, 2))
        union = pc.sum((1, 2)) + tc.sum((1, 2)) - inter
        ious.append((inter + smooth) / (union + smooth))
    return torch.stack(ious).mean()


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
