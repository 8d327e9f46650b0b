"""Segmentation losses (torch), counterpart of accunet_tpu/train/losses.py.

  * weighted_bce      — class-balanced BCE-with-logits, weighted *sum*
  * weighted_dice     — applies sigmoid to its input, pos/neg weighting
  * weighted_dice_bce — 0.5 dice + 0.5 BCE (the ACC-UNet training loss)
  * soft_dice_show    — the hard-dice logging metric of WeightedDiceBCE
  * binary_dice_bce / binary_dice_show
  * multiclass_dice_ce (a single head; the deep-supervision branch is not
    ported) / multiclass_dice_show

They keep the reference's quirk: ACC-UNet's binary head already applies a
sigmoid, and weighted_dice_bce still treats its input as logits in the BCE
term and applies a sigmoid again in the dice term. Predictions are NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _bce_with_logits(logit, target):
    # log(1+exp(-|x|)) formulation — numerically stable
    return logit.clamp(min=0) - logit * target + torch.log1p(torch.exp(-logit.abs()))


def weighted_bce(logit, truth, weights=(0.5, 0.5)):
    logit = logit.float().reshape(-1)
    truth = truth.float().reshape(-1)
    truth = torch.where(truth.max() > 1.0, (truth > 0).float(), truth)
    loss = _bce_with_logits(logit, truth)
    pos = (truth > 0.5).float()
    neg = 1.0 - pos
    pos_weight = pos.sum().clamp(min=1.0)
    neg_weight = neg.sum().clamp(min=1.0)
    weighted = weights[0] * pos * loss / pos_weight + weights[1] * neg * loss / neg_weight
    return weighted.sum()


def weighted_dice(logit, truth, weights=(0.5, 0.5), smooth=1e-5):
    b = logit.shape[0]
    logit = logit.float().reshape(b, -1)
    truth = truth.float().reshape(b, -1)
    p = torch.sigmoid(logit)
    w = truth.detach() * (weights[1] - weights[0]) + weights[0]
    p = w * p
    t = w * truth
    intersection = (p * t).sum(-1)
    union = (p * p).sum(-1) + (t * t).sum(-1)
    dice = 1 - (2 * intersection + smooth) / (union + smooth)
    return dice.mean()


def weighted_dice_bce(pred, target, dice_weight=0.5, bce_weight=0.5):
    return dice_weight * weighted_dice(pred, target) + bce_weight * weighted_bce(pred, target)


def soft_dice_show(pred, target):
    """Hard-dice logging metric (WeightedDiceBCE._show_dice): sigmoid, 0.5
    threshold, binarised target, 1 - weighted_dice(hard)."""
    hard = (torch.sigmoid(pred.float()) >= 0.5).float()
    t = (target > 0).float()
    return 1.0 - weighted_dice(hard, t)


def binary_dice_bce(logits, targets, dice_weight=0.5, bce_weight=0.5, smooth=1e-5):
    targets = targets.float()
    if targets.ndim == logits.ndim - 1:  # (B,H,W) -> (B,H,W,1) in NHWC
        targets = targets[..., None]
    targets = targets.reshape(logits.shape)
    bce = _bce_with_logits(logits.float(), targets).mean()
    probs = torch.sigmoid(logits.float())
    axes = tuple(range(1, logits.ndim))
    intersection = (probs * targets).sum(axes)
    denom = probs.sum(axes) + targets.sum(axes) + smooth
    dice_score = (2.0 * intersection + smooth) / denom
    return dice_weight * (1.0 - dice_score.mean()) + bce_weight * bce


def binary_dice_show(logits, targets, smooth=1e-5):
    """BinaryDiceBCE._show_dice: soft dice on sigmoid probabilities."""
    targets = targets.float().reshape(logits.shape)
    probs = torch.sigmoid(logits.float())
    axes = tuple(range(1, logits.ndim))
    intersection = (probs * targets).sum(axes)
    denom = probs.sum(axes) + targets.sum(axes) + smooth
    return ((2.0 * intersection + smooth) / denom).mean()


def multiclass_dice_ce(logits, targets, dice_weight=0.5, ce_weight=0.5, smooth=1e-5):
    """Softmax cross-entropy + mean per-class soft dice for an
    (n_classes+1)-way head. logits (B,H,W,K); targets (B,H,W) or (B,H,W,1)
    integer class ids."""
    if isinstance(logits, (tuple, list)):
        raise NotImplementedError("deep-supervision heads are not ported")
    if targets.ndim == logits.ndim:
        targets = targets[..., 0]
    k = logits.shape[-1]
    onehot = F.one_hot(targets.long(), k).to(logits.dtype)
    logp = torch.log_softmax(logits, dim=-1)
    ce = -(onehot * logp).sum(-1).mean()
    p = torch.softmax(logits, dim=-1)
    inter = (p * onehot).sum(dim=(1, 2))
    union = p.sum(dim=(1, 2)) + onehot.sum(dim=(1, 2))
    dice = 1.0 - ((2 * inter + smooth) / (union + smooth)).mean()
    return ce_weight * ce + dice_weight * dice


def multiclass_dice_show(logits, targets, smooth=1e-5):
    """Hard mean-foreground-dice metric for multi-class heads."""
    if targets.ndim == logits.ndim:
        targets = targets[..., 0]
    k = logits.shape[-1]
    pred = logits.argmax(dim=-1)
    dices = []
    for c in range(1, k):  # foreground classes
        pc = (pred == c).float()
        tc = (targets == c).float()
        inter = (pc * tc).sum(dim=(1, 2))
        dices.append((2 * inter + smooth) / (pc.sum((1, 2)) + tc.sum((1, 2)) + smooth))
    return torch.stack(dices).mean()


LOSSES = {
    "weighted_dice_bce": weighted_dice_bce,
    "binary_dice_bce": binary_dice_bce,
    "multiclass_dice_ce": multiclass_dice_ce,
}
