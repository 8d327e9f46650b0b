"""Segmentation losses (torch), counterpart of accunet_tpu/train/losses.py.

  * weighted_bce      — class-balanced BCE-with-logits, weighted *sum*
  * weighted_dice     — applies sigmoid to its input, pos/neg weighting
  * weighted_dice_bce — 0.5 dice + 0.5 BCE (the ACC-UNet training loss)
  * soft_dice_show    — the hard-dice logging metric of WeightedDiceBCE
  * binary_dice_bce / binary_dice_show
  * ds_adapter        — deep supervision: 0.5, 0.3, 0.2 on the aux heads
    (bilinear, align_corners=True, to the target's size) + 1.0 on the main
  * multiclass_dice_ce (a deep-supervision tuple through ds_adapter) /
    multiclass_dice_show

A binary loss given a deep-supervision tuple raises: JAX's train CLI cannot
train that case either (its weighted_dice_bce takes the tuple's shape), so
such a model trains with --n-classes > 1.

They keep the reference's quirk: ACC-UNet's binary head already applies a
sigmoid, and weighted_dice_bce still treats its input as logits in the BCE
term and applies a sigmoid again in the dice term. Predictions are NHWC.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from accunet_tpu_torch.ops.resize import resize_bilinear


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


def _single_head(pred, name):
    if isinstance(pred, (tuple, list)):
        raise ValueError(f"{name} takes one head, not a deep-supervision tuple of "
                         f"{len(pred)}: train such a model with --n-classes > 1")


def weighted_dice_bce(pred, target, dice_weight=0.5, bce_weight=0.5):
    _single_head(pred, "weighted_dice_bce")
    return dice_weight * weighted_dice(pred, target) + bce_weight * weighted_bce(pred, target)


def soft_dice_show(pred, target):
    """Hard-dice logging metric (WeightedDiceBCE._show_dice): sigmoid, 0.5
    threshold, binarised target, 1 - weighted_dice(hard)."""
    hard = (torch.sigmoid(pred.float()) >= 0.5).float()
    t = (target > 0).float()
    return 1.0 - weighted_dice(hard, t)


def binary_dice_bce(logits, targets, dice_weight=0.5, bce_weight=0.5, smooth=1e-5):
    _single_head(logits, "binary_dice_bce")
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


def ds_adapter(preds, target, base_loss=weighted_dice_bce, ds_weights=(0.5, 0.3, 0.2),
               main_weight=1.0):
    """Deep-supervision wrapper: `preds` is a plain tensor, a flat tuple
    (main, ds1, ds2, ...) or the legacy ((gt4..gt1), main). Aux heads of
    another size than the target's are resized bilinearly with
    align_corners=True (NHWC)."""
    if not isinstance(preds, (tuple, list)):
        return base_loss(preds, target)
    if len(preds) == 2 and isinstance(preds[0], (tuple, list)):
        ds_list, final_pred = list(preds[0]), preds[1]
    else:
        final_pred, ds_list = preds[0], list(preds[1:])
    spatial = tuple(target.shape[1:3])
    loss = 0.0
    for w, p in zip(ds_weights, ds_list):
        if p.ndim == 4 and tuple(p.shape[1:3]) != spatial:
            p = resize_bilinear(p, spatial, align_corners=True)
        loss = loss + w * base_loss(p, target)
    return loss + main_weight * base_loss(final_pred, target)


def multiclass_dice_ce(logits, targets, dice_weight=0.5, ce_weight=0.5, smooth=1e-5):
    """Softmax cross-entropy + mean per-class soft dice for an
    (n_classes+1)-way head. logits (B,H,W,K); targets (B,H,W) or (B,H,W,1)
    integer class ids. A deep-supervision tuple goes through ds_adapter with
    this loss on each head."""
    if isinstance(logits, (tuple, list)):
        base = functools.partial(multiclass_dice_ce, dice_weight=dice_weight,
                                 ce_weight=ce_weight, smooth=smooth)
        return ds_adapter(logits, targets, base_loss=base)
    if targets.ndim == logits.ndim:
        targets = targets[..., 0]
    k = logits.shape[-1]
    # jax.nn.one_hot's rule: an id outside 0..k-1 gets a row of zeros (the
    # SegMamba heads have n_classes channels for ids 0..n_classes, as in JAX)
    onehot = (targets.long()[..., None] == torch.arange(k, device=logits.device)).to(logits.dtype)
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
