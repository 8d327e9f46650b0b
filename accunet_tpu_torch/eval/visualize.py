"""Validation-time prediction images, counterpart of
accunet_tpu/eval/visualize.py (`save_prediction_images`).

Every vis_frequency-th epoch the train loop writes the first validation
batch's input, ground truth and thresholded prediction as PNGs
(input_<name>.png, gt_<name>.png, pred_<name>.png under
<vis_dir>/epoch_<NNNN>/), or one val_batch.npz when PIL cannot be imported,
as the JAX package does. Arrays are numpy, NHWC.
"""

from __future__ import annotations

import os

import numpy as np


def _to_u8_img(x: np.ndarray) -> np.ndarray:
    """(H,W,C) float -> uint8 grey or RGB, min-max normalised per image."""
    x = np.asarray(x, np.float32)
    lo, hi = float(x.min()), float(x.max())
    x = (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)
    u8 = (x * 255).astype(np.uint8)
    if u8.ndim == 3 and u8.shape[-1] == 1:
        u8 = u8[..., 0]
    elif u8.ndim == 3 and u8.shape[-1] > 3:
        u8 = u8[..., :3]
    return u8


def _mask_u8(m: np.ndarray) -> np.ndarray:
    """A mask or prediction (H,W[,1]) -> uint8 {0, 255}; (H,W,K) logits ->
    argmax class ids spread over 0..255."""
    m = np.asarray(m, np.float32)
    if m.ndim == 3 and m.shape[-1] > 1:
        ids = np.argmax(m, axis=-1)
        k = m.shape[-1]
        return (ids * (255 // max(k - 1, 1))).astype(np.uint8)
    if m.ndim == 3:
        m = m[..., 0]
    return ((m > 0.5) * 255).astype(np.uint8)


def save_prediction_images(vis_dir: str, epoch: int, images: np.ndarray, masks: np.ndarray,
                           preds: np.ndarray, names=None, max_images: int = 4) -> str:
    """Write up to `max_images` (input, gt, pred) triples of one batch;
    returns the epoch's directory."""
    out = os.path.join(vis_dir, f"epoch_{epoch:04d}")
    os.makedirs(out, exist_ok=True)
    n = min(max_images, len(images))
    names = list(names or [])[:n] or [f"sample{i}" for i in range(n)]
    names = [os.path.splitext(os.path.basename(str(s)))[0] for s in names]
    try:
        from PIL import Image
    except ImportError:
        np.savez_compressed(os.path.join(out, "val_batch.npz"), images=np.asarray(images[:n]),
                            masks=np.asarray(masks[:n]), preds=np.asarray(preds[:n]))
        return out
    for i, name in enumerate(names):
        Image.fromarray(_to_u8_img(images[i])).save(os.path.join(out, f"input_{name}.png"))
        Image.fromarray(_mask_u8(masks[i])).save(os.path.join(out, f"gt_{name}.png"))
        Image.fromarray(_mask_u8(preds[i])).save(os.path.join(out, f"pred_{name}.png"))
    return out
