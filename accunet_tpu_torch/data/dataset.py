"""Datasets: npy- and png-backed medical segmentation folders.

A numpy copy of accunet_tpu/data/dataset.py (that package cannot be imported
without flax). Directory conventions, as in the reference's
Experiments/Load_Dataset.py:
  * `<root>/images/*.npy` + `<root>/masks/*.npy` — image npy (4,H,W) ->
    channel 0, bilinear resize to image_size, per-image standardisation
    (x-mean)/(std+1e-8); mask npy -> nearest resize -> binarise (>0).
  * `<root>/img/*.png` + `<root>/labelcol/*_segmentation.png|.png` — the
    earlier PNG generation, greyscale or RGB, values scaled to [0,1].

Resizing is without cv2: the bilinear resize samples half-pixel centres
(cv2's INTER_LINEAR, within 1.1e-7); the nearest resize (masks) takes source
index min(floor(i * (1.0 / (size / n))), n - 1) in float64, the rule of cv2's
INTER_NEAREST, which the JAX package calls, pixel for pixel. The resizes, the
standardisation and the mask binarisation run as the native ops of
data/native_loader.py (C++ through ctypes, built by g++ at first use) when
they build, else as numpy: the resizes and the binarisation give the same
arrays either way, the standardisation agrees to float64 rounding (its sums
run in another order), within 1e-6 after the cast to float32.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from accunet_tpu_torch.data import native_loader


def _resize_image(img: np.ndarray, size: int, nearest: bool) -> np.ndarray:
    """2D resize to (size, size): nearest as cv2's INTER_NEAREST (the scale
    is the reciprocal of the scale factor, both in float64), else bilinear
    with half-pixel centres."""
    if img.shape[0] == size and img.shape[1] == size:
        return img
    if native_loader.available():
        return native_loader.resize2d(img, size, nearest)
    h, w = img.shape[:2]
    if nearest:
        yi = np.minimum(np.floor(np.arange(size) * (1.0 / (size / h))).astype(int), h - 1)
        xi = np.minimum(np.floor(np.arange(size) * (1.0 / (size / w))).astype(int), w - 1)
        return img[yi][:, xi]
    ys = (np.arange(size) + 0.5) * h / size - 0.5
    xs = (np.arange(size) + 0.5) * w / size - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    fy = np.clip(ys - y0, 0, 1)[:, None]
    fx = np.clip(xs - x0, 0, 1)[None, :]
    top = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    bot = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    return top * (1 - fy) + bot * fy


def list_split_ids(split_file: str) -> list[str]:
    with open(split_file) as f:
        return [ln.strip() for ln in f if ln.strip()]


class SegmentationDataset:
    """Indexable dataset of {'image': (H,W,C) float32, 'label': (H,W) int}."""

    def __init__(
        self,
        root: str,
        image_size: int = 256,
        ids: Sequence[str] | None = None,
        channel_idx: int = 0,
        binarize_mask: bool = True,
    ):
        self.root = root
        self.image_size = image_size
        self.channel_idx = channel_idx
        self.binarize_mask = binarize_mask

        npy_dir = os.path.join(root, "images")
        png_dir = os.path.join(root, "img")
        if os.path.isdir(npy_dir):
            self.kind = "npy"
            self.img_dir = npy_dir
            self.mask_dir = os.path.join(root, "masks")
            files = sorted(f for f in os.listdir(npy_dir) if f.endswith(".npy"))
        elif os.path.isdir(png_dir):
            self.kind = "png"
            self.img_dir = png_dir
            self.mask_dir = os.path.join(root, "labelcol")
            files = sorted(
                f
                for f in os.listdir(png_dir)
                if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp", ".tif"))
            )
        else:
            raise FileNotFoundError(f"no images/ or img/ under {root}")
        if ids is not None:
            idset = set(ids)
            files = [f for f in files if os.path.splitext(f)[0] in idset]
        self.files = files

    def __len__(self):
        return len(self.files)

    def _load_png(self, fname):
        from PIL import Image

        img = np.asarray(Image.open(os.path.join(self.img_dir, fname)), np.float32)
        stem = os.path.splitext(fname)[0]
        for cand in (f"{stem}_segmentation.png", f"{stem}.png", fname):
            p = os.path.join(self.mask_dir, cand)
            if os.path.exists(p):
                mask = np.asarray(Image.open(p).convert("L"), np.float32)
                break
        else:
            raise FileNotFoundError(f"mask for {fname}")
        if img.ndim == 2:
            img = img[..., None]
        img = np.stack(
            [_resize_image(img[..., c], self.image_size, False) for c in range(img.shape[-1])],
            axis=-1,
        )
        mask = _resize_image(mask, self.image_size, True)
        img = img / 255.0
        return img, mask

    def _load_npy(self, fname):
        img = np.load(os.path.join(self.img_dir, fname))
        if img.ndim == 3:  # (4,H,W) -> single channel
            img = img[self.channel_idx]
        img = _resize_image(img.astype(np.float32), self.image_size, False)
        # torch .std() is unbiased (ddof=1), as the reference loader uses
        if native_loader.available():
            img = native_loader.standardize(img)
        else:
            img = (img - img.mean()) / (img.std(ddof=1) + 1e-8)
        img = img[..., None]
        mask = np.load(os.path.join(self.mask_dir, fname)).astype(np.float32)
        mask = _resize_image(mask, self.image_size, True)
        return img, mask

    def __getitem__(self, idx: int):
        fname = self.files[idx]
        if self.kind == "npy":
            img, mask = self._load_npy(fname)
        else:
            img, mask = self._load_png(fname)
        if self.binarize_mask:
            mask = native_loader.binarize(mask) if native_loader.available() else mask > 0
            mask = mask.astype(np.int32)
        else:
            mask = mask.astype(np.int32)
        return {"image": img.astype(np.float32), "label": mask}, fname
