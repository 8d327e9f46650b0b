"""Host-side joint image/mask transforms (numpy, NHWC): a copy of
accunet_tpu/data/transforms.py.

  * random_rot_flip — k*90 degree rotation + a random H/V flip
  * random_rotate   — +-20 degree nearest-order rotation, reshape=False
  * RandomGenerator — 50% rot_flip, else (50% of the rest) rotate, then a
    cubic zoom of the image / nearest zoom of the mask to the output size
  * ValGenerator    — zoom only

Every call takes an explicit np.random.Generator (the loader derives it from
(seed, epoch, sample index)), so augmentation repeats on any host.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage
from scipy.ndimage import zoom


def random_rot_flip(image, label, rng: np.random.Generator):
    k = int(rng.integers(0, 4))
    image = np.rot90(image, k)
    label = np.rot90(label, k)
    axis = int(rng.integers(0, 2))
    image = np.flip(image, axis=axis).copy()
    label = np.flip(label, axis=axis).copy()
    return image, label


def random_rotate(image, label, rng: np.random.Generator):
    angle = int(rng.integers(-20, 20))
    image = ndimage.rotate(image, angle, order=0, reshape=False)
    label = ndimage.rotate(label, angle, order=0, reshape=False)
    return image, label


def _zoom_to(image, label, out_hw):
    x, y = image.shape[:2]
    if (x, y) != tuple(out_hw):
        zf = (out_hw[0] / x, out_hw[1] / y)
        if image.ndim == 3:
            image = np.stack(
                [zoom(image[..., c], zf, order=3) for c in range(image.shape[-1])],
                axis=-1,
            )
        else:
            image = zoom(image, zf, order=3)
        label = zoom(label, zf, order=0)
    return image, label


class RandomGenerator:
    def __init__(self, output_size):
        self.output_size = tuple(output_size)

    def __call__(self, sample, rng: np.random.Generator):
        image, label = sample["image"], sample["label"]
        if rng.random() > 0.5:
            image, label = random_rot_flip(image, label, rng)
        elif rng.random() < 0.5:
            image, label = random_rotate(image, label, rng)
        image, label = _zoom_to(image, label, self.output_size)
        return {
            "image": np.ascontiguousarray(image, np.float32),
            "label": np.ascontiguousarray(label, np.int32),
        }


class ValGenerator:
    def __init__(self, output_size):
        self.output_size = tuple(output_size)

    def __call__(self, sample, rng=None):
        image, label = _zoom_to(sample["image"], sample["label"], self.output_size)
        return {
            "image": np.ascontiguousarray(image, np.float32),
            "label": np.ascontiguousarray(label, np.int32),
        }
