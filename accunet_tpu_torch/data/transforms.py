"""Host-side validation transform (numpy, NHWC): a copy of `ValGenerator`
from accunet_tpu/data/transforms.py — cubic zoom of the image and nearest
zoom of the mask to the output size. The training augmentations wait for the
train slice of the port."""

from __future__ import annotations

import numpy as np
from scipy.ndimage import zoom


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


class ValGenerator:
    def __init__(self, output_size):
        self.output_size = tuple(output_size)

    def __call__(self, sample, rng=None):
        image, label = _zoom_to(sample["image"], sample["label"], self.output_size)
        return {
            "image": np.ascontiguousarray(image, np.float32),
            "label": np.ascontiguousarray(label, np.int32),
        }
