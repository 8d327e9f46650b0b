"""The port's mask resize against cv2 and the JAX package's loader.

`accunet_tpu_torch.data.dataset._resize_image(..., nearest=True)` resizes
label masks without cv2; the JAX package resizes them with
`cv2.resize(INTER_NEAREST)`. Both must pick the same source pixel for every
output pixel, or dice and IoU differ at label boundaries. 450x600 -> 224 and
300x200 -> 224 are shapes where floor(i * in / out) picks another pixel than
cv2 does. Exact equality, no tolerance: a nearest resize copies values."""

import pathlib

import numpy as np
import pytest

from accunet_tpu.data.dataset import _resize_image as jax_resize
from accunet_tpu_torch.data.dataset import _resize_image as port_resize

cv2 = pytest.importorskip("cv2")

SHAPES = [((450, 600), 224), ((300, 200), 224), ((100, 37), 64), ((513, 511), 256),
          ((224, 224), 512), ((7, 9), 32), ((1000, 750), 224), ((480, 640), 256)]


def _mask(shape, seed):
    return np.random.default_rng(seed).integers(0, 4, shape).astype(np.float32)


@pytest.mark.parametrize("shape,size", SHAPES)
def test_nearest_resize_equals_cv2_and_jax(shape, size):
    m = _mask(shape, sum(shape) + size)
    got = port_resize(m, size, nearest=True)
    assert got.shape == (size, size)
    np.testing.assert_array_equal(
        got, cv2.resize(m, (size, size), interpolation=cv2.INTER_NEAREST))
    np.testing.assert_array_equal(got, jax_resize(m, size, nearest=True))


def test_port_does_not_import_cv2():
    root = pathlib.Path(__file__).resolve().parents[1] / "accunet_tpu_torch"
    hits = [str(p) for p in root.rglob("*.py")
            if any(ln.strip().startswith(("import cv2", "from cv2"))
                   for ln in p.read_text().splitlines())]
    assert not hits
