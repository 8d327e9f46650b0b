"""accunet_tpu_torch ops vs the JAX package's ops (accunet_tpu/ops/pooling.py,
ops/conv.py): the same numpy inputs through both sides, NHWC on both.

Tolerance 1e-5 (fp32, CPU): the pools, resamples and interleaves are exact
reorderings or same-order reductions; the convolutions differ only in the
summation order of the backends."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accunet_tpu.ops import conv as jconv
from accunet_tpu.ops import pooling as jpool
from accunet_tpu.nn.acc_blocks import lrelu as jlrelu
from accunet_tpu_torch.ops import conv as tconv
from accunet_tpu_torch.ops import pooling as tpool
from accunet_tpu_torch.ops.activation import lrelu as tlrelu

TOL = dict(atol=1e-5, rtol=1e-5)


def _x(shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def _both(fn_j, fn_t, *arrays, **kw):
    want = np.asarray(fn_j(*(jnp.asarray(a) for a in arrays), **kw))
    got = fn_t(*(torch.from_numpy(a) for a in arrays), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("s", [1, 2, 4])
@pytest.mark.parametrize("op", ["avg_pool2d", "max_pool2d", "upsample_nearest"])
def test_pool_and_upsample(op, s):
    _both(getattr(jpool, op), getattr(tpool, op), _x((2, 8, 16, 5)), s=s)


def test_avg_pool2d_floors_a_ragged_map():
    """A window that does not divide the map drops the ragged edge, as JAX's
    VALID reduce_window does: (1, 7, 7, 2) with s 2 gives (1, 3, 3, 2)."""
    x = _x((1, 7, 7, 2))
    assert tuple(tpool.avg_pool2d(torch.from_numpy(x), 2).shape) == (1, 3, 3, 2)
    _both(jpool.avg_pool2d, tpool.avg_pool2d, x, s=2)


def test_global_avg_pool():
    _both(jpool.global_avg_pool, tpool.global_avg_pool, _x((2, 8, 8, 6)))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_hanc_features_variant_order(k):
    _both(jpool.hanc_features, tpool.hanc_features, _x((2, 8, 8, 3)), k=k)


def test_interleave_channels():
    _both(jpool.interleave_channels, tpool.interleave_channels,
          _x((2, 4, 4, 3), 0), _x((2, 4, 4, 3), 1))


def test_lrelu():
    _both(jlrelu, tlrelu, _x((64,)))


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_conv2d_same(k):
    x, w, b = _x((2, 9, 7, 3)), _x((k, k, 3, 5), 1), _x((5,), 2)
    want = np.asarray(jconv.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = tconv.conv2d(torch.from_numpy(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                       torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_depthwise_conv2d():
    x, w, b = _x((2, 8, 8, 6)), _x((3, 3, 1, 6), 1), _x((6,), 2)
    want = np.asarray(jconv.depthwise_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = tconv.depthwise_conv2d(torch.from_numpy(x),
                                 torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                                 torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_conv1x1_matches_conv2d():
    x, w, b = _x((2, 4, 4, 6)), _x((5, 6, 1, 1), 1), _x((5,), 2)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    np.testing.assert_allclose(tconv.conv1x1(xt, wt, bt).numpy(),
                               tconv.conv2d(xt, wt, bt).numpy(), **TOL)


def test_conv_transpose_2x2():
    x, w, b = _x((2, 4, 5, 6)), _x((2, 2, 6, 3), 1), _x((3,), 2)
    want = np.asarray(jconv.conv_transpose_2x2(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    # the port keeps torch's ConvTranspose2d layout (I, O, kh, kw)
    wt = torch.from_numpy(w.transpose(2, 3, 0, 1).copy())
    got = tconv.conv_transpose_2x2(torch.from_numpy(x), wt, torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # and it is torch's own ConvTranspose2d(k=2, s=2)
    ref = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), wt, torch.from_numpy(b), stride=2
    ).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
