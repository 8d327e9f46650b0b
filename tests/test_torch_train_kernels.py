"""The train slice's kernels and blocks vs the JAX package, on CPU.

  * `dwconv2d_wgrad` (on a CPU tensor: its plain version) vs the TPU kernel
    `_dwconv2d_wgrad_pallas` in Pallas interpret mode, k = 3 and 7, C = 9
    (cnv11's interior) and 48;
  * `DepthwiseConv2dFn` and `HancMixFn` gradients vs `jax.vjp` of the JAX
    package's `dwconv2d` and `hanc_mix`;
  * the train-mode BatchNorm: a HANCBlock's output and every running
    statistic after one train-mode forward, vs flax's updated batch_stats;
  * `remat=True` (activation checkpointing) gives the same step as without.

Tolerance 1e-5 (the same fp32 formulas; sums reassociate), relative to the
output's scale where the values are sums of many products."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accunet_tpu.nn import acc_blocks as J
from accunet_tpu.ops.pallas.dwconv2d import _dwconv2d_wgrad_pallas, dwconv2d
from accunet_tpu.ops.pallas.hanc import hanc_mix as jax_hanc_mix
from accunet_tpu_torch.models import ACC_UNet, init_parameters
from accunet_tpu_torch.nn import acc_blocks as T
from accunet_tpu_torch.ops.kernels import _build
from accunet_tpu_torch.ops.kernels import dwconv2d as DW
from accunet_tpu_torch.ops.kernels.hanc_mix import HancMixFn
from accunet_tpu_torch.port import state_dict_from_jax
from tests.test_torch_port_model import _numpy_tree

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side runs tiny tensors: torch's intra-op threads would only
    contend with the other test workers for the cores (under pytest-xdist a
    small train step ran ~100x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rs, shape, scale=1.0):
    return (scale * rs.standard_normal(shape)).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close_to_scale(got, want, tol=1e-5):
    """|got - want| <= tol * max|want|, elementwise."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("k,c", [(3, 9), (3, 48), (7, 9), (7, 48)])
def test_wgrad_plain_version_matches_tpu_kernel(k, c):
    rs = np.random.RandomState(k * 100 + c)
    x, g = _rand(rs, (2, 8, 10, c)), _rand(rs, (2, 8, 10, c))
    want = _dwconv2d_wgrad_pallas(jnp.asarray(x), jnp.asarray(g), k, k, interpret=True)
    got = DW.dwconv2d_wgrad(_t(x), _t(g), k, k)
    assert got.dtype == torch.float32 and got.shape == (k, k, c)
    _close_to_scale(got.numpy(), want)


@pytest.mark.parametrize("k", [3, 7])
def test_depthwise_conv_fn_grads_match_jax_vjp(k):
    rs = np.random.RandomState(k)
    c = 12
    x, w, b = _rand(rs, (2, 9, 11, c)), _rand(rs, (k, k, c), 0.3), _rand(rs, (c,), 0.1)
    gy = _rand(rs, (2, 9, 11, c))
    want_y, vjp = jax.vjp(dwconv2d, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    want_dx, want_dw, want_db = vjp(jnp.asarray(gy))

    xt, bt = _t(x, True), _t(b, True)
    wt = _t(w.transpose(2, 0, 1)[:, None], True)  # (C, 1, kh, kw)
    y = DW.DepthwiseConv2dFn.apply(xt, wt, bt)
    y.backward(_t(gy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), **TOL)
    _close_to_scale(wt.grad.numpy()[:, 0].transpose(1, 2, 0), want_dw)
    _close_to_scale(bt.grad.numpy(), want_db)


@pytest.mark.parametrize("k", [2, 3])
def test_hanc_mix_fn_grads_match_jax_vjp(k):
    rs = np.random.RandomState(10 + k)
    c, cout = 6, 5
    x, w, b = _rand(rs, (2, 8, 8, c)), _rand(rs, (c, 2 * k - 1, cout), 0.3), _rand(rs, (cout,), 0.1)
    gy = _rand(rs, (2, 8, 8, cout))
    want_y, vjp = jax.vjp(lambda xx, ww, bb: jax_hanc_mix(xx, ww, bb, k),
                          jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    want = vjp(jnp.asarray(gy))

    leaves = [_t(x, True), _t(w, True), _t(b, True)]
    y = HancMixFn.apply(*leaves, k)
    y.backward(_t(gy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **TOL)
    for got, w_ in zip(leaves, want):
        _close_to_scale(got.grad.numpy(), w_)


def test_train_mode_batchnorm_statistics_match_flax():
    """One train-mode forward of a HANCBlock: the output and every BN's
    running mean and variance equal flax's (momentum 0.9, biased variance).
    torch's own BatchNorm2d would put the unbiased variance, n/(n-1) larger,
    into running_var."""
    rs = np.random.RandomState(0)
    x = _rand(rs, (2, 8, 8, 8))
    jmod = J.HANCBlock(8, 12, k=3, inv_fctr=3)
    v = _numpy_tree(jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), True)),
                    1)
    want, updates = jmod.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])

    port = T.HANCBlock(8, 12, 3, 3)
    port.load_state_dict(state_dict_from_jax(v), strict=True)
    port.train()
    got = port(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    want_sd = state_dict_from_jax({"batch_stats": updates["batch_stats"]})
    got_sd = port.state_dict()
    stats = [n for n in want_sd if n.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 6  # norm1, norm2, hnc.bn, norm, norm3, sqe.bn
    for name in stats:
        np.testing.assert_allclose(got_sd[name].numpy(), want_sd[name].numpy(), err_msg=name, **TOL)


def test_remat_step_matches_the_plain_step():
    """remat=True recomputes each HANCBlock / ResPath / MLFC in the backward:
    the same loss, gradients and running statistics (counted once)."""
    x = torch.from_numpy(np.random.RandomState(3).rand(2, 16, 16, 3).astype(np.float32))
    results = []
    for remat in (False, True):
        model = init_parameters(ACC_UNet(3, 1, 8, remat=remat), torch.Generator().manual_seed(0))
        model.train()
        loss = model(x).square().mean()
        loss.backward()
        results.append((loss.detach(), {n: p.grad for n, p in model.named_parameters()},
                        {n: b.clone() for n, b in model.named_buffers()}))
    (l0, g0, b0), (l1, g1, b1) = results
    assert torch.equal(l0, l1)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-5, atol=1e-7, msg=n)
    for n in b0:
        torch.testing.assert_close(b1[n], b0[n], rtol=0, atol=0, msg=n)


def test_wgrad_partial_buffer_is_bounded():
    """The kernel's partial sums take (ctas, k*k + 1, C) floats; the CTAs per
    channel block fall as C grows, so the grid stays within a few waves of 2
    CTAs/SM x 132 SMs and the buffer near that many channel blocks whatever
    B*H*W is. Every CTA gets at least one (image, segment, row) unit, a
    channel block holds whole 16-byte copies, a segment has a thread per
    column, and the ring of stages fits in shared memory."""
    for b, h, w, c, k, itemsize, vec in [
            (8, 224, 224, 96, 3, 4, True), (64, 224, 224, 96, 3, 4, True),
            (8, 56, 56, 4352, 3, 4, True), (8, 224, 224, 9, 3, 4, False),
            (8, 14, 14, 1536, 3, 2, True), (1, 5, 3, 3, 7, 2, False),
            (2, 9, 300, 40, 5, 4, True), (3, 4, 4, 64, 7, 2, True)]:
        plan = DW.wgrad_plan(b, h, w, c, k, itemsize, vec)
        assert 1 <= plan.ctas <= plan.units
        assert plan.blocks * plan.cb >= c > (plan.blocks - 1) * plan.cb
        assert plan.cb % (16 // itemsize if vec else 1) == 0
        assert plan.ctas * plan.blocks <= max(5 * DW._CTAS_PER_SM * DW._SMS, plan.blocks)
        lanes = DW._THREADS // (plan.cb // ((4 if k == 3 else 2 if k == 5 else 1) if vec else 1))
        assert plan.sw <= lanes and plan.sw * -(-w // plan.sw) >= w
        assert plan.smem <= _build.MAX_SMEM


def test_wgrad_wrapper_refuses_what_the_kernel_does_not_take():
    """A non-CPU tensor reaches the kernel path, whose checks refuse even
    kernels, non-square kernels and non-CUDA devices."""
    x = torch.zeros((1, 8, 8, 4), device="meta")
    for kh, kw in [(4, 4), (3, 5)]:
        with pytest.raises(ValueError, match="kh == kw"):
            DW.dwconv2d_wgrad(x, x, kh, kw)
    with pytest.raises(ValueError, match="CUDA tensor"):
        DW.dwconv2d_wgrad(x, x, 3, 3)
    with pytest.raises(ValueError, match="odd kernels"):
        DW.DepthwiseConv2dFn.apply(torch.zeros(1, 4, 4, 2), torch.zeros(2, 1, 2, 2), None)
