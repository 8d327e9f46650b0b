"""The port's UNeXt slice vs the JAX package on the CPU.

  * `resize_bilinear` / `upsample_bilinear_2x` in both modes, a non-2x ratio
    and outputs of size 1 (where JAX samples source 0 and torch the centre);
  * `axial_shift` at C 6, 128, 160, 256 along H and W: exact;
  * `ShiftedBlock`: the fp32 forward, and in float64 the input and parameter
    gradients vs `jax.vjp` (the DWConv's dw from the plain wgrad);
  * `CMRF` in eval mode, and a train-mode forward with every BN statistic
    (eps 1e-3, flax momentum 0.97); the port's BatchNorm alone at (1e-3, 0.97);
  * UNext_S in eval mode at 32x32 and at 48x48 (ragged skips, resized with
    align_corners=True; the output is 64x64); UNext at full width, 32x32, in
    eval mode and in a train-mode forward with its BN statistics;
  * the registry names, the initialisers, and the train CLI for one tiny
    UNext_S epoch.

Weights: a seeded numpy tree shaped by `jax.eval_shape` of the JAX init
(nothing compiles for it), loaded into the port by `state_dict_from_jax`
with a strict load. Tolerance 1e-5 in fp32 (the same formulas; sums
reassociate); the float64 gradients to 1e-6 of each gradient's scale after
`state_dict_from_jax` rounds the JAX side to fp32.
"""

import math
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import linen as fnn

from accunet_tpu.models.unext import UNext as JUNext
from accunet_tpu.models.unext import UNext_S as JUNext_S
from accunet_tpu.nn import cmrf_blocks as JC
from accunet_tpu.nn import unext_blocks as JB
from accunet_tpu.ops import resize as JR
from accunet_tpu_torch.models import UNext, UNext_S, build, init_parameters
from accunet_tpu_torch.nn import cmrf_blocks as TC
from accunet_tpu_torch.nn import unext_blocks as TB
from accunet_tpu_torch.nn.acc_blocks import BatchNorm
from accunet_tpu_torch.ops import resize as TR
from accunet_tpu_torch.ops.kernels import dwconv2d as DW
from accunet_tpu_torch.port import state_dict_from_jax
from tests.test_torch_port_model import _numpy_tree

TOL = dict(atol=1e-5, rtol=1e-5)
# XLA CPU options that cut the JAX side's compile to about a second per model
# on one core (tests/test_torch_train_engine.py; the comparisons would catch a
# miscompile); op-by-op eager dispatch compiles every op and costs more
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
                "xla_cpu_use_fusion_emitters": False, "xla_cpu_use_xnnpack": False,
                "xla_cpu_parallel_codegen_split_count": 1,
                "xla_disable_hlo_passes": "convolution-group-converter"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads would only contend with the
    other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def _variables(jmod, *args, seed=1, **kw):
    """A numpy tree of jmod's variables (shapes from jax.eval_shape)."""
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    return _numpy_tree(jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *jargs, **kw)),
                       seed)


def jax_run(fn, *args):
    """fn(*args) through one jit compiled with FAST_COMPILE, as numpy."""
    out = jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)(*args)
    return jax.tree_util.tree_map(np.asarray, out)


def jax_forward(jmod, v, x):
    """The JAX model's eval output and its train-mode output with the
    updated batch_stats, from one compile."""
    return jax_run(lambda vv, xx: (jmod.apply(vv, xx),
                                   jmod.apply(vv, xx, train=True, mutable=["batch_stats"])),
                   v, jnp.asarray(x))


def _port(module, variables):
    module.load_state_dict(state_dict_from_jax(variables), strict=True)
    return module


def _stats_match(port, updates):
    """Every running statistic of `port` equals flax's updated batch_stats."""
    want = state_dict_from_jax({"batch_stats": updates["batch_stats"]})
    got = port.state_dict()
    names = [n for n in want if n.endswith(("running_mean", "running_var"))]
    assert names
    for name in names:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), err_msg=name, **TOL)
    return len(names)


@pytest.mark.parametrize("hw,out,align", [
    ((5, 7), (10, 14), False),   # exact 2x (JAX's depthwise-conv form)
    ((5, 7), (10, 14), True),
    ((6, 4), (9, 11), False),    # non-2x ratios, up and down
    ((6, 9), (4, 5), True),
    ((6, 9), (1, 5), False),     # output size 1: source 0, not the centre
    ((6, 9), (3, 1), True),
    ((3, 4), (1, 1), False),
])
def test_resize_bilinear_matches_jax(hw, out, align):
    x = _x((2, *hw, 3))
    want = jax_run(lambda a: JR.resize_bilinear(a, out, align_corners=align), jnp.asarray(x))
    got = TR.resize_bilinear(torch.from_numpy(x), out, align_corners=align).numpy()
    assert got.shape == want.shape == (2, *out, 3)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("align", [False, True])
def test_upsample_bilinear_2x_matches_jax(align):
    x = _x((2, 7, 5, 4))
    want = jax_run(lambda a: JR.upsample_bilinear_2x(a, align), jnp.asarray(x))
    got = TR.upsample_bilinear_2x(torch.from_numpy(x), align).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_max_pool2d_floors_like_jax():
    """A ragged map (UNeXt's stem on a side that 8 does not divide) drops
    its last row and column, as JAX's reduce_window VALID does."""
    from accunet_tpu.ops.pooling import max_pool2d as j_max_pool2d
    from accunet_tpu_torch.ops.pooling import max_pool2d

    x = _x((2, 9, 7, 3))
    want = jax_run(lambda a: j_max_pool2d(a, 2), jnp.asarray(x))
    got = max_pool2d(torch.from_numpy(x), 2).numpy()
    assert got.shape == want.shape == (2, 4, 3, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c", [6, 128, 160, 256])
def test_axial_shift_is_exact(c):
    x = _x((2, 7, 6, c))
    assert JB._torch_chunk_sizes(c, 5) == TB._torch_chunk_sizes(c, 5)
    want = jax_run(lambda a: (JB.axial_shift(a, 1), JB.axial_shift(a, 2)), jnp.asarray(x))
    for axis, w in zip((1, 2), want):
        np.testing.assert_array_equal(TB.axial_shift(torch.from_numpy(x), axis).numpy(), w)


def test_shifted_block_forward_and_grads_match_jax(monkeypatch):
    """fp32 forward; float64 gradients of the input and every parameter
    against jax.vjp with the same cotangent. The DWConv's dw comes from
    the plain wgrad (DepthwiseConv2dFn on a CPU tensor), once."""
    b, h, w, c = 2, 6, 5, 16
    x, gy = _x((b, h, w, c)), _x((b, h, w, c), 1)
    jmod = JB.ShiftedBlock(c)
    v = _variables(jmod, x.reshape(b, h * w, c), h, w)
    port = _port(TB.ShiftedBlock(c), v)
    want = jax_run(lambda vv, xx: jmod.apply(vv, xx, h, w), v,
                   jnp.asarray(x.reshape(b, h * w, c)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want.reshape(b, h, w, c), **TOL)

    with jax.enable_x64(True):
        j64 = JB.ShiftedBlock(c, dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)
        dv, dx = jax_run(
            lambda vv, xx, gg: jax.vjp(lambda a, t: j64.apply(a, t, h, w), vv, xx)[1](gg), v64,
            *(jnp.asarray(a.reshape(b, h * w, c), jnp.float64) for a in (x, gy)))
    dx = dx.reshape(b, h, w, c)
    dv = state_dict_from_jax(dv)
    calls = []
    plain = DW.dwconv2d_wgrad_reference
    monkeypatch.setattr(DW, "dwconv2d_wgrad_reference",
                        lambda *a: calls.append(a[0].dtype) or plain(*a))
    port = port.double()
    xt = torch.from_numpy(x).double().requires_grad_(True)
    port(xt).backward(torch.from_numpy(gy).double())
    assert calls == [torch.float64]
    grads = {"x": (xt.grad, dx), **{n: (p.grad, dv[n]) for n, p in port.named_parameters()}}
    assert len(grads) == 1 + 8  # x; norm2, fc1, dwconv, fc2: weight and bias each
    for name, (g, want_g) in grads.items():
        want_g = np.asarray(want_g, np.float64)
        np.testing.assert_allclose(g.numpy(), want_g, rtol=0,
                                   atol=1e-6 * np.abs(want_g).max(), err_msg=name)


def test_batchnorm_statistics_match_flax_at_cmrf_settings():
    """The port's BatchNorm(eps=1e-3, momentum=0.03) in train mode: output
    and running statistics equal flax's BatchNorm(epsilon=1e-3,
    momentum=0.97), biased variance."""
    x = 3 + 2 * _x((4, 5, 5, 6))
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.97, epsilon=1e-3)
    v = _variables(jbn, x)
    want, upd = jax_run(lambda vv, xx: jbn.apply(vv, xx, mutable=["batch_stats"]), v,
                        jnp.asarray(x))
    port = BatchNorm(6, eps=1e-3, momentum=0.03)
    # a root module's keys come out as ".weight", ...
    port.load_state_dict({k[1:]: t for k, t in state_dict_from_jax(v).items()}, strict=True)
    got = port.train()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    want_sd = state_dict_from_jax(upd)
    for name in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(port, name).numpy(), want_sd["." + name].numpy(),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("c1,c2", [(3, 16), (16, 16)])
def test_cmrf_matches_jax(c1, c2):
    """CMRF in eval mode and in a train-mode forward with its 10 BNs'
    statistics (eps 1e-3, flax momentum 0.97); c1 == c2 adds the residual."""
    x = _x((2, 8, 8, c1))
    jmod = JC.CMRF(c1, c2)
    v = _variables(jmod, x)
    port = _port(TC.CMRF(c1, c2), v)
    assert port.add == (c1 == c2)
    want, (want_t, upd) = jax_forward(jmod, v, x)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
        got_t = port.train()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got_t, want_t, **TOL)
    assert _stats_match(port, upd) == 2 * 9


@pytest.mark.parametrize("hw,out", [(32, 32), (48, 64)])
def test_unext_s_eval_matches_jax(hw, out):
    """UNext_S in eval mode. At 48x48 the token maps are 3x3 and 2x2, so
    every skip is ragged and takes the align_corners=True resize."""
    x = _x((2, hw, hw, 3))
    jmod = JUNext_S(3, 1)
    v = _variables(jmod, x)
    want = jax_run(lambda vv, xx: jmod.apply(vv, xx), v, jnp.asarray(x))
    port = _port(UNext_S(3, 1), v).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, out, out, 1)
    np.testing.assert_allclose(got, want, **TOL)


def test_unext_matches_jax():
    """UNext at full width (stem 16/32/128, tokens 128/160/256), 32x32:
    the eval forward, then a train-mode forward and its 20 running
    statistics (momentum 0.9)."""
    x = _x((2, 32, 32, 3))
    jmod = JUNext(3, 1)
    v = _variables(jmod, x)
    port = _port(UNext(3, 1), v)
    want, (want_t, upd) = jax_forward(jmod, v, x)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
        got_t = port.train()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got_t, want_t, **TOL)
    assert _stats_match(port, upd) == 2 * 7


def test_registry_names_build():
    """UNext, UNeXt, UNext_S and the seven plain-CMRF names build with the
    JAX parameter counts; the other CMRF names raise NotImplementedError
    naming the ROADMAP item."""
    counts = {"UNext": 1471921, "UNeXt": 1471921, "UNext_S": 253561,
              "UNext_CMRF": 1440146, "UNext_CMRF_PP": 1440146, "UNext_CMRF_hd": 1440146,
              "UNext_CMRF_enc_dec": 1398038, "UNext_CMRF_enc_MLFC": 1678528,
              "UNext_CMRF_enc_dec_MLFC": 1636420, "UNext_CMRF_dense_skip": 1901426}
    for name, n in counts.items():
        model = build(name, n_channels=3, n_classes=1)
        assert sum(p.numel() for p in model.parameters()) == n, name
    for name in ("UNext_CMRF_GS", "UNext_CMRF_enc_CSSE", "UNext_CMRF_Wavelet",
                 "UNext_CMRF_GAB", "UNext_CMRF_OD", "UNext_CMRF_BS", "UNext_CMRF_BSRB",
                 "UNext_CMRF_GS_Wavelet_rKAN"):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
            build(name, n_channels=3, n_classes=1)


def test_unext_init_follows_jax_initialisers():
    """init_parameters on UNext: LayerNorms (1, 0), biases 0, the token
    MLP's Dense and depthwise kernels lecun-normal (truncated at 2 sigma of
    their fan-in), the same draws for the same seed."""
    m1 = init_parameters(UNext_S(3, 1), torch.Generator().manual_seed(3))
    m2 = init_parameters(UNext_S(3, 1), torch.Generator().manual_seed(3))
    for (n1, p1), (_, p2) in zip(m1.state_dict().items(), m2.state_dict().items()):
        assert torch.equal(p1, p2), n1
    blk = m1.block1[0]
    for ln in (blk.norm2, m1.norm3, m1.patch_embed3.norm):
        assert torch.equal(ln.weight, torch.ones_like(ln.weight)) and not ln.bias.any()
    for lin, fan_in in ((blk.mlp.fc1, 64), (blk.mlp.dwconv.dwconv, 9)):
        cut = 2 * math.sqrt(1 / fan_in) / 0.87962566103423978
        assert not lin.bias.any() and 0 < float(lin.weight.detach().abs().max()) <= cut


def test_unext_train_cli_cpu(tmp_path):
    """The train CLI on the CPU: UNext_S, 32x32, batch 2, one epoch (4
    steps, 2 validation batches) with a checkpoint."""
    from accunet_tpu_torch.cli import train as cli

    argv = ["--model", "UNext_S", "--synthetic", "--img-size", "32", "--batch", "2",
            "--epochs", "1", "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"),
            "--check-numerics"]
    state, hist = cli.main(argv)
    assert state.step == 4 and os.listdir(tmp_path / "ck") == ["epoch_0001.pth.tar"]
    assert hist[0]["val"]["batches"] == 2
    assert all(np.isfinite(hist[0][s]["loss"]) for s in ("train", "val"))
    assert isinstance(state.model.block1[0], TB.ShiftedBlock)
