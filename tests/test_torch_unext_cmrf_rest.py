"""The port's last 16 UNext_CMRF names and their blocks vs the JAX package on
the CPU.

  * blocks, forward: ODConv2d with one kernel for the batch (1x1, kernel_num
    1), a per-sample spatial attention (depthwise 3x3), a per-sample kernel
    attention (1x1, kernel_num 4) and all four attentions (3x3, kernel_num
    4, a filter attention), in eval mode and in a train-mode forward with
    its BN statistics; CMRF_OD in a batch-1 train-mode forward, where each
    ODAttention's BN sees one value a channel and returns its shift; BSRB
    with its proj, CMRF_BS with BSConvU and BSRB chains; ChannelSpatialSE;
    InjectionMultiSum and InjectionMultiSumCBR; the GAB (dilations 1, 2, 5,
    7), and its dilated depthwise conv in bf16 against fp32 (a bf16 weight
    gradient at dilation > 1 refused on the CPU); GHPA; the Haar
    and adaptive wavelet pools (Haar and perturbed, asymmetric filters, a
    ragged map) and product_filter_loss; JacobiRKAN and PadeRKAN alone;
  * blocks, gradients: ODConv2d (train mode), the GAB and the rational
    bases against jax.vjp in float64, the JacobiRKAN KANLinear in fp32;
  * whole models, b2 64x64: the eval forward of the five names that cover
    every new axis (_enc_CSSE, _GAB_wavelet_OD, _BSRB_GS, _BS_GS_Wavelet,
    _GS_Wavelet_rKAN); _GAB_wavelet_OD in a train-mode forward with every
    running statistic, and in bf16.

Weights: a seeded numpy tree shaped by `jax.eval_shape` of the JAX init,
loaded by `state_dict_from_jax` with a strict load; one FAST_COMPILE jit per
JAX function (a VJP through a grouped conv needs XLA's
convolution-group-converter pass, which GRAD_COMPILE keeps).

Tolerances: 1e-5 in fp32 (TOL, elementwise relative and absolute, or of the
largest magnitude where `_rel` says so). In float64 (F64_TOL): the Haar pool
on N(0, 1) data, where its rescale mean(x) / mean(LL) over the whole tensor
is a ratio of two means near 0, which fp32 sums taken in another order do
not keep to 1e-5; the rational bases alone, whose fp32 values sit 5-8e-4
from float64 on either side (PadeRKAN's degree-5 terms cancel). The
_GAB_wavelet_OD train-mode forward is held in float64 to TRAIN64_TOL: in
fp32 at b2 64x64 its BNs normalise over few values a channel (2 in each
ODAttention, 8 at the bottleneck), and each side's fp32 output departs from
its float64 one (JAX by 2.4e-3, the port by 3.9e-4); JAX computes its
resize's interpolation fractions in fp32 even for float64 maps
(accunet_tpu/ops/resize.py:23-34), which leaves 2e-7 between the two after
the GABs' align_corners=True resizes. Float64 gradients to 1e-6 of each
gradient's scale (the JAX side comes back through state_dict_from_jax in
fp32); the JacobiRKAN KANLinear's fp32 gradients (KANLinear computes in fp32
on both sides, whatever the input's type) to KAN_GRAD_TOL of each
gradient's scale: the base's scalar parameters take sums over every input
element with terms of both signs (1.1e-4 apart on beta). The bf16 logits to
BF16_TOL of the largest (the bar of the UNet baselines' bf16 tests,
tests/test_torch_unets.py): each side's bf16 forward of this model sits
1.5e-2 from the fp32 one and the two 2.1e-2 apart, as UNext_CMRF's sit
1.1-1.3e-2 and 1.2e-2 (they round at other points: the port's
ChannelsFirstLN normalises in fp32, JAX's in bf16); and no further from the
fp32 logits than twice JAX's bf16 ones are, and no nearer than a
quarter of that, with every GAB's output in bf16: an fp32 forward would sit
within TOL of the fp32 logits.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accunet_tpu.models.unext_cmrf import build_unext_cmrf as j_build
from accunet_tpu.nn import cmrf_blocks as JC
from accunet_tpu.nn import kan as JK
from accunet_tpu_torch.models import build
from accunet_tpu_torch.nn import cmrf_blocks as TC
from accunet_tpu_torch.nn import kan as TK
from accunet_tpu_torch.port import state_dict_from_jax
from tests.test_torch_knunet import rational_base_params
from tests.test_torch_unext import (
    FAST_COMPILE,
    TOL,
    _port,
    _stats_match,
    _variables,
    _x,
    jax_forward,
    jax_run,
)
from tests.test_torch_unext import _one_torch_thread  # noqa: F401

GRAD_COMPILE = {k: o for k, o in FAST_COMPILE.items() if k != "xla_disable_hlo_passes"}
F64_TOL = 1e-10
TRAIN64_TOL = 1e-6
KAN_GRAD_TOL = 1e-3
BF16_TOL = 3e-2
COVERING = ("UNext_CMRF_enc_CSSE", "UNext_CMRF_GAB_wavelet_OD", "UNext_CMRF_BSRB_GS",
            "UNext_CMRF_BS_GS_Wavelet", "UNext_CMRF_GS_Wavelet_rKAN")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _eval_and_train(jmod, tmod, *xs, n_stats):
    """jmod / tmod (weights from one numpy tree) in eval mode and in a
    train-mode forward with their BN statistics, on the numpy inputs xs."""
    v = _variables(jmod, *xs)
    port = _port(tmod, v)
    want, (want_t, upd) = jax_run(
        lambda vv, *a: (jmod.apply(vv, *a), jmod.apply(vv, *a, train=True,
                                                       mutable=["batch_stats"])),
        v, *map(jnp.asarray, xs))
    with torch.no_grad():
        got = port.eval()(*map(torch.from_numpy, xs)).numpy()
        got_t = port.train()(*map(torch.from_numpy, xs)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got_t, want_t, **TOL)
    assert _stats_match(port, upd) == 2 * n_stats


# (in, out, k, groups, kernel_num): which attentions make the kernel per
# sample
OD_CASES = {"shared_1x1": (6, 10, 1, 1, 1),
            "depthwise_spatial": (8, 8, 3, 8, 1),
            "kernels4_1x1": (6, 10, 1, 1, 4),
            "kernels4_filter_3x3": (6, 10, 3, 1, 4)}


@pytest.mark.parametrize("case", OD_CASES)
def test_odconv2d_matches_jax(case):
    cin, cout, k, g, kn = OD_CASES[case]
    x = _x((2, 7, 9, cin))
    port = TC.ODConv2d(cin, cout, k, groups=g, kernel_num=kn)
    att = port.attention
    assert (hasattr(att, "filter_fc"), hasattr(att, "spatial_fc"), hasattr(att, "kernel_fc")) \
        == (cin != g, k > 1, kn > 1)
    _eval_and_train(JC.ODConv2d(cin, cout, k, groups=g, kernel_num=kn), port, x, n_stats=1)


def test_cmrf_od_batch1_train_matches_jax():
    """CMRF_OD(8, 16) at batch 1: eval, and a train-mode forward in which
    each of its 9 ODAttention BNs normalises one value a channel (variance
    0: flax returns the BN's shift), with all 18 BNs' statistics."""
    _eval_and_train(JC.CMRF_OD(8, 16), TC.CMRF_OD(8, 16), _x((1, 8, 8, 8)), n_stats=18)


@pytest.mark.parametrize("case", ["bsrb_proj", "cmrf_bs", "cmrf_bsrb"])
def test_bs_blocks_match_jax(case):
    """BSRB from 6 to 10 channels (its proj), CMRF_BS(16, 16) with a BSConvU
    and with a BSRB chain (the residual; pwconv1 / pwconv2's BNs)."""
    if case == "bsrb_proj":
        x = _x((2, 6, 5, 6))
        v = _variables(JC.BSRB(10), x)
        want = jax_run(lambda vv, xx: JC.BSRB(10).apply(vv, xx), v, jnp.asarray(x))
        with torch.no_grad():
            got = _port(TC.BSRB(6, 10), v)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        return
    block = {"cmrf_bs": "bsconv", "cmrf_bsrb": "bsrb"}[case]
    _eval_and_train(JC.CMRF_BS(16, 16, block=block), TC.CMRF_BS(16, 16, block=block),
                    _x((2, 8, 8, 16)), n_stats=2)


def test_csse_matches_jax():
    x = _x((2, 6, 5, 16))
    jmod = JC.ChannelSpatialSE(16)
    v = _variables(jmod, x)
    want = jax_run(lambda vv, xx: jmod.apply(vv, xx), v, jnp.asarray(x))
    with torch.no_grad():
        got = _port(TC.ChannelSpatialSE(16), v)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("cbr", [False, True])
def test_injection_multisum_matches_jax(cbr):
    """x_l (2, 8, 8, 10), x_g (2, 3, 3, 14) -> 12 channels: the global terms
    resized 3 -> 8; the CBR form's global_act without its BN."""
    jcls, tcls = ((JC.InjectionMultiSumCBR, TC.InjectionMultiSumCBR) if cbr
                  else (JC.InjectionMultiSum, TC.InjectionMultiSum))
    _eval_and_train(jcls(12), tcls(10, 14, 12), _x((2, 8, 8, 10)), _x((2, 3, 3, 14), 1),
                    n_stats=2 if cbr else 3)


def _gab_inputs():
    return _x((2, 4, 4, 24)), _x((2, 8, 8, 16), 1), _x((2, 8, 8, 1), 2)


def test_gab_matches_jax():
    """GroupAggregationBridge(24 -> 16) on an 8x8 map: four groups of 9
    channels, depthwise 3x3 dilated 1, 2, 5, 7 (padding up to 7 of 8)."""
    xs = _gab_inputs()
    jmod = JC.GroupAggregationBridge(16)
    v = _variables(jmod, *xs)
    want = jax_run(lambda vv, *a: jmod.apply(vv, *a), v, *map(jnp.asarray, xs))
    port = _port(TC.GroupAggregationBridge(24, 16), v)
    assert [getattr(port, f"g{i}_conv").weight.shape[0] for i in range(4)] == [9] * 4
    with torch.no_grad():
        got = port(*map(torch.from_numpy, xs)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("d", [1, 2, 5, 7])
def test_dilated_depthwise_conv2d_bf16_grads(d):
    """ops.conv.dilated_depthwise_conv2d on the CPU: in fp32 its output and
    its input, weight and bias gradients held to the float64 conv's; in bf16
    its output and input gradient within 1e-2 of fp32's (bf16 inputs, fp32
    sums), its weight and bias gradients too at dilation 1, and a bf16
    weight gradient at dilation > 1 refused (torch's CPU one is wrong)."""
    from accunet_tpu_torch.ops.conv import dilated_depthwise_conv2d

    rs = np.random.RandomState(d)
    x, w, b = rs.standard_normal((2, 32, 32, 9)), 0.3 * rs.standard_normal((9, 1, 3, 3)), \
        rs.standard_normal(9)
    gy = rs.standard_normal((2, 32, 32, 9))
    out = {}
    for dt in (torch.bfloat16, torch.float32, torch.float64):
        params = dt != torch.bfloat16 or d == 1
        xt = torch.tensor(x, dtype=dt, requires_grad=True)
        wt, bt = (torch.tensor(a, dtype=dt, requires_grad=params) for a in (w, b))
        y = dilated_depthwise_conv2d(xt, wt, bt, d)
        y.backward(torch.tensor(gy, dtype=dt))
        out[dt] = [t.detach().double().numpy() for t in (y, xt.grad)]
        if params:
            out[dt] += [t.grad.double().numpy() for t in (wt, bt)]
    assert len(out[torch.bfloat16]) == (4 if d == 1 else 2)
    for got, want in zip(out[torch.bfloat16], out[torch.float32]):
        assert _rel(got, want) <= 1e-2
    for got, want in zip(out[torch.float32], out[torch.float64]):
        assert _rel(got, want) <= TOL["rtol"]
    if d > 1:
        wt = torch.tensor(w, dtype=torch.bfloat16, requires_grad=True)
        with pytest.raises(NotImplementedError, match="dilated bf16 depthwise"):
            dilated_depthwise_conv2d(torch.tensor(x, dtype=torch.bfloat16), wt, None, d)


def test_ghpa_matches_jax():
    """GHPA(16 -> 12) on a 8x6 map (H != W tells the zx and zy gates apart),
    its grids perturbed from their ones."""
    x = _x((2, 8, 6, 16))
    jmod = JC.GHPA(16, 12)
    v = _variables(jmod, x)
    for name in ("params_xy", "params_zx", "params_zy"):
        v["params"][name] = 1.0 + v["params"][name]
    want = jax_run(lambda vv, xx: jmod.apply(vv, xx), v, jnp.asarray(x))
    with torch.no_grad():
        got = _port(TC.GHPA(16, 12), v)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("dist,shape", [("uniform", (2, 16, 16, 6)), ("uniform", (2, 9, 7, 5)),
                                        ("normal64", (2, 16, 16, 6))])
def test_haar_wavelet_pool_matches_jax(dist, shape):
    """The LL band rescaled by mean(x) / mean(LL) over the whole tensor: in
    fp32 on [0, 1) data (a ragged 9x7 map drops its last row and column from
    the band, not from mean(x)), in float64 on N(0, 1) data."""
    rs = np.random.RandomState(9)
    if dist == "uniform":
        x = rs.rand(*shape).astype(np.float32)
        want = jax_run(JC.haar_wavelet_pool2d, jnp.asarray(x))
        np.testing.assert_allclose(TC.haar_wavelet_pool2d(torch.from_numpy(x)).numpy(), want,
                                   **TOL)
        return
    x = rs.standard_normal(shape)
    with jax.enable_x64(True):
        want = jax_run(JC.haar_wavelet_pool2d, jnp.asarray(x))
    got = TC.haar_wavelet_pool2d(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 8, 8, 6) and _rel(got, want) <= F64_TOL


@pytest.mark.parametrize("lo,hi", [([2.0 ** -0.5, 2.0 ** -0.5], [2.0 ** -0.5, -(2.0 ** -0.5)]),
                                   ([0.55, 0.83], [-0.8, 0.6])])
def test_adaptive_wavelet_pool_matches_jax(lo, hi):
    """The learnable pool at Haar and at asymmetric filters (the flipped
    dec_lo shows), on a ragged 9x7 map; product_filter_loss; a fresh module
    holds the Haar filters."""
    x = np.random.RandomState(10).rand(2, 9, 7, 5).astype(np.float32)
    params = {"dec_lo": np.float32(lo), "scales_weights": np.ones(1, np.float32),
              "dec_hi": np.float32(hi)}
    want, want_loss = jax_run(
        lambda p, xx: (JC.AdaptiveWaveletPool2d().apply({"params": p}, xx),
                       JC.AdaptiveWaveletPool2d.product_filter_loss(p["dec_lo"], p["dec_hi"])),
        params, jnp.asarray(x))
    port = TC.AdaptiveWaveletPool2d()
    assert torch.allclose(port.dec_lo, torch.full((2,), 2.0 ** -0.5))
    port.load_state_dict({k: torch.from_numpy(a) for k, a in params.items()}, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
        loss = TC.AdaptiveWaveletPool2d.product_filter_loss(port.dec_lo, port.dec_hi)
    assert got.shape == (2, 4, 3, 5)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("base", ["rkan", "pade"])
def test_rational_bases_match_jax_in_float64(base):
    """JacobiRKAN and PadeRKAN alone, in float64 (PadeRKAN's degree-5 terms
    cancel in fp32: either side sits 5-8e-4 from its float64 value), their
    parameters near the initial ones."""
    x = 2.0 * np.random.RandomState(4).standard_normal((10, 12))
    jmod = JK.JacobiRKAN(3) if base == "rkan" else JK.PadeRKAN(2, 6)
    tmod = TK.JacobiRKAN() if base == "rkan" else TK.PadeRKAN()
    p = rational_base_params(_variables(jmod, x.astype(np.float32))["params"])
    with jax.enable_x64(True):
        want = jax_run(lambda pp, xx: jmod.apply({"params": pp}, xx), _f64(p), jnp.asarray(x))
    tmod.load_state_dict({k: torch.from_numpy(a) for k, a in p.items()}, strict=True)
    with torch.no_grad():
        got = tmod.double()(torch.from_numpy(x)).numpy()
    assert _rel(got, want) <= F64_TOL


def _port_grads(port, inputs, gy, train):
    """Gradients of the inputs and of every parameter of `port` (float64)
    under the cotangent gy."""
    port = port.double().train(train)
    xs = [torch.from_numpy(a).double().requires_grad_(True) for a in inputs]
    port(*xs).backward(torch.from_numpy(gy).double())
    return [x.grad for x in xs], {n: p.grad for n, p in port.named_parameters()}


def _check_grads(got_x, got_p, want_x, want_v, tol):
    dv = state_dict_from_jax(want_v)
    grads = {**{f"x{i}": (g, w) for i, (g, w) in enumerate(zip(got_x, want_x))},
             **{n: (g, dv[n]) for n, g in got_p.items()}}
    for name, (g, w) in grads.items():
        w = np.asarray(w, np.float64)
        if g is None:  # a parameter the function does not read: JAX's zero
            assert not w.any(), name
            continue
        np.testing.assert_allclose(g.double().numpy(), w, rtol=0,
                                   atol=tol * max(np.abs(w).max(), 1e-30), err_msg=name)
    return len(grads)


def _jax_vjp64(jmod, v, inputs, gy, train):
    def f(vv, *xs):
        if train:
            return jmod.apply(vv, *xs, train=True, mutable=["batch_stats"])[0]
        return jmod.apply(vv, *xs)

    with jax.enable_x64(True):
        args = (_f64(v), [jnp.asarray(a, jnp.float64) for a in inputs],
                jnp.asarray(gy, jnp.float64))
        out = jax.jit(lambda vv, xs, g: jax.vjp(f, vv, *xs)[1](g)).lower(*args).compile(
            compiler_options=GRAD_COMPILE)(*args)
    dv, *dxs = jax.tree_util.tree_map(np.asarray, out)
    return dv, dxs


@pytest.mark.parametrize("case", ["shared_1x1", "kernels4_filter_3x3"])
def test_odconv2d_grads_match_jax(case):
    """Train mode (the attention's BN on batch statistics), float64: the
    input's and all parameters' gradients (the raw 5-D weight; fc, its BN,
    channel_fc, filter_fc, and for 3x3 / kernel_num 4 spatial_fc and
    kernel_fc)."""
    cin, cout, k, g, kn = OD_CASES[case]
    x, gy = _x((2, 7, 9, cin)), _x((2, 7, 9, cout), 1)
    jmod = JC.ODConv2d(cin, cout, k, groups=g, kernel_num=kn, dtype=jnp.float64)
    v = _variables(jmod, x)
    dv, dxs = _jax_vjp64(jmod, v, [x], gy, train=True)
    port = _port(TC.ODConv2d(cin, cout, k, groups=g, kernel_num=kn), v)
    got_x, got_p = _port_grads(port, [x], gy, train=True)
    assert _check_grads(got_x, got_p, dxs, dv, 1e-6) == 1 + (8 if k == 1 else 12)


def test_gab_grads_match_jax():
    """Float64 gradients of xh, xl, the mask and all 22 parameters."""
    xs = _gab_inputs()
    gy = _x((2, 8, 8, 16), 3)
    jmod = JC.GroupAggregationBridge(16, dtype=jnp.float64)
    v = _variables(jmod, *xs)
    dv, dxs = _jax_vjp64(jmod, v, xs, gy, train=False)
    port = _port(TC.GroupAggregationBridge(24, 16), v)
    got_x, got_p = _port_grads(port, xs, gy, train=False)
    assert _check_grads(got_x, got_p, dxs, dv, 1e-6) == 3 + 22


@pytest.mark.parametrize("case", ["rkan_kan_linear", "rkan_base_f64", "pade_base_f64"])
def test_rational_kan_grads_match_jax(case):
    """KANLinear(12, 7) with JacobiRKAN (the rKAN model's), fp32 on both
    sides: the input's gradient and every parameter's, the base's too; and
    each rational base alone in float64 (PadeRKAN's fp32 gradients depart
    from each other by up to 0.9%, beta_q's, as its values do by 5-8e-4 from
    float64; its [2/6] form reads no alpha_p, beta_p or zeta_p: JAX's zero
    gradient, the port's None)."""
    base = case[:4]
    x, gy = 1.5 * _x((10, 12)), _x((10, 7), 1)
    if case == "rkan_kan_linear":
        jmod = JK.KANLinear(12, 7, base_activation=base)
        v = _variables(jmod, x)
        v["params"]["base_activation"] = rational_base_params(v["params"]["base_activation"])
        dv, dx = jax_run(lambda vv, xx, gg: jax.vjp(lambda a, b: jmod.apply(a, b), vv, xx)[1](gg),
                         v, jnp.asarray(x), jnp.asarray(gy))
        port = _port(TK.KANLinear(12, 7, base_activation=base), v)
        xt = torch.from_numpy(x).requires_grad_(True)
        port(xt).backward(torch.from_numpy(gy))
        got_p = {n: p.grad for n, p in port.named_parameters()}
        assert _check_grads([xt.grad], got_p, [dx], dv, KAN_GRAD_TOL) == 1 + 3 + 3
        return
    gy = _x((10, 12), 1)
    jmod = JK.JacobiRKAN(3) if base == "rkan" else JK.PadeRKAN(2, 6)
    v = {"params": rational_base_params(_variables(jmod, x)["params"])}
    dv, dxs = _jax_vjp64(jmod, v, [x], gy, train=False)
    port = TK.JacobiRKAN() if base == "rkan" else TK.PadeRKAN()
    port.load_state_dict({k: torch.from_numpy(a) for k, a in v["params"].items()}, strict=True)
    got_x, got_p = _port_grads(port, [x], gy, train=False)
    assert _check_grads(got_x, got_p, dxs, dv, 1e-6) == 1 + (3 if base == "rkan" else 8)


@pytest.mark.parametrize("name", COVERING)
def test_covering_names_eval_match_jax(name):
    """The eval forward at b2 64x64 in fp32."""
    x = _x((2, 64, 64, 3))
    jmod = j_build(name)
    v = _variables(jmod, x)
    want = jax_run(lambda vv, xx: jmod.apply(vv, xx), v, jnp.asarray(x))
    with torch.no_grad():
        got = _port(build(name, n_channels=3, n_classes=1), v).eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 64, 64, 1)
    np.testing.assert_allclose(got, want, **TOL)


def test_gab_wavelet_od_train_and_bf16_match_jax():
    """UNext_CMRF_GAB_wavelet_OD at b2 64x64: a train-mode forward and the
    running statistics of its 58 BNs (9 ODAttention and 9 ODConvBNAct BNs in
    each of the 3 CMRF_OD encoders, dbn1-dbn4) in float64 (TRAIN64_TOL),
    then the bf16 logits (compute dtype bfloat16 on both sides) to BF16_TOL
    of the largest, and no further from the fp32 logits (the port's, which
    test_covering_names_eval_match_jax holds to JAX's) than twice JAX's bf16
    ones are, nor nearer than a quarter of that, with all four GABs' outputs
    in bf16."""
    name = "UNext_CMRF_GAB_wavelet_OD"
    x = _x((2, 64, 64, 3))
    jmod = j_build(name, dtype=jnp.float64)
    v = _variables(jmod, x)
    port = _port(build(name, n_channels=3, n_classes=1), v).double()
    with jax.enable_x64(True):
        _, (want_t, upd) = jax_forward(jmod, _f64(v), x.astype(np.float64))
    with torch.no_grad():
        got_t = port.train()(torch.from_numpy(x).double()).numpy()
    assert _rel(got_t, want_t) <= TRAIN64_TOL
    assert _stats_match(port.float(), upd) == 2 * 58

    jb = j_build(name, dtype=jnp.bfloat16, final_sigmoid=False)
    want_b = jax_run(lambda vv, xx: jb.apply(vv, xx), v, jnp.asarray(x))
    tb = _port(build(name, n_channels=3, n_classes=1, final_sigmoid=False), v).eval()
    gab_dtypes = []
    hooks = [getattr(tb, f"GAB{i}").register_forward_hook(
        lambda mod, inp, out: gab_dtypes.append(out.dtype)) for i in (1, 2, 3, 4)]
    with torch.no_grad():
        ref32 = tb(torch.from_numpy(x)).numpy()  # JAX's fp32 logits within TOL
        tb.dtype = torch.bfloat16
        got_b = tb(torch.from_numpy(x)).numpy()
    for h in hooks:
        h.remove()
    assert gab_dtypes == [torch.float32] * 4 + [torch.bfloat16] * 4
    assert got_b.dtype == np.float32 and _rel(got_b, want_b) <= BF16_TOL
    assert 0.25 * _rel(want_b, ref32) <= _rel(got_b, ref32) <= 2 * _rel(want_b, ref32)
