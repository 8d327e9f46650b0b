"""The plain PyTorch versions of the port's three kernels (which is what each
kernel wrapper runs on a CPU tensor) vs the JAX package's TPU kernels, run as
the JAX tests run them on the CPU: `hanc_block_frame` and
`respath_level_frame` in Pallas interpret mode on the s2d frame (packed
input, unpacked output), `hanc_mix` against its XLA formula `_xla_hanc_mix`
(its Pallas path has no interpret switch).

Tolerances: 1e-4 for the fused bodies (BN folding and the telescoped mixes
reassociate fp32 sums), 1e-5 for hanc_mix (same formula, same order).
The CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accunet_tpu.ops import s2d
from accunet_tpu.ops.pallas.hanc import _xla_hanc_mix
from accunet_tpu.ops.pallas.hanc_block import hanc_block_frame
from accunet_tpu.ops.pallas.respath import respath_level_frame
from accunet_tpu_torch.ops.kernels import _build
from accunet_tpu_torch.ops.kernels import hanc_block as HB
from accunet_tpu_torch.ops.kernels import respath as RP
from accunet_tpu_torch.ops.kernels.hanc_block import fold, hanc_block
from accunet_tpu_torch.ops.kernels.hanc_mix import hanc_mix
from accunet_tpu_torch.ops.kernels.respath import respath_level

FUSED_TOL = dict(atol=1e-4, rtol=1e-4)


def _rand(rs, shape, scale=1.0):
    return (scale * rs.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _block_args(k, cin, inv, cout, seed=5):
    """Random HANCBlock weights in the TPU kernel's argument layout."""
    rs = np.random.RandomState(seed)
    e = cin * inv
    args = dict(
        w1=_rand(rs, (cin, e), 0.3), b1=_rand(rs, (e,), 0.1),
        wd=_rand(rs, (3, 3, e), 0.3), bd=_rand(rs, (e,), 0.1),
        wh=_rand(rs, (e, 2 * k - 1, cin), 0.1), bh=_rand(rs, (cin,), 0.1),
        w3=_rand(rs, (cin, cout), 0.3), b3=_rand(rs, (cout,), 0.1),
    )
    bns = {
        nm: (1.0 + _rand(rs, (dim,), 0.1), _rand(rs, (dim,), 0.1))
        for nm, dim in [("norm1", e), ("norm2", e), ("hnc", cin), ("norm", cin),
                        ("norm3", cout)]
    }
    return args, bns


def _jax_block(x, args, bns, k, pre=None):
    a = {n: jnp.asarray(v) for n, v in args.items()}
    jb = {n: (jnp.asarray(s), jnp.asarray(t)) for n, (s, t) in bns.items()}
    order = [a[n] for n in ("w1", "b1", "wd", "bd", "wh", "bh", "w3", "b3")]
    xf = s2d.pack(jnp.asarray(x))
    if pre is None:
        y, sums = hanc_block_frame(xf, *order, jb, k, interpret=True, emit_sums=True)
    else:
        c = x.shape[-1]
        parts = tuple(xf[..., p * c:(p + 1) * c] for p in range(4))
        y, sums = hanc_block_frame(None, *order, jb, k, interpret=True, emit_sums=True,
                                   x_parts=parts, pre=jnp.asarray(pre))
    return np.asarray(s2d.unpack(y)), np.asarray(sums).sum(axis=(1, 2))


def _port_block(x, args, bns, k, pre=None):
    p = fold(*(_t(args[n]) for n in ("w1", "b1", "wd", "bd", "wh", "bh", "w3", "b3")),
             {n: (_t(s), _t(t)) for n, (s, t) in bns.items()})
    y, sums = hanc_block(_t(x), p, k, None if pre is None else _t(pre))
    return y.numpy(), sums.sum(dim=1).numpy()


@pytest.mark.parametrize("k,inv,cout", [(1, 3, 8), (2, 2, 8), (3, 3, 12)])
def test_hanc_block_matches_tpu_kernel(k, inv, cout):
    cin = 8
    x = _rand(np.random.RandomState(0), (2, 16, 16, cin))
    args, bns = _block_args(k, cin, inv, cout)
    want_y, want_s = _jax_block(x, args, bns, k)
    got_y, got_s = _port_block(x, args, bns, k)
    np.testing.assert_allclose(got_y, want_y, **FUSED_TOL)
    # per-image channel-sum totals (the SE squeeze contract)
    np.testing.assert_allclose(got_s, want_s, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("k", [2, 3])
def test_hanc_block_chained_matches_tpu_kernel(k):
    """`pre` = [gate*se_scale, se_shift]: the previous block's SE apply in
    the prologue (JAX: x_parts= / pre=)."""
    cin = 8
    rs = np.random.RandomState(1)
    x = _rand(rs, (2, 16, 16, cin))
    pre = np.stack([1.0 + _rand(rs, (2, cin), 0.2), _rand(rs, (2, cin), 0.1)], axis=1)
    args, bns = _block_args(k, cin, 3, 8, seed=7)
    want_y, want_s = _jax_block(x, args, bns, k, pre)
    got_y, got_s = _port_block(x, args, bns, k, pre)
    np.testing.assert_allclose(got_y, want_y, **FUSED_TOL)
    np.testing.assert_allclose(got_s, want_s, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("has_prev", [False, True])
def test_respath_level_matches_tpu_kernel(has_prev):
    b, h, c = 2, 16, 32
    rs = np.random.RandomState(2)
    x = _rand(rs, (b, h, h, c))
    w = _rand(rs, (3, 3, c, c), 0.1)
    s_bn, t_bn = 1.0 + _rand(rs, (c,), 0.1), _rand(rs, (c,), 0.1)
    y_prev = _rand(rs, (b, h, h, c)) if has_prev else None
    gate = (0.5 + 0.5 * rs.rand(b, c)).astype(np.float32) if has_prev else None
    s_se, t_se = (1.0 + _rand(rs, (c,), 0.1), _rand(rs, (c,), 0.1)) if has_prev else (None, None)

    tile4 = lambda v: jnp.tile(jnp.asarray(v), 4)  # noqa: E731
    jy, jx, jsums = respath_level_frame(
        s2d.pack(jnp.asarray(x)), s2d.pack_conv3x3_kernel(jnp.asarray(w)),
        (tile4(s_bn), tile4(t_bn)),
        s2d.pack(jnp.asarray(y_prev)) if has_prev else None,
        jnp.tile(jnp.asarray(gate), (1, 4)) if has_prev else None,
        (tile4(s_se), tile4(t_se)) if has_prev else None,
        interpret=True,
    )
    opt = (lambda a: None if a is None else _t(a))  # noqa: E731
    y, xn, sums = respath_level(_t(x), _t(w), _t(s_bn), _t(t_bn), opt(y_prev), opt(gate),
                                opt(s_se), opt(t_se))
    np.testing.assert_allclose(y.numpy(), np.asarray(s2d.unpack(jy)), **FUSED_TOL)
    np.testing.assert_allclose(xn.numpy(), np.asarray(s2d.unpack(jx)), **FUSED_TOL)
    want_s = np.asarray(jsums).sum(axis=1).reshape(b, 4, c).sum(axis=1)
    np.testing.assert_allclose(sums.sum(dim=1).numpy(), want_s, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("has_prev", [False, True])
def test_respath_level_bf16_matches_tpu_kernel(has_prev):
    """bf16: the plain version's rounding points (the kernel's: w, gate,
    s_se, t_se and x_i in bf16, y = lrelu(bf16(acc*s_bn + t_bn))) against
    JAX's interpret-mode kernel on the s2d frame, which does the SE apply
    as bf16 operations. Tolerance 1e-2 of the output's scale, the port's
    bf16 bar."""
    b, h, c = 2, 16, 32
    rs = np.random.RandomState(4)
    bf = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    x = bf(_rand(rs, (b, h, h, c)))
    w = _rand(rs, (3, 3, c, c), 0.1)
    s_bn, t_bn = 1.0 + _rand(rs, (c,), 0.1), _rand(rs, (c,), 0.1)
    y_prev = bf(_rand(rs, (b, h, h, c))) if has_prev else None
    gate = (0.5 + 0.5 * rs.rand(b, c)).astype(np.float32) if has_prev else None
    s_se, t_se = (1.0 + _rand(rs, (c,), 0.1), _rand(rs, (c,), 0.1)) if has_prev else (None, None)

    tile4 = lambda v: jnp.tile(jnp.asarray(v), 4)  # noqa: E731
    pk = lambda a: s2d.pack(jnp.asarray(a).astype(jnp.bfloat16))  # noqa: E731
    jy, jx, jsums = respath_level_frame(
        pk(x), s2d.pack_conv3x3_kernel(jnp.asarray(w)), (tile4(s_bn), tile4(t_bn)),
        pk(y_prev) if has_prev else None,
        jnp.tile(jnp.asarray(gate), (1, 4)) if has_prev else None,
        (tile4(s_se), tile4(t_se)) if has_prev else None,
        interpret=True,
    )
    opt = (lambda a: None if a is None else _t(a))  # noqa: E731
    y, xn, sums = RP.respath_level(_t(x).to(torch.bfloat16), _t(w), _t(s_bn), _t(t_bn),
                                   None if y_prev is None else _t(y_prev).to(torch.bfloat16),
                                   opt(gate), opt(s_se), opt(t_se))
    assert y.dtype == xn.dtype == torch.bfloat16
    for got, want in ((y, jy), (xn, jx)):
        want = np.asarray(s2d.unpack(want).astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=1e-2 * np.abs(want).max())
    want_s = np.asarray(jsums).sum(axis=1).reshape(b, 4, c).sum(axis=1)
    np.testing.assert_allclose(sums.sum(dim=1).numpy(), want_s, rtol=0,
                               atol=1e-2 * np.abs(want_s).max())


@pytest.mark.parametrize("itemsize", [4, 2])
def test_respath_level_plans_fit_shared_memory(itemsize):
    """The plan the wrapper picks for every C up to 1024 is built for the
    type and fits the CTA's shared memory in fp32 and bf16, and so does the
    8x16 streamed plan (the one that takes any C); every plan built is
    picked at some C, and the resident ones take C <= K_MAX only. The card
    tests force every plan that fits."""
    picked = set()
    for c in range(1, 1025):
        plan = RP.pick_plan(c, itemsize)
        picked.add(plan)
        assert RP.fits(plan, c, itemsize) and RP.fits(3, c, itemsize)
        assert RP.smem_bytes(plan, c, itemsize) <= _build.MAX_SMEM
    assert picked == set(RP.BUILT[itemsize])
    assert not RP.fits(1, RP.K_MAX + 1, 2) and not RP.fits(2, RP.K_MAX + 1, itemsize)
    # the main path's widths take their resident plans
    assert RP.pick_plan(32, itemsize) == 2


@pytest.mark.parametrize("k,c,cout", [(2, 6, 5), (3, 9, 3), (3, 16, 8)])
def test_hanc_mix_matches_xla_formula(k, c, cout):
    rs = np.random.RandomState(3)
    x = _rand(rs, (2, 16, 8, c))
    w = _rand(rs, (c, 2 * k - 1, cout), 0.3)
    bias = _rand(rs, (cout,), 0.1)
    want = np.asarray(_xla_hanc_mix(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), k))
    got = hanc_mix(_t(x), _t(w), _t(bias), k).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_cuda_wrappers_refuse_non_cuda_tensors():
    """The wrappers fall back to the plain version only for CPU tensors; any
    other device reaches the kernel path, whose checks refuse it."""
    x = torch.zeros((1, 8, 8, 4), device="meta")
    w = torch.zeros((4, 3, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        hanc_mix(x, w, torch.zeros(4, device="meta"), 2)


@pytest.mark.parametrize("chained", [False, True])
def test_hanc_block_bf16_matches_tpu_kernel(chained):
    """bf16: the plain version's rounding points (the kernel's) against
    JAX's kernel, which keeps the interior in bf16 and rounds at every
    operation. Tolerance 1e-2 of the output's scale, the port's bf16 bar
    (a bf16 rounding is 2^-8 relative, and the two sides round at different
    places along the block)."""
    cin, k = 8, 3
    rs = np.random.RandomState(3)
    x = np.asarray(jnp.asarray(_rand(rs, (2, 16, 16, cin))).astype(jnp.bfloat16)
                   .astype(jnp.float32))
    pre = np.stack([1.0 + _rand(rs, (2, cin), 0.2), _rand(rs, (2, cin), 0.1)], axis=1) \
        if chained else None
    args, bns = _block_args(k, cin, 3, 12, seed=9)
    a = {n: jnp.asarray(v) for n, v in args.items()}
    order = [a[n] for n in ("w1", "b1", "wd", "bd", "wh", "bh", "w3", "b3")]
    jb = {n: (jnp.asarray(s), jnp.asarray(t)) for n, (s, t) in bns.items()}
    xf = s2d.pack(jnp.asarray(x).astype(jnp.bfloat16))
    if pre is None:
        y, sums = hanc_block_frame(xf, *order, jb, k, interpret=True, emit_sums=True)
    else:
        parts = tuple(xf[..., p * cin:(p + 1) * cin] for p in range(4))
        y, sums = hanc_block_frame(None, *order, jb, k, interpret=True, emit_sums=True,
                                   x_parts=parts, pre=jnp.asarray(pre))
    want_y = np.asarray(s2d.unpack(y).astype(jnp.float32))
    want_s = np.asarray(sums).sum(axis=(1, 2))
    p = fold(*(_t(args[n]) for n in ("w1", "b1", "wd", "bd", "wh", "bh", "w3", "b3")),
             {n: (_t(s), _t(t)) for n, (s, t) in bns.items()})
    got_y, got_s = hanc_block(_t(x).to(torch.bfloat16), p, k, None if pre is None else _t(pre))
    assert got_y.dtype == torch.bfloat16
    np.testing.assert_allclose(got_y.float().numpy(), want_y, rtol=0,
                               atol=1e-2 * np.abs(want_y).max())
    np.testing.assert_allclose(got_s.sum(dim=1).numpy(), want_s, rtol=0,
                               atol=1e-2 * np.abs(want_s).max())


@pytest.mark.parametrize("itemsize", [4, 2])
def test_hanc_block_tile_fits_shared_memory(itemsize):
    """The tile the wrapper picks for every nf == cin <= 128 (and every tile
    that holds cin) fits the CTA's shared memory at k = 1..3 and cout up to
    128, in fp32 and bf16; the mix columns hold nf."""
    for cin in range(1, HB.MAX_CIN + 1):
        tile = HB.pick_tile(cin)
        assert HB.TILES[tile][2] >= cin
        for t in [tile] + [t for t, (_, _, ncol) in HB.TILES.items() if ncol >= cin]:
            for k in (1, 2, 3):
                for cout in (1, 32, 64, 128):
                    assert HB.smem_bytes(t, cin, cout, k, itemsize)[0] <= _build.MAX_SMEM
