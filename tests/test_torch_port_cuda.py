"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes with ragged tiles (H, W not multiples of the kernels' tiles,
channel counts that are not multiples of the chunk widths), every k, with
and without the chained `pre` prologue, fp32 and bf16.

Needs a CUDA device and nvcc (the kernels build at the first launch); skips
without a device. chip_smoke.py covers the main path's full-size shapes.
Also the depthwise weight-gradient kernel against its plain version, the
train path's autograd functions on the card, and the launches of one small
train step. This file imports no JAX, so it also runs where JAX is not installed:
`python -m pytest tests/test_torch_port_cuda.py --noconftest -q`.

Tolerances, relative to the output's max magnitude: fp32 1e-5 (the same
fp32 sums, reassociated), bf16 1e-2 (both sides round once from fp32; a
rounding-boundary flip is one bf16 ulp, 2^-8)."""

import pytest
import torch

from accunet_tpu_torch.ops.kernels import dwconv2d as DW
from accunet_tpu_torch.ops.kernels import hanc_block as HB
from accunet_tpu_torch.ops.kernels import hanc_mix as HM
from accunet_tpu_torch.ops.kernels import respath as RP

pytestmark = pytest.mark.cuda

DTYPES = {"fp32": (torch.float32, 1e-5), "bf16": (torch.bfloat16, 1e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rn(g, dev, *shape, s=1.0):
    return torch.randn(*shape, generator=g, device=dev) * s


def _close(got, want, tol):
    got, want = got.float(), want.float()
    assert got.shape == want.shape
    assert bool(got.isfinite().all())
    err = float((got - want).abs().max())
    assert err <= tol * max(float(want.abs().max()), 1.0), err


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("b,h,w,c,cout,k", [
    (1, 8, 8, 5, 3, 2), (2, 12, 20, 17, 70, 3), (1, 6, 10, 16, 33, 2), (1, 28, 28, 40, 130, 2),
])
def test_hanc_mix_kernel(dev, dt, b, h, w, c, cout, k):
    dtype, tol = DTYPES[dt]
    g = torch.Generator(device=dev).manual_seed(0)
    x = _rn(g, dev, b, h, w, c).to(dtype)
    wt, bias = _rn(g, dev, c, 2 * k - 1, cout, s=c ** -0.5), _rn(g, dev, cout, s=0.1)
    before = HM.hanc_mix.launches
    y = HM.hanc_mix(x, wt, bias, k)
    torch.cuda.synchronize()
    assert HM.hanc_mix.launches == before + 1
    _close(y, HM.hanc_mix_reference(x, wt, bias, k), tol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("b,h,w,c,prev", [
    (1, 8, 16, 8, False), (2, 10, 20, 32, True), (1, 9, 17, 40, True), (1, 8, 8, 72, True),
])
def test_respath_level_kernel(dev, dt, b, h, w, c, prev):
    dtype, tol = DTYPES[dt]
    g = torch.Generator(device=dev).manual_seed(1)
    args = [_rn(g, dev, b, h, w, c).to(dtype), _rn(g, dev, 3, 3, c, c, s=(9 * c) ** -0.5),
            1 + _rn(g, dev, c, s=0.1), _rn(g, dev, c, s=0.1)]
    if prev:
        args += [_rn(g, dev, b, h, w, c).to(dtype),
                 torch.rand(b, c, generator=g, device=dev),
                 1 + _rn(g, dev, c, s=0.1), _rn(g, dev, c, s=0.1)]
    got = RP.respath_level(*args)
    torch.cuda.synchronize()
    want = RP.respath_level_reference(*args)
    _close(got[0], want[0], tol)
    _close(got[1], want[1], tol)
    _close(got[2].sum(dim=1), want[2].sum(dim=1), max(tol, 1e-4))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("b,h,w,cin,inv,cout,k,pre", [
    (1, 8, 8, 8, 3, 8, 3, False), (2, 16, 12, 8, 3, 12, 3, True),
    (1, 12, 20, 40, 2, 24, 2, True), (1, 10, 9, 16, 3, 8, 1, False),
    (1, 8, 8, 72, 1, 8, 3, True), (1, 16, 16, 128, 3, 64, 3, True),
])
def test_hanc_block_kernel(dev, dt, b, h, w, cin, inv, cout, k, pre):
    dtype, tol = DTYPES[dt]
    g = torch.Generator(device=dev).manual_seed(2)
    e = cin * inv
    bns = {n: (1 + _rn(g, dev, d, s=0.1), _rn(g, dev, d, s=0.1))
           for n, d in [("norm1", e), ("norm2", e), ("hnc", cin), ("norm", cin), ("norm3", cout)]}
    p = HB.fold(_rn(g, dev, cin, e, s=cin ** -0.5), _rn(g, dev, e, s=0.1),
                _rn(g, dev, 3, 3, e, s=1 / 3), _rn(g, dev, e, s=0.1),
                _rn(g, dev, e, 2 * k - 1, cin, s=e ** -0.5), _rn(g, dev, cin, s=0.1),
                _rn(g, dev, cin, cout, s=cin ** -0.5), _rn(g, dev, cout, s=0.1), bns)
    x = _rn(g, dev, b, h, w, cin).to(dtype)
    pr = torch.stack([1 + _rn(g, dev, b, cin, s=0.2), _rn(g, dev, b, cin, s=0.1)], 1) if pre else None
    y, sums = HB.hanc_block(x, p, k, pr)
    torch.cuda.synchronize()
    ry, rsums = HB.hanc_block_reference(x, p, k, pr)
    _close(y, ry, tol)
    _close(sums.sum(dim=1), rsums.sum(dim=1), max(tol, 1e-4))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("b,h,w,c,k", [
    (1, 5, 7, 9, 3), (2, 12, 9, 40, 3), (1, 9, 20, 33, 7), (3, 4, 4, 64, 5), (2, 30, 17, 96, 3),
])
def test_dwconv2d_wgrad_kernel(dev, dt, b, h, w, c, k):
    dtype, tol = DTYPES[dt]
    g = torch.Generator(device=dev).manual_seed(3)
    x, gy = _rn(g, dev, b, h, w, c).to(dtype), _rn(g, dev, b, h, w, c).to(dtype)
    before = DW.dwconv2d_wgrad.launches
    dw = DW.dwconv2d_wgrad(x, gy, k, k)
    torch.cuda.synchronize()
    assert DW.dwconv2d_wgrad.launches == before + 1
    assert dw.dtype == torch.float32
    # both sides sum the same fp32 products in another order
    _close(dw, DW.dwconv2d_wgrad_reference(x, gy, k, k), 1e-5)


def test_autograd_functions_on_the_card(dev):
    """DepthwiseConv2dFn's gradients against autograd through cuDNN's
    grouped conv; HancMixFn's against autograd through its plain version."""
    from accunet_tpu_torch.ops.kernels.hanc_mix import HancMixFn

    g = torch.Generator(device=dev).manual_seed(4)
    x = _rn(g, dev, 2, 10, 12, 24).requires_grad_(True)
    wt = _rn(g, dev, 24, 1, 3, 3, s=0.3).requires_grad_(True)
    bias = _rn(g, dev, 24, s=0.1).requires_grad_(True)
    gy = _rn(g, dev, 2, 10, 12, 24)
    got = torch.autograd.grad(DW.DepthwiseConv2dFn.apply(x, wt, bias), (x, wt, bias), gy)
    y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), wt, bias, padding=1, groups=24)
    want = torch.autograd.grad(y.permute(0, 2, 3, 1), (x, wt, bias), gy)
    for a, b_ in zip(got, want):
        _close(a, b_, 1e-5)

    k = 3
    x = _rn(g, dev, 2, 8, 16, 20).requires_grad_(True)
    wm = _rn(g, dev, 20, 2 * k - 1, 12, s=0.2).requires_grad_(True)
    bm = _rn(g, dev, 12, s=0.1).requires_grad_(True)
    gy = _rn(g, dev, 2, 8, 16, 12)
    before = HM.hanc_mix.launches
    got = torch.autograd.grad(HancMixFn.apply(x, wm, bm, k), (x, wm, bm), gy)
    assert HM.hanc_mix.launches == before + 1
    want = torch.autograd.grad(HM.hanc_mix_reference(x, wm, bm, k), (x, wm, bm), gy)
    for a, b_ in zip(got, want):
        _close(a, b_, 1e-5)


def test_wrappers_refuse_bad_operands(dev):
    x = torch.zeros(1, 8, 8, 4, device=dev)
    w = torch.zeros(4, 3, 4, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        HM.hanc_mix(x.transpose(1, 2), w, torch.zeros(4, device=dev), 2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        HM.hanc_mix(x.half(), w, torch.zeros(4, device=dev), 2)
    with pytest.raises(ValueError, match="divisible"):
        HM.hanc_mix(torch.zeros(1, 6, 6, 4, device=dev), torch.zeros(4, 5, 4, device=dev),
                    torch.zeros(4, device=dev), 3)


def test_small_train_step_launches_the_kernels(dev):
    """ACC_UNet at n_filts=8 (32x32): one train step on the card launches
    dwconv2d_wgrad at each of the 18 HANCBlocks and hanc_mix at each of the
    16 HANC layers with k >= 2; the loss is finite."""
    from accunet_tpu_torch.models import ACC_UNet, init_parameters
    from accunet_tpu_torch.train.engine import make_train_fns

    model = init_parameters(ACC_UNet(3, 1, 8), torch.Generator().manual_seed(0)).to(dev)
    fns = make_train_fns(model)
    g = torch.Generator(device=dev).manual_seed(5)
    batch = {"image": torch.rand(2, 32, 32, 3, generator=g, device=dev),
             "mask": (torch.rand(2, 32, 32, 1, generator=g, device=dev) > 0.5).float()}
    counts = (DW.dwconv2d_wgrad.launches, HM.hanc_mix.launches)
    _, stats = fns.train_step(fns.state, batch)
    assert DW.dwconv2d_wgrad.launches - counts[0] == 18
    assert HM.hanc_mix.launches - counts[1] == 16
    assert bool(torch.isfinite(stats["loss"]))


@pytest.mark.parametrize("n_filts,hw,n_block,n_mix", [(8, 32, 7, 9), (48, 16, 6, 10)])
def test_small_model_gpu_matches_cpu(dev, n_filts, hw, n_block, n_mix):
    """ACC_UNet at n_filts=8 (32x32) and 48 (16x16): the kernels on the
    card vs the plain versions on the CPU, with BN statistics off their init
    values. At n_filts=48 cnv81 (cin 192) is too wide for the fused kernel
    and runs unfused, its HANC mix on the hanc_mix kernel."""
    import copy

    from accunet_tpu_torch.models import ACC_UNet, init_parameters
    from accunet_tpu_torch.nn.acc_blocks import BatchNorm

    model = init_parameters(ACC_UNet(3, 1, n_filts, final_sigmoid=False),
                            torch.Generator().manual_seed(0)).eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(0, 0.1, generator=g)
                m.running_var.uniform_(1.0, 1.2, generator=g)
    x = torch.randn(2, hw, hw, 3, generator=g)
    launches = (HB.hanc_block.launches, RP.respath_level.launches, HM.hanc_mix.launches)
    with torch.inference_mode():
        want = model(x)
        got = copy.deepcopy(model).to(dev)(x.to(dev)).cpu()
    assert HB.hanc_block.launches - launches[0] == n_block
    assert RP.respath_level.launches - launches[1] == 7
    assert HM.hanc_mix.launches - launches[2] == n_mix
    _close(got, want, 1e-4)


@pytest.mark.parametrize("train", [False, True])
def test_profile_cli_on_the_card(dev, train):
    """The profiler entry point at a small size, a forward or a train step:
    every port kernel of the path launches, the device is busy for part of a
    window, every family time is positive."""
    from accunet_tpu_torch.cli import profile

    res = profile.main(["--img", "32", "--batch", "2", "--steps", "2",
                        "--model-kwargs", "{'n_filts': 8}"] + (["--train"] if train else []))
    assert 0 < res["busy_ms"] <= res["window_ms"] * 1.05
    assert res["kernels_per_forward"] > 0
    want = {"hanc_mix", "dwconv2d_wgrad"} if train else {"hanc_block", "respath_level", "hanc_mix"}
    assert want <= set(res["families_ms"])
    assert all(t > 0 for t in res["families_ms"].values())
    assert "cnv72" in res["spans_ms"]
