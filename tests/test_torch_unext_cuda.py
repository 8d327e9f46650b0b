"""The UNeXt slice on the card: `dwconv2d_wgrad` at UNext b8 224x224's four
ShiftedBlock shapes against its plain version (fp32 and bf16, dw and db, a
second call bitwise), a ShiftedBlock's gradients through the kernel against
the same block's float64 autograd on the CPU, the UNext_S launches (none per
eval forward, one wgrad per ShiftedBlock per backward) and the UNeXt-family
forwards on the card against the CPU.

Needs a CUDA device and nvcc (the kernels build at the first launch); skips
without a device. chip_smoke.py covers the full-size paths. This file
imports no JAX: `python -m pytest tests/test_torch_unext_cuda.py --noconftest
-q`.

Tolerances: the wgrad kernel fp32 1e-4 and bf16 1e-2 of the plain version's
scale (chip_smoke's bar: sums in another order; bf16 inputs, fp32 sums);
gradients and forwards against the CPU 1e-4 of the scale (fp32 with TF32
off against float64 or fp32 CPU sums)."""

import copy

import pytest
import torch

from accunet_tpu_torch.models import build, init_parameters
from accunet_tpu_torch.nn.unext_blocks import ShiftedBlock
from accunet_tpu_torch.ops.kernels import dwconv2d as DW

pytestmark = pytest.mark.cuda

UNEXT_DW_SHAPES = [(8, 14, 14, 160), (8, 7, 7, 256), (8, 28, 28, 128)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = tf32


def _close(got, want, tol):
    got, want = got.float().cpu(), want.float().cpu()
    assert got.shape == want.shape and bool(got.isfinite().all())
    assert float((got - want).abs().max()) <= tol * max(float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape", UNEXT_DW_SHAPES)
def test_wgrad_at_unext_shapes(dev, shape, dtype, tol):
    g = torch.Generator(device=dev).manual_seed(0)
    x, gy = (torch.randn(*shape, generator=g, device=dev).to(dtype) for _ in range(2))
    before = DW.dwconv2d_wgrad.launches
    dw, db = DW.dwconv2d_wgrad(x, gy, 3, 3, bias_grad=True)
    again = DW.dwconv2d_wgrad(x, gy, 3, 3, bias_grad=True)
    torch.cuda.synchronize()
    assert DW.dwconv2d_wgrad.launches == before + 2
    assert torch.equal(dw, again[0]) and torch.equal(db, again[1])
    _close(dw, DW.dwconv2d_wgrad_reference(x, gy, 3, 3), tol)
    _close(db, gy.float().sum(dim=(0, 1, 2)), tol)


def test_shifted_block_grads_through_the_kernel(dev):
    """ShiftedBlock(160) at dblock1_0's map (b2): the input and parameter
    gradients on the card (one wgrad launch) against float64 on the CPU."""
    block = init_parameters(ShiftedBlock(160), torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    x, gy = torch.randn(2, 14, 14, 160, generator=g), torch.randn(2, 14, 14, 160, generator=g)
    grads = {}
    for tag, d, dt in (("gpu", dev, torch.float32), ("cpu64", "cpu", torch.float64)):
        m = copy.deepcopy(block).to(device=d, dtype=dt)
        xt = x.to(d, dt).requires_grad_(True)
        before = DW.dwconv2d_wgrad.launches
        m(xt).backward(gy.to(d, dt))
        grads[tag] = {"x": xt.grad, **{n: p.grad for n, p in m.named_parameters()}}
        assert DW.dwconv2d_wgrad.launches - before == (1 if tag == "gpu" else 0)
    for name, want in grads["cpu64"].items():
        _close(grads["gpu"][name], want, 1e-4)


def test_unext_s_launches_and_forward(dev):
    """UNext_S b2 64x64: the eval forward launches no port kernel and
    matches the CPU; a train-mode forward + backward launches dwconv2d_wgrad
    once per ShiftedBlock (4)."""
    model = init_parameters(build("UNext_S", n_channels=3, n_classes=1, final_sigmoid=False),
                            torch.Generator().manual_seed(3)).eval()
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(4))
    gpu = copy.deepcopy(model).to(dev)
    before = DW.dwconv2d_wgrad.launches
    with torch.no_grad():
        got = gpu(x.to(dev))
        want = model(x)
    assert DW.dwconv2d_wgrad.launches == before
    _close(got, want, 1e-4)
    gpu.train()(x.to(dev)).sum().backward()
    torch.cuda.synchronize()
    assert DW.dwconv2d_wgrad.launches == before + 4


@pytest.mark.parametrize("name", ["UNext", "UNext_CMRF", "UNext_CMRF_enc_dec",
                                  "UNext_CMRF_enc_MLFC", "UNext_CMRF_dense_skip"])
def test_unext_family_forward_gpu_vs_cpu(dev, name):
    model = init_parameters(build(name, n_channels=3, n_classes=1, final_sigmoid=False),
                            torch.Generator().manual_seed(5)).eval()
    x = torch.randn(2, 48, 48, 3, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        got = copy.deepcopy(model).to(dev)(x.to(dev))
        want = model(x)
    assert got.shape == (2, 64, 64, 1)
    _close(got, want, 1e-4)
