"""The `expand_dw` CUDA kernel against its plain PyTorch version on the card,
at ragged shapes (H, W not multiples of the 14x14 tile, E not a multiple of
the 64-channel chunk, cin below, at and past the 32-channel staging step),
with a large BN1 shift so that the activated padding ring is non-zero at
all four borders, in fp32 and bf16; the wrapper's refusals; one hybrid
HANCBlock on the card against the CPU.

Needs a CUDA device and nvcc (the kernels build at the first launch); skips
without a device. chip_smoke.py phase 15 covers the main path's cnv72 shapes.
This file imports no JAX:
`python -m pytest tests/test_torch_expand_dw_cuda.py --noconftest -q`.

Tolerances, relative to the output's max magnitude: fp32 1e-5 (the same
fp32 sums, reassociated), bf16 1e-2 (both sides round once from fp32; a
rounding-boundary flip is one bf16 ulp, 2^-8)."""

import pytest
import torch

from accunet_tpu_torch.ops.kernels import expand_dw as ED

pytestmark = pytest.mark.cuda

DTYPES = {"fp32": (torch.float32, 1e-5), "bf16": (torch.bfloat16, 1e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(dev, dtype, b, h, w, cin, e, shift, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device=dev) * s

    return (rn(b, h, w, cin).to(dtype), rn(cin, e, s=cin ** -0.5), rn(e, s=0.1),
            rn(3, 3, e, s=1 / 3), rn(e, s=0.1), (1 + rn(e, s=0.1), shift + rn(e, s=0.1)),
            (1 + rn(e, s=0.1), rn(e, s=0.1)))


def _close(got, want, tol):
    got, want = got.float(), want.float()
    assert got.shape == want.shape
    assert bool(got.isfinite().all())
    err = float((got - want).abs().max())
    assert err <= tol * max(float(want.abs().max()), 1.0), err


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("b,h,w,cin,e,shift", [
    (1, 7, 9, 5, 72, 2.0), (2, 13, 17, 8, 200, 2.0), (1, 14, 14, 32, 64, 0.1),
    (1, 15, 29, 33, 130, 2.0), (2, 30, 16, 128, 300, 0.1), (1, 20, 11, 300, 65, 2.0),
    (1, 1, 1, 3, 1, 2.0),
])
def test_expand_dw_kernel(dev, dt, b, h, w, cin, e, shift):
    dtype, tol = DTYPES[dt]
    ops = _operands(dev, dtype, b, h, w, cin, e, shift)
    before = ED.expand_dw.launches
    got = ED.expand_dw(*ops)
    torch.cuda.synchronize()
    assert ED.expand_dw.launches == before + 1
    assert got.dtype == dtype
    _close(got, ED.expand_dw_plain(*ops), tol)


def test_expand_dw_refuses_bad_operands(dev):
    ops = list(_operands(dev, torch.float32, 1, 8, 8, 4, 16, 0.1))
    with pytest.raises(ValueError, match="contiguous"):
        ED.expand_dw(ops[0].transpose(1, 2), *ops[1:])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ED.expand_dw(ops[0].half(), *ops[1:])
    with pytest.raises(ValueError, match="w1 has shape"):
        ED.expand_dw(ops[0], ops[1][:3], *ops[2:])
    with pytest.raises(ValueError, match="w1 must be a CUDA tensor"):
        ED.expand_dw(ops[0], ops[1].cpu(), *ops[2:])


def test_hybrid_block_on_the_card_matches_the_cpu(dev):
    """HANCBlock(hybrid=True) with BN statistics off their init values: one
    eval forward on the card (the kernel at cnv72's width, E 4352 from cin
    128) against the CPU (plain version) and against the card's unfused
    front half."""
    import copy

    from accunet_tpu_torch.nn.acc_blocks import BatchNorm, HANCBlock

    torch.manual_seed(0)
    block = HANCBlock(128, 128, 3, 34, hybrid=True).eval()
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(1.0, 1.2)
    x = torch.randn(1, 12, 20, 128)
    gpu = copy.deepcopy(block).to(dev)
    before = ED.expand_dw.launches
    with torch.inference_mode():
        want = block(x)
        got = gpu(x.to(dev))
        front = gpu.expand_dw_args()
        fused, unfused = ED.expand_dw(x.to(dev), *front), gpu.front_unfused(x.to(dev))
    assert ED.expand_dw.launches == before + 2
    _close(got.cpu(), want, 1e-4)
    _close(fused, unfused, 1e-4)
