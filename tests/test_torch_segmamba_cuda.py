"""The port's scan kernels (csrc/linear_scan.cu) against their plain versions
on the card at small ragged shapes: L not a multiple of the 16-step prefetch
or of the staged kernel's chunk, D not a multiple of its 32-column tile,
B > 1; the staged kernel bitwise against linear_scan at every ring depth;
the autograd function; the wrappers' refusals.

Needs a CUDA device and nvcc (the kernels build at the first launch); skips
without a device. chip_smoke.py covers Segmamba's full-size shapes. This
file imports no JAX: `python -m pytest tests/test_torch_segmamba_cuda.py
--noconftest -q`.

Tolerance: fp32 1e-5 of the output's max magnitude (a sequential walk
against a log-depth tree of the same fp32 products)."""

import pytest
import torch

from accunet_tpu_torch.ops.kernels import scan as S

pytestmark = pytest.mark.cuda

SHAPES = [(1, 1, 4), (1, 17, 8), (3, 300, 48), (2, 129, 100), (2, 1000, 36)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(dev, b, l, d, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.exp(-2 * torch.rand(b, l, d, generator=g, device=dev))
    return a, torch.randn(b, l, d, generator=g, device=dev)


def _close(got, want, tol=1e-5):
    assert got.shape == want.shape and bool(got.isfinite().all())
    assert float((got - want).abs().max()) <= tol * max(float(want.abs().max()), 1.0)


@pytest.mark.parametrize("b,l,d", SHAPES)
def test_linear_scan_kernel(dev, b, l, d):
    a, x = _inputs(dev, b, l, d)
    g = torch.randn_like(a)
    counts = (S.linear_scan.launches, S.linear_scan_reverse.launches)
    h = S.linear_scan(a, x)
    da, db = S.linear_scan_reverse(a, h, g)
    torch.cuda.synchronize()
    assert (S.linear_scan.launches, S.linear_scan_reverse.launches) == (counts[0] + 1,
                                                                        counts[1] + 1)
    _close(h, S.linear_scan_plain(a, x))
    for got, want in zip((da, db), S.linear_scan_grads_plain(a, h, g)):
        _close(got, want)


@pytest.mark.parametrize("b,l,d", [s for s in SHAPES if s[2] % 4 == 0])
@pytest.mark.parametrize("chunk,nbuf", [(128, 2), (128, 3), (128, 4), (7, 2), (300, 3)])
def test_staged_scan_is_bitwise_linear_scan(dev, b, l, d, chunk, nbuf):
    a, x = _inputs(dev, b, l, d, seed=1)
    before = S.dma_chunked_scan.launches
    got = S.dma_chunked_scan(a, x, chunk=chunk, nbuf=nbuf)
    torch.cuda.synchronize()
    assert S.dma_chunked_scan.launches == before + 1
    assert torch.equal(got, S.linear_scan(a, x))


def test_chunked_linear_scan_fn_grads(dev):
    a, x = (t.requires_grad_(True) for t in _inputs(dev, 2, 333, 20, seed=2))
    w = torch.randn(2, 333, 20, device=dev)
    got = torch.autograd.grad(S.ChunkedLinearScanFn.apply(a, x), (a, x), w)
    want = torch.autograd.grad(S.linear_scan_plain(a, x), (a, x), w)
    for p, q in zip(got, want):
        _close(p, q)


def test_scan_wrappers_refuse_what_the_kernels_do_not_take(dev):
    a, x = _inputs(dev, 2, 10, 8)
    with pytest.raises(TypeError):
        S.linear_scan(a.double(), x.double())
    with pytest.raises(ValueError):
        S.linear_scan(a.transpose(1, 2), x.transpose(1, 2))
    with pytest.raises(ValueError):
        S.dma_chunked_scan(a, x, nbuf=5)
    with pytest.raises(ValueError):
        S.dma_chunked_scan(a, x, chunk=1024, nbuf=4)
    a6, x6 = _inputs(dev, 2, 10, 6)
    with pytest.raises(ValueError):
        S.dma_chunked_scan(a6, x6)
