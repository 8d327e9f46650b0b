"""The port's scan kernels (csrc/linear_scan.cu) against their plain versions
on the card: small ragged shapes (L not a multiple of a ring slot's rows, 64
forward and 48 reverse, or of the staged kernel's chunk, D not a multiple
of the 32-column tile, B > 1), BASELINE config 5's (8, 3136, 768), D % 4
!= 0 and an operand that is not 16-byte aligned (both filled by 4-byte
copies); the staged kernel, the same kernel at a ring the caller chooses,
bitwise against linear_scan at every ring; the autograd function; the
wrappers' refusals. The fused selective scan
(csrc/selective_scan.cu) forward and backward against their plain versions:
L not a multiple of the chunk, L = 1, L shorter than one chunk, D not a
multiple of a CTA's d, D or z absent, softplus off, many d-blocks; the
backward bitwise on a second call; its refusals.

Needs a CUDA device and nvcc (the kernels build at the first launch); skips
without a device. chip_smoke.py covers Segmamba's full-size shapes. This
file imports no JAX: `python -m pytest tests/test_torch_segmamba_cuda.py
--noconftest -q`.

Tolerance: fp32 1e-5 of the output's max magnitude (a sequential walk
against a log-depth tree of the same fp32 products; for the selective scan,
the same formula with its sums over n, d, b and t in another order)."""

import pytest
import torch

from accunet_tpu_torch.ops.kernels import scan as S
from accunet_tpu_torch.ops.kernels import selective_scan as SS

pytestmark = pytest.mark.cuda

SHAPES = [(1, 1, 4), (1, 17, 8), (3, 300, 48), (2, 129, 100), (2, 1000, 36), (8, 3136, 768),
          (2, 333, 13), (1, 65, 1)]


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


def test_linear_scan_kernel_unaligned_operands(dev):
    """Operands one float past a 16-byte boundary: the ring fills by 4-byte
    copies, and h, da, db equal the aligned operands' bitwise."""
    a, x = _inputs(dev, 2, 200, 40, seed=4)
    g = torch.randn_like(a)
    h, (da, db) = S.linear_scan(a, x), S.linear_scan_reverse(a, S.linear_scan(a, x), g)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=dev)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)

    ua, ux, ug = shifted(a), shifted(x), shifted(g)
    assert ua.data_ptr() % 16 and ua.is_contiguous()
    uh = S.linear_scan(ua, ux)
    uda, udb = S.linear_scan_reverse(ua, shifted(uh), ug)
    torch.cuda.synchronize()
    assert torch.equal(uh, h) and torch.equal(uda, da) and torch.equal(udb, db)


@pytest.mark.parametrize("b,l,d", [s for s in SHAPES if s[2] % 4 == 0])
@pytest.mark.parametrize("chunk,nbuf", [(128, 2), (128, 3), (128, 4), (7, 2), (300, 3), (32, 4),
                                        (1, 2)])
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


# (B, D, N, L): L = 300 (a partial second chunk of 256), 1, 40 (one chunk of
# 64, partly idle lanes), 129 (K 8, one partial chunk), 520, 4500 (runs of 16
# steps: eight chunks of 512 and a partial one); D 10 and 13 (partial 8-d
# CTAs); N 16 (BiMamba), 3; (4, 600, 16, 70): 75 d-blocks of partial dB, dC
SCAN_SHAPES = [(2, 10, 16, 300), (1, 3, 16, 1), (2, 13, 3, 40), (1, 9, 16, 129),
               (1, 17, 16, 520), (1, 9, 16, 4500), (4, 600, 16, 70)]
# (D, z, delta_bias, delta_softplus, last state's cotangent)
SCAN_FLAGS = [(1, 1, 1, 1, 1), (0, 0, 0, 0, 0), (1, 0, 1, 0, 1), (0, 1, 0, 1, 0)]


def _ss_inputs(dev, bsz, d, n, l, flags, seed=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    has_d, has_z, has_bias = flags[:3]
    return [rn(bsz, d, l), 0.2 + 0.5 * rn(bsz, d, l).abs(),
            -torch.exp(2.5 * torch.rand(d, n, generator=g, device=dev) - 1),
            rn(bsz, n, l), rn(bsz, n, l), rn(d) if has_d else None,
            rn(bsz, d, l) if has_z else None, 0.1 * rn(d) if has_bias else None]


@pytest.mark.parametrize("flags", SCAN_FLAGS, ids=lambda f: "D{}z{}bias{}sp{}last{}".format(*f))
@pytest.mark.parametrize("bsz,d,n,l", SCAN_SHAPES)
def test_selective_scan_kernels(dev, bsz, d, n, l, flags):
    ops = _ss_inputs(dev, bsz, d, n, l, flags)
    softplus = bool(flags[3])
    counts = (SS.selective_scan_fwd.launches, SS.selective_scan_bwd.launches)
    out, last, states = SS.selective_scan_fwd(*ops, softplus, save_states=True)
    g = torch.randn(bsz, d, l, device=dev)
    g_last = torch.randn(bsz, d, n, device=dev) if flags[4] else None
    got = SS.selective_scan_bwd(*ops, softplus, states, g, g_last)
    again = SS.selective_scan_bwd(*ops, softplus, states, g, g_last)
    torch.cuda.synchronize()
    assert (SS.selective_scan_fwd.launches, SS.selective_scan_bwd.launches) == (counts[0] + 1,
                                                                                  counts[1] + 2)
    assert states.shape == (bsz, d, SS.n_chunks(l, n), n)
    for x, y in zip((out, last), SS.selective_scan_fwd_plain(*ops, softplus)):
        _close(x, y)
    want = SS.selective_scan_bwd_plain(*ops, softplus, g, g_last)
    for x, y, z in zip(got, want, again):
        assert (x is None) == (y is None) == (z is None)
        if x is not None:
            _close(x, y)
            assert torch.equal(x, z)


def test_selective_scan_fn_grads(dev):
    """SelectiveScanFn (both kernels) against autograd of the plain forward."""
    ops = [t.requires_grad_(True) for t in _ss_inputs(dev, 2, 12, 16, 333, (1, 1, 1, 1, 1))]
    g = torch.randn(2, 12, 333, device=dev)
    got = torch.autograd.grad(SS.SelectiveScanFn.apply(*ops, True)[0], ops, g)
    want = torch.autograd.grad(SS.selective_scan_fwd_plain(*ops, True)[0], ops, g)
    for p, q in zip(got, want):
        _close(p, q)


def test_selective_scan_wrappers_refuse_what_the_kernels_do_not_take(dev):
    ops = _ss_inputs(dev, 2, 8, 16, 50, (1, 1, 1, 1, 1))
    with pytest.raises(TypeError):
        SS.selective_scan_fwd(*[None if t is None else t.double() for t in ops], True)
    with pytest.raises(ValueError):  # B on the CPU
        SS.selective_scan_fwd(*ops[:3], ops[3].cpu(), *ops[4:], True)
    with pytest.raises(ValueError):  # C of another length
        SS.selective_scan_fwd(*ops[:4], ops[4][..., :-1].contiguous(), *ops[5:], True)
    with pytest.raises(ValueError):  # delta not contiguous
        SS.selective_scan_fwd(ops[0], ops[1].transpose(1, 2).contiguous().transpose(1, 2),
                              *ops[2:], True)
    big = _ss_inputs(dev, 1, 2, SS.MAX_STATES + 1, 10, (1, 1, 1, 1, 1))
    with pytest.raises(ValueError):
        SS.selective_scan_fwd(*big, True)
    _, _, states = SS.selective_scan_fwd(*ops, True, save_states=True)
    g = torch.randn(2, 8, 50, device=dev)
    with pytest.raises(ValueError):  # states of another chunking
        SS.selective_scan_bwd(*ops, True, states[:, :, :0], g)
    with pytest.raises(TypeError):
        SS.selective_scan_bwd(*ops, True, states, g.double())
