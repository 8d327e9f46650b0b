"""The return-hidden selective scan kernels (csrc/selective_scan.cu:
selective_scan_rh_fwd / selective_scan_rh_bwd) against their plain versions
on the card: L 1, L within one chunk of 64 steps, L not a multiple of the
128-step chunk, D not a multiple of a CTA's 8 d and several d-blocks, N 1, 3,
16 and 32, bias absent, softplus off; the chunk states; the backward bitwise
on a second call and with the cotangent laid out as (B, D, N, L);
SelectiveScanRhFn's gradients against autograd of the plain forward, with a
cotangent in h's strides, in (B, D, N, L) order (both read as they lie) and
in another order (copied once); the wrappers' refusals.

Needs a CUDA device and nvcc (the kernels build at the first launch); skips
without a device. chip_smoke.py covers the full-size shapes. This file
imports no JAX: `python -m pytest tests/test_torch_spatial_mamba_cuda.py
--noconftest -q`.

Tolerance: fp32 1e-5 of the output's max magnitude (the same formula as the
plain version, walked sequentially against a log-depth tree, with the sums
over n, d, b and t in another order)."""

import pytest
import torch

from accunet_tpu_torch.ops.kernels import selective_scan as SS

pytestmark = pytest.mark.cuda

# (B, L, D, N, bias, softplus)
SHAPES = [(1, 1, 3, 16, True, True), (2, 40, 5, 16, True, True), (3, 300, 13, 16, True, True),
          (2, 129, 17, 1, True, True), (2, 1000, 8, 16, False, True),
          (1, 520, 20, 32, True, False), (2, 77, 9, 3, False, False)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ops(dev, b, l, d, n, bias=True, softplus=True, seed=0):
    """u = silu(N(0, 1)), delta N(0, 0.5^2) (its absolute value without the
    softplus: a negative delta' makes exp(delta' A) grow), A = -(1..N) per
    row, B ~ N(0, 1), bias ~ N(0, 0.1^2)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device=dev) * s

    A = -torch.arange(1, n + 1, device=dev, dtype=torch.float32).expand(d, n).contiguous()
    delta = rn(b, d, l, s=0.5)
    return (torch.nn.functional.silu(rn(b, d, l)), delta if softplus else delta.abs(), A,
            rn(b, n, l), rn(d, s=0.1) if bias else None)


def _close(got, want, tol=1e-5):
    assert got.shape == want.shape and bool(got.isfinite().all())
    assert float((got - want).abs().max()) <= tol * max(float(want.abs().max()), 1.0)


@pytest.mark.parametrize("b,l,d,n,bias,softplus", SHAPES)
def test_rh_kernels_match_plain(dev, b, l, d, n, bias, softplus):
    ops = _ops(dev, b, l, d, n, bias, softplus)
    counts = (SS.selective_scan_rh_fwd.launches, SS.selective_scan_rh_bwd.launches)
    h, states = SS.selective_scan_rh_fwd(*ops, softplus, save_states=True)
    gh = torch.randn_like(h)
    grads = SS.selective_scan_rh_bwd(*ops, softplus, states, gh)
    again = SS.selective_scan_rh_bwd(*ops, softplus, states, gh)
    # the same cotangent laid out as (B, D, N, L), read in place
    dnl = SS.selective_scan_rh_bwd(*ops, softplus, states,
                                   gh.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2))
    torch.cuda.synchronize()
    assert (SS.selective_scan_rh_fwd.launches, SS.selective_scan_rh_bwd.launches) == (
        counts[0] + 1, counts[1] + 3)
    want = SS.selective_scan_rh_fwd_plain(*ops, softplus)
    _close(h, want)
    # the state entering chunk c is h at the chunk's step before it
    step = 32 * SS.rh_chunk_steps(l)
    assert states.shape == (b, d, SS.rh_n_chunks(l), n)
    _close(states[:, :, 0], torch.zeros_like(states[:, :, 0]))
    if states.shape[2] > 1:
        _close(states[:, :, 1:], want[:, step - 1::step][:, :states.shape[2] - 1]
               .permute(0, 2, 1, 3))
    wants = SS.selective_scan_rh_bwd_plain(*ops, softplus, gh)
    for name, got, ref, rep, other in zip(("du", "ddelta", "dA", "dB", "dbias"), grads, wants,
                                          again, dnl):
        if ref is None:
            assert got is None and rep is None and other is None, name
            continue
        _close(got, ref)
        assert torch.equal(got, rep), f"{name} differs on a second call"
        assert torch.equal(got, other), f"{name} differs with gh as (B, D, N, L)"


def test_rh_forward_without_states_matches(dev):
    ops = _ops(dev, 2, 300, 11, 16)
    h, states = SS.selective_scan_rh_fwd(*ops, True)
    assert states is None
    h2, _ = SS.selective_scan_rh_fwd(*ops, True, save_states=True)
    assert torch.equal(h, h2)


# the order of h's dims in the tensor whose gradient reaches the function:
# h's own (B, L, D, N), JAX's (B, D, N, L), both read as they lie, and
# (B, N, L, D), which is copied once
@pytest.mark.parametrize("order,copied", [((0, 1, 2, 3), 0), ((0, 2, 3, 1), 0),
                                          ((0, 3, 1, 2), 1)])
def test_rh_autograd_fn(dev, order, copied):
    ops = [t.requires_grad_(True) for t in _ops(dev, 2, 300, 13, 16)]
    g = torch.randn(2, 300, 13, 16, device=dev)
    copies = SS.SelectiveScanRhFn.gh_copies
    h = SS.SelectiveScanRhFn.apply(*ops, True)
    got = torch.autograd.grad(h.permute(*order).contiguous(), ops,
                              g.permute(*order).contiguous())
    assert SS.SelectiveScanRhFn.gh_copies == copies + copied
    want = torch.autograd.grad(SS.selective_scan_rh_fwd_plain(*ops, True), ops, g)
    for p, q in zip(got, want):
        _close(p, q)


def test_rh_wrappers_refuse(dev):
    u, delta, A, B, bias = _ops(dev, 2, 300, 9, 16)  # three chunks
    with pytest.raises(ValueError, match="contiguous"):
        SS.selective_scan_rh_fwd(u.transpose(1, 2).contiguous().transpose(1, 2), delta, A, B)
    with pytest.raises(TypeError):
        SS.selective_scan_rh_fwd(u.double(), delta, A, B)
    with pytest.raises(ValueError, match="N <= 32"):
        SS.selective_scan_rh_fwd(u, delta, torch.zeros(9, 33, device=dev),
                                 torch.zeros(2, 33, 300, device=dev))
    with pytest.raises(ValueError, match="CUDA"):
        SS.selective_scan_rh_fwd(u, delta, A.cpu(), B)
    h, states = SS.selective_scan_rh_fwd(u, delta, A, B, bias, True, save_states=True)
    with pytest.raises(ValueError, match="gh"):
        SS.selective_scan_rh_bwd(u, delta, A, B, bias, True, states, h.permute(0, 2, 1, 3))
    with pytest.raises(ValueError, match="states"):
        SS.selective_scan_rh_bwd(u, delta, A, B, bias, True, states[:, :, :1].contiguous(), h)
