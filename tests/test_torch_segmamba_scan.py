"""The port's chunked linear scan (plain versions, autograd function) and
selective scan vs the JAX package, on the same seeded numpy inputs (CPU).

On the CPU the port's scan wrappers run their plain versions and JAX's
`chunked_linear_scan` runs `_xla_scan`; tests/test_pallas_scan.py holds
both Pallas kernels to `_xla_scan` in interpret mode, and chip_smoke.py holds
the CUDA kernels to the plain versions on the card.

Tolerances: the scans 1e-5 absolute / 1e-4 relative (two log-depth trees
that associate differently over 300 fp32 steps); the gradients 1e-4 / 1e-3;
the selective scan 1e-5 (the same fp32 formula; only the products' and the
scan's association differ).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accunet_tpu.ops import selective_scan as JS
from accunet_tpu.ops.pallas.scan import chunked_linear_scan
from accunet_tpu_torch.ops import selective_scan as TS
from accunet_tpu_torch.ops.kernels import scan as K

j_scan = jax.jit(chunked_linear_scan)

SCAN_TOL = dict(atol=1e-5, rtol=1e-4)
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: torch's intra-op threads would only contend with the
    other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan_inputs(b, l, d, seed=0):
    """Decays in (0, 1) as exp(delta * A) gives them, and O(1) inputs."""
    rs = np.random.RandomState(seed)
    a = np.exp(-rs.uniform(0.01, 2.0, (b, l, d))).astype(np.float32)
    return a, rs.standard_normal((b, l, d)).astype(np.float32)


@jax.jit
def _jax_reverse(a, g):
    """G[t] = g[t] + a[t+1]*G[t+1], as JAX `_bwd` builds it (scan.py:119-126)."""
    a_next = jnp.concatenate([a[:, 1:], jnp.ones_like(a[:, :1])], axis=1)
    return j_scan(a_next[:, ::-1], g[:, ::-1])[:, ::-1]


@pytest.mark.parametrize("form", ["forward", "reverse", "dma_chunked_scan"])
def test_scan_plain_matches_jax(form):
    """b2, l300 (two full chunks of 128 and a partial one), d16."""
    a, b = _scan_inputs(2, 300, 16)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if form == "forward":
        got, want = K.linear_scan_plain(ta, tb), j_scan(jnp.asarray(a), jnp.asarray(b))
    elif form == "reverse":
        got, want = K.linear_scan_plain(ta, tb, reverse=True), _jax_reverse(jnp.asarray(a),
                                                                             jnp.asarray(b))
    else:
        got, want = K.dma_chunked_scan(ta, tb), j_scan(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)


def test_chunked_linear_scan_grads_match_jax():
    """ChunkedLinearScanFn's (da, db) vs jax.grad through chunked_linear_scan's
    custom VJP, b1, l64, d8, for a loss sum(h * w)."""
    a, b = _scan_inputs(1, 64, 8, seed=1)
    w = np.random.RandomState(2).standard_normal(a.shape).astype(np.float32)
    want = jax.jit(jax.grad(lambda a_, b_: jnp.sum(chunked_linear_scan(a_, b_) * w),
                            argnums=(0, 1)))(jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    (K.chunked_linear_scan(ta, tb) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(want[0]), **GRAD_TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want[1]), **GRAD_TOL)


def test_scan_reverse_plain_is_the_vjp():
    """linear_scan_reverse on a CPU tensor (its plain version) equals
    autograd through the plain forward scan, in float64."""
    a, b = (torch.from_numpy(x).double() for x in _scan_inputs(2, 37, 5, seed=3))
    g = torch.randn(2, 37, 5, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    a.requires_grad_(True)
    b.requires_grad_(True)
    h = K.linear_scan_plain(a, b)
    want = torch.autograd.grad(h, (a, b), g)
    got = K.linear_scan_reverse(a.detach(), h.detach(), g)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, atol=1e-12, rtol=1e-12)


def test_scan_wrappers_count_only_kernel_launches():
    """On CPU tensors every wrapper takes its plain version and counts
    nothing: the counts are launches of the CUDA kernels."""
    counters = (K.linear_scan, K.linear_scan_reverse, K.dma_chunked_scan)
    before = [fn.launches for fn in counters]
    a, b = (torch.from_numpy(x) for x in _scan_inputs(1, 20, 4))
    h = K.linear_scan(a, b)
    torch.testing.assert_close(K.dma_chunked_scan(a, b, chunk=8, nbuf=2), h)
    K.linear_scan_reverse(a, h, b)
    assert [fn.launches for fn in counters] == before


@pytest.mark.parametrize("last_state", [False, True])
def test_selective_scan_matches_jax(last_state):
    """selective_scan with z, D, delta_bias and softplus (BiMamba's call), and
    its last state, vs the JAX one under one jit. b2, d6, n16, l40."""
    rs = np.random.RandomState(5)
    bsz, d, n, l = 2, 6, 16, 40
    u = rs.standard_normal((bsz, d, l)).astype(np.float32)
    delta = (0.5 * rs.standard_normal((bsz, d, l))).astype(np.float32)
    A = -np.exp(rs.uniform(-1.0, 1.5, (d, n))).astype(np.float32)
    B = rs.standard_normal((bsz, n, l)).astype(np.float32)
    C = rs.standard_normal((bsz, n, l)).astype(np.float32)
    D = rs.standard_normal(d).astype(np.float32)
    z = rs.standard_normal((bsz, d, l)).astype(np.float32)
    bias = (0.1 * rs.standard_normal(d)).astype(np.float32)

    def run(fn, *xs):
        return fn(*xs[:6], z=xs[6], delta_bias=xs[7], delta_softplus=True,
                  return_last_state=last_state)

    args = (u, delta, A, B, C, D, z, bias)
    want = jax.jit(lambda *xs: run(JS.selective_scan, *xs))(*args)
    got = run(TS.selective_scan, *map(torch.from_numpy, args))
    want = want if last_state else (want,)
    got = got if last_state else (got,)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=1e-5, rtol=1e-5)
