"""The return-hidden scan's chunk plan on the CPU: the plain chunk states and
the geometry that sizes the kernels' buffers.

  * `selective_scan_rh_states_plain` (the state entering each chunk of
    `RH_CHUNK` steps, the state the forward kernel saves for the backward)
    against JAX's `selective_scan_rh` h at each chunk's last step, fp32,
    tolerance 1e-5 of the largest state: L 1, 64, 300 and 3136 (below one
    chunk, half a chunk, a partial chunk, the Spatial-Mamba variant's
    stage 1), D 13 (a partial CTA and d-block), N 1 and 16;
  * `rh_geometry_plain`, the CPU mirror of the library's geometry query (the
    card tests hold the two equal): chunks of a partial last chunk and of L
    below one chunk, the d of a dB partial for N's lanes per d, and the
    partials of a partial d-block.

Inputs are seeded numpy arrays; JAX runs through one jit per shape compiled
with FAST_COMPILE. Tolerance: the same recurrence, associated differently
(JAX's associative scan against the plain sequential walk), 1e-5 relative.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accunet_tpu.ops.selective_scan import selective_scan_rh as j_scan_rh
from accunet_tpu_torch.ops.kernels import selective_scan as SS
from tests.test_torch_unext import _one_torch_thread, jax_run  # noqa: F401

D = 13
TOL = 1e-5


def _inputs(b, l, d, n, seed=0):
    rs = np.random.RandomState(seed)
    ops = (rs.standard_normal((b, d, l)), 0.5 * rs.standard_normal((b, d, l)),
           -np.exp(0.3 * rs.standard_normal((d, n))), rs.standard_normal((b, n, l)),
           0.1 * rs.standard_normal(d))
    return [a.astype(np.float32) for a in ops]


@pytest.mark.parametrize("n", [1, 16])
@pytest.mark.parametrize("l", [1, 64, 300, 3136])
def test_states_plain_match_jax_h_at_chunk_ends(l, n):
    ops = _inputs(2, l, D, n, seed=l + n)
    h = jax_run(lambda *a: j_scan_rh(*a, delta_softplus=True), *map(jnp.asarray, ops))
    assert h.shape == (2, D, n, l)  # (B, D, N, L)
    chunks = SS.rh_n_chunks(l)
    want = np.zeros((2, D, chunks, n), np.float32)
    for c in range(1, chunks):
        want[:, :, c] = h[..., c * SS.RH_CHUNK - 1]
    got = SS.selective_scan_rh_states_plain(*map(torch.from_numpy, ops), delta_softplus=True)
    assert got.shape == (2, D, chunks, n) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    assert not got[:, :, 0].any()  # nothing enters the first chunk
    scale = max(float(np.abs(h).max()), 1e-30)
    assert float(np.abs(got.numpy() - want).max()) <= TOL * scale


# (D, L, N) -> (chunks, d of a dB partial, partials)
GEOMETRY = [
    ((96, 12544, 16), (98, 8, 12)),  # the variant's stage 0: 12 partials, 77 MB
    ((13, 300, 16), (3, 8, 2)),      # a partial last chunk; a partial d-block
    ((8, 256, 16), (2, 8, 1)),       # whole chunks and one d-block: dB itself
    ((20, 100, 16), (1, 8, 3)),      # L below one chunk
    ((13, 1, 16), (1, 8, 2)),        # one step
    ((128, 3136, 1), (25, 8, 16)),   # N 1: lanes of 4, no cluster
    ((9, 129, 3), (2, 8, 2)),        # N 3 (lanes padded to 4), one step past a chunk
    ((13, 300, 5), (3, 16, 1)),      # N 5: lanes of 8, 4 d a CTA, clusters of 4
    ((13, 300, 32), (3, 4, 4)),      # N 32: one d a CTA
]


@pytest.mark.parametrize("dln,want", GEOMETRY)
def test_rh_geometry_plain(dln, want):
    d, l, n = dln
    geo = SS.rh_geometry_plain(d, l, n)
    assert geo.chunk == SS.RH_CHUNK
    assert (geo.n_chunks, geo.dblock, geo.blocks) == want
    assert geo.n_chunks == SS.rh_n_chunks(l)
    # every step falls in a chunk and every d in a block, with no block empty
    assert (geo.n_chunks - 1) * geo.chunk < l <= geo.n_chunks * geo.chunk
    assert (geo.blocks - 1) * geo.dblock < d <= geo.blocks * geo.dblock


def test_states_plain_below_one_chunk_is_zero():
    """L below one chunk: a single state, the zero one entering it."""
    ops = _inputs(1, 40, 5, 16)
    states = SS.selective_scan_rh_states_plain(*map(torch.from_numpy, ops), delta_softplus=True)
    assert states.shape == (1, 5, 1, 16) and not states.any()
