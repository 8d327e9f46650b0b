"""Selective scan (the Mamba SSM recurrence), counterpart of
accunet_tpu/ops/selective_scan.py (`selective_scan`).

The discretisation, the recurrence h[l] = exp(delta[l]*A)*h[l-1] +
delta[l]*B[l]*u[l] and the C contraction run as one fused kernel forward and
one backward (ops/kernels/selective_scan.py, `SelectiveScanFn`), so no
(B, L, D, N) tensor reaches device memory. Layouts follow the torch API, as
in JAX: u/delta (B, D, L), A (D, N), B/C (B, N, L), D (D,), z (B, D, L).

Not ported yet: `selective_scan_rh` (the return-hidden variant; it is to
extend the fused forward with a hidden-state output) and the
sequence-sharded scan (`parallel/seq_scan.py`) that JAX's `_scan_bldn` takes
under an active mesh context.
"""

from __future__ import annotations

from accunet_tpu_torch.ops.kernels.selective_scan import SelectiveScanFn


def _f32(t):
    return None if t is None else t.float()


def selective_scan(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                   delta_softplus=False, return_last_state=False):
    """Standard Mamba selective scan: y (B, D, L) [and the last state
    (B, D, N)], computed in float32 and returned in u's dtype."""
    dtype_in = u.dtype
    y, last = SelectiveScanFn.apply(*map(_f32, (u, delta, A, B, C, D, z, delta_bias)),
                                    delta_softplus)
    y = y.to(dtype_in)
    if return_last_state:
        return y, last.to(dtype_in)
    return y
