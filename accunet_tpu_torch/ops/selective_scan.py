"""Selective scan (the Mamba SSM recurrence), counterpart of
accunet_tpu/ops/selective_scan.py (`selective_scan`).

The discretisation, the recurrence h[l] = exp(delta[l]*A)*h[l-1] +
delta[l]*B[l]*u[l] and the C contraction run as one fused kernel forward and
one backward (ops/kernels/selective_scan.py, `SelectiveScanFn`), so no
(B, L, D, N) tensor reaches device memory. Layouts follow the torch API, as
in JAX: u/delta (B, D, L), A (D, N), B/C (B, N, L), D (D,), z (B, D, L).

`selective_scan_rh`, the return-hidden variant, runs the return-hidden
kernels (`SelectiveScanRhFn`): every hidden state comes out of the kernel
as a (B, L, D, N) tensor and is returned as a (B, D, N, L) view of it.

Inside a `parallel.seq_scan.sequence_sharding(mesh)` context both take
JAX's unfused route (`_scan_bldn`, accunet_tpu/ops/selective_scan.py:35-57):
a = exp(delta*A) and delta*B*u as (B, L, D*N) tensors, the scan with its L
axis split over the mesh's seq axis (parallel/seq_scan.sharded_hidden: the
hand-written `linear_scan` kernel on each rank's L/n steps, then the carry
exchange), then the C contraction, D and z (or rh's (B, D, N, L) view of h).
A scan whose L the seq axis does not divide warns once and runs the fused
kernel. Outside a context nothing changes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from accunet_tpu_torch.ops.kernels.selective_scan import SelectiveScanFn, SelectiveScanRhFn
from accunet_tpu_torch.parallel import seq_scan


def _f32(t):
    return None if t is None else t.float()


def selective_scan(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                   delta_softplus=False, return_last_state=False):
    """Standard Mamba selective scan: y (B, D, L) [and the last state
    (B, D, N)], computed in float32 and returned in u's dtype."""
    dtype_in = u.dtype
    h = seq_scan.sharded_hidden(u, delta, A, B, delta_bias, delta_softplus)
    if h is not None:
        y = torch.einsum("bldn,bnl->bdl", h, C.float())
        if D is not None:
            y = y + u.float() * D.float()[None, :, None]
        if z is not None:
            y = y * F.silu(z.float())
        last = h[:, -1]
    else:
        y, last = SelectiveScanFn.apply(*map(_f32, (u, delta, A, B, C, D, z, delta_bias)),
                                        delta_softplus)
    y = y.to(dtype_in)
    if return_last_state:
        return y, last.to(dtype_in)
    return y


def selective_scan_rh(u, delta, A, B, delta_bias=None, delta_softplus=False):
    """Return-hidden selective scan: every hidden state h (B, D, N, L) in
    float32, a view of the kernel's (B, L, D, N) tensor (so h.reshape(B, D*N,
    L).transpose(1, 2) is the contiguous NHWC map of D*N channels)."""
    h = seq_scan.sharded_hidden(u, delta, A, B, delta_bias, delta_softplus)
    if h is None:
        h = SelectiveScanRhFn.apply(*map(_f32, (u, delta, A, B, delta_bias)), delta_softplus)
    return h.permute(0, 2, 3, 1)
