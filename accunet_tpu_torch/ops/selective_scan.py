"""Selective scan (the Mamba SSM recurrence), counterpart of
accunet_tpu/ops/selective_scan.py (`_scan_bldn`, `selective_scan`).

The recurrence h[l] = exp(delta[l]*A)*h[l-1] + delta[l]*B[l]*u[l] runs in a
(B, L, D, N) layout: L is the scan axis and D*N the columns of the chunked
linear-scan kernel (ops/kernels/scan.py), which is differentiable through
its reverse kernel. Layouts follow the torch API, as in JAX: u/delta
(B, D, L), A (D, N), B/C (B, N, L), D (D,), z (B, D, L).

Not ported yet: `selective_scan_rh` (the return-hidden variant) and the
sequence-sharded scan (`parallel/seq_scan.py`) that `_scan_bldn` takes under
an active mesh context.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from accunet_tpu_torch.ops.kernels.scan import chunked_linear_scan


def _scan_bldn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """First-order scan over axis 1 of (B, L, D, N) tensors: one chunked
    linear scan of the contiguous (B, L, D*N) view."""
    bb, l, d, n = a.shape
    h = chunked_linear_scan(a.reshape(bb, l, d * n).contiguous(),
                            b.reshape(bb, l, d * n).contiguous())
    return h.reshape(bb, l, d, n)


def selective_scan(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                   delta_softplus=False, return_last_state=False):
    """Standard Mamba selective scan: y (B, D, L) [and the last state
    (B, D, N)], computed in float32 and returned in u's dtype."""
    dtype_in = u.dtype
    # (B, L, D) views of the (B, D, L) operands, made contiguous once so that
    # the (B, L, D, N) products below come out contiguous
    u_t = u.float().transpose(1, 2).contiguous()
    dl = delta.float().transpose(1, 2)
    if delta_bias is not None:
        dl = dl + delta_bias.float()
    if delta_softplus:
        dl = F.softplus(dl)
    dl = dl.contiguous()
    bt = B.float().transpose(1, 2)  # (B, L, N)
    a = torch.exp(dl[..., None] * A.float())
    bu = (dl * u_t)[..., None] * bt[:, :, None, :]
    h = _scan_bldn(a, bu)
    y = torch.einsum("bldn,bln->bld", h, C.float().transpose(1, 2))
    if D is not None:
        y = y + u_t * D.float()
    if z is not None:
        y = y * F.silu(z.float().transpose(1, 2))
    y = y.transpose(1, 2).to(dtype_in)
    if return_last_state:
        return y, h[:, -1].to(dtype_in)
    return y
