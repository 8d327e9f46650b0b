"""Chunked linear-recurrence scan h[t] = a[t]*h[t-1] + b[t] along axis 1 of
(B, L, D), with hand-written CUDA kernels (`csrc/linear_scan.cu`).

Counterparts:
  * `linear_scan` and its reverse form `linear_scan_reverse`, joined by
    `ChunkedLinearScanFn` / `chunked_linear_scan`: the TPU kernel
    `_chunked_scan_fwd` and its custom VJP `chunked_linear_scan`
    (accunet_tpu/ops/pallas/scan.py:62 / :101-129). The backward is the same
    recurrence run in reverse, G[t] = g[t] + a[t+1]*G[t+1], with da = G*h[t-1]
    and db = G (JAX `_bwd`, :119-126); the reverse kernel reads a[t+1] and
    h[t-1] by index instead of building flipped and shifted copies.
  * `dma_chunked_scan`: the TPU kernel of the same name
    (accunet_tpu/ops/pallas/scan_dma.py:114), forward only; its h is bitwise
    equal to `linear_scan`'s.

The kernels are bound by bytes (one FMA per 12 bytes moved); the source says
how each hides the latency of its sequential walk. They take float32 only:
`selective_scan` casts to float32 before the scan, as the JAX one does.
Each wrapper runs the plain version for a CPU tensor; for a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

import torch

from accunet_tpu_torch.ops.kernels import _build

_STAGE_COLS = 32  # columns per CTA of the staged kernel (csrc/linear_scan.cu)
_SMEM_LIMIT = 232448  # dynamic shared memory a block may use on the H100


def linear_scan_plain(a: torch.Tensor, b: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Plain PyTorch version. h[t] = a[t]*h[t-1] + b[t] (h[-1] = 0) along
    axis 1 of (B, L, D); with `reverse`, G[t] = b[t] + a[t+1]*G[t+1]
    (G[L] = 0). Log-depth doubling (Hillis-Steele), as JAX's `_xla_scan`
    (scan.py:91-98) computes it, in the inputs' dtype."""
    if reverse:
        a_next = torch.cat([a[:, 1:], torch.ones_like(a[:, :1])], dim=1)
        return linear_scan_plain(a_next.flip(1), b.flip(1)).flip(1)
    s, n = 1, a.shape[1]
    while s < n:
        b = torch.cat([b[:, :s], torch.addcmul(b[:, s:], a[:, s:], b[:, :-s])], dim=1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return b


def linear_scan_grads_plain(a: torch.Tensor, h: torch.Tensor, g: torch.Tensor):
    """Plain version of the backward: (da, db) = (G*h[t-1], G) with G the
    reverse scan of g (JAX `_bwd`)."""
    G = linear_scan_plain(a, g, reverse=True)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return G * h_prev, G


def _operands(a: torch.Tensor, *others: torch.Tensor) -> tuple[int, int, int]:
    if a.dim() != 3:
        raise ValueError(f"the scan kernels take (B, L, D) tensors, got {tuple(a.shape)}")
    _build.require(a, "a", dtype=torch.float32)
    for i, t in enumerate(others):
        _build.require(t, f"operand {i + 1}", a.shape, torch.float32, a.device)
    bsz, l, d = a.shape
    if bsz * d >= 2 ** 31 or l >= 2 ** 31:
        raise ValueError(f"scan shape {tuple(a.shape)} too large for the kernels' int sizes")
    return bsz, l, d


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h[t] = a[t]*h[t-1] + b[t] along axis 1. a, b (B, L, D) float32
    contiguous -> h (B, L, D)."""
    if a.device.type == "cpu":
        return linear_scan_plain(a, b)
    bsz, l, d = _operands(a, b)
    h = torch.empty_like(a)
    err = _build.load_library().accunet_linear_scan(
        a.data_ptr(), b.data_ptr(), h.data_ptr(), bsz, l, d, _build.stream_of(a))
    _build.check(err, "accunet_linear_scan")
    linear_scan.launches += 1
    return h


linear_scan.launches = 0


def linear_scan_reverse(a: torch.Tensor, h: torch.Tensor, g: torch.Tensor):
    """The scan's backward: a (B, L, D), h = linear_scan(a, b) and the
    cotangent g -> (da, db) = (G*h[t-1], G), G[t] = g[t] + a[t+1]*G[t+1]."""
    if a.device.type == "cpu":
        return linear_scan_grads_plain(a, h, g)
    bsz, l, d = _operands(a, h, g)
    da, db = torch.empty_like(a), torch.empty_like(a)
    err = _build.load_library().accunet_linear_scan_reverse(
        a.data_ptr(), h.data_ptr(), g.data_ptr(), da.data_ptr(), db.data_ptr(), bsz, l, d,
        _build.stream_of(a))
    _build.check(err, "accunet_linear_scan_reverse")
    linear_scan_reverse.launches += 1
    return da, db


linear_scan_reverse.launches = 0


class ChunkedLinearScanFn(torch.autograd.Function):
    """h = linear_scan(a, b), differentiable in a and b through the reverse
    kernel (JAX `chunked_linear_scan` with its custom VJP)."""

    @staticmethod
    def forward(ctx, a, b):
        h = linear_scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        return linear_scan_reverse(a, h, g.contiguous())


def chunked_linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ChunkedLinearScanFn.apply(a, b)


def dma_chunked_scan(a: torch.Tensor, b: torch.Tensor, chunk: int = 128,
                     nbuf: int = 4) -> torch.Tensor:
    """h[t] = a[t]*h[t-1] + b[t] along axis 1, forward only, through an
    nbuf-deep ring of (chunk x 32-column) tiles in shared memory filled by
    cp.async (JAX `dma_chunked_scan`, whose numerics equal
    `chunked_linear_scan`'s: here h is bitwise equal to `linear_scan`'s).
    a, b (B, L, D) float32 contiguous, 16-byte aligned, D % 4 == 0."""
    if a.device.type == "cpu":
        return linear_scan_plain(a, b)
    bsz, l, d = _operands(a, b)
    if nbuf not in (2, 3, 4):
        raise ValueError(f"dma_chunked_scan takes nbuf in (2, 3, 4), got {nbuf}")
    smem = nbuf * 2 * chunk * _STAGE_COLS * 4
    if chunk < 1 or smem > _SMEM_LIMIT:
        raise ValueError(f"chunk {chunk} x nbuf {nbuf} needs {smem} bytes of shared memory, "
                         f"over the {_SMEM_LIMIT} a block may use")
    if d % 4 or a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("dma_chunked_scan copies 16-byte pieces: it takes D % 4 == 0 and "
                         "16-byte aligned tensors")
    h = torch.empty_like(a)
    err = _build.load_library().accunet_linear_scan_staged(
        a.data_ptr(), b.data_ptr(), h.data_ptr(), bsz, l, d, chunk, nbuf, _build.stream_of(a))
    _build.check(err, "accunet_linear_scan_staged")
    dma_chunked_scan.launches += 1
    return h


dma_chunked_scan.launches = 0
