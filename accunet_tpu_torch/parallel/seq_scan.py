"""Sequence-parallel linear scan over the mesh's seq axis: counterpart of
accunet_tpu/parallel/seq_scan.py.

The token axis L of the recurrence h[t] = a[t]*h[t-1] + b[t] is split over
the ranks of the seq axis, and the scan is completed with one small
exchange:

  1. each rank runs the hand-written `linear_scan` kernel on its L/n steps
     (ops/kernels/scan.ChunkedLinearScanFn, whose backward is the
     `linear_scan_reverse` kernel), giving h_local and the pair (prod a,
     h_local[-1]);
  2. the pairs, (B, D) each, are all-gathered over the seq axis and folded
     with the associative rule (A2*A1, A2*h1 + h2) into the rank's exclusive
     prefix, the state h_in that enters its first step;
  3. each rank corrects locally: h = h_local + cumprod(a) * h_in.

Every collective carries gradients (`_CarryIn`, parallel/comm.py).

`with sequence_sharding(mesh):` around a model call makes every selective
scan core (ops/selective_scan.py) take JAX's unfused route with the L axis
over the mesh's seq axis (`sharded_hidden`, which owns the whole decision);
the rest of the model runs
replicated on the seq ranks, as pjit runs it around JAX's shard_map. PyTorch
runs eagerly, so the context acts on the calls made inside it (JAX's bakes
the route into the functions traced inside it). A scan whose L the seq axis
does not divide warns once (`warn_divisibility_fallback`) and runs the fused
kernel, as JAX's runs its local kernel.
"""

from __future__ import annotations

import contextlib
import warnings

import torch
import torch.nn.functional as F

from accunet_tpu_torch.parallel.comm import (
    all_gather_list,
    gather_replicated,
    group_rank,
    group_size,
    slice_replicated,
)

_ACTIVE: list = []


@contextlib.contextmanager
def sequence_sharding(mesh):
    """Route the selective scans called inside this context over `mesh`'s
    seq axis (a parallel.mesh.Mesh; every rank of that axis runs the same
    model call)."""
    _ACTIVE.append(mesh)
    try:
        yield
    finally:
        _ACTIVE.pop()


_WARNED_FALLBACK: set = set()


def warn_divisibility_fallback(l: int, n_shards: int) -> None:
    """One RuntimeWarning per (L, shards) pair when an active
    sequence_sharding context could not engage because L % n_shards != 0:
    the scan runs the fused kernel on the whole L instead."""
    key = (int(l), int(n_shards))
    if key in _WARNED_FALLBACK:
        return
    _WARNED_FALLBACK.add(key)
    warnings.warn(
        f"sequence_sharding active but scan length L={l} is not divisible by the seq axis "
        f"size {n_shards}; falling back to the LOCAL fused scan (no sequence parallelism for "
        "this op)", RuntimeWarning, stacklevel=3)


def active():
    """The mesh of the innermost sequence_sharding context, else None."""
    return _ACTIVE[-1] if _ACTIVE else None


class _CarryIn(torch.autograd.Function):
    """h_in of this rank: the fold of the (prod a, h_last) pairs of the
    ranks before it, (B, D). Its backward sums every rank's cotangents of
    each pair (the later ranks consume it) with one all-reduce."""

    @staticmethod
    def forward(ctx, a_prod, h_last, group):
        pairs = all_gather_list(torch.stack([a_prod, h_last]), group)
        idx = group_rank(group)
        carries = [torch.zeros_like(h_last)]  # the state entering pair j
        for a_j, h_j in pairs[:idx]:
            carries.append(a_j * carries[-1] + h_j)
        ctx.group, ctx.idx = group, idx
        ctx.save_for_backward(torch.stack([p[0] for p in pairs]), torch.stack(carries))
        return carries[-1]

    @staticmethod
    def backward(ctx, g):
        a_all, carries = ctx.saved_tensors
        grads = torch.zeros((group_size(ctx.group), 2, *g.shape), dtype=g.dtype,
                            device=g.device)
        for j in reversed(range(ctx.idx)):
            grads[j, 0] = g * carries[j]
            grads[j, 1] = g
            g = g * a_all[j]
        torch.distributed.all_reduce(grads, group=ctx.group)
        own = grads[ctx.idx]
        return own[0], own[1], None


def sequence_parallel_scan(a: torch.Tensor, b: torch.Tensor, group) -> torch.Tensor:
    """h[t] = a[t]*h[t-1] + b[t] over axis 1 of this rank's (B, L/n, D)
    shards a, b of a sequence split over `group` in rank order; returns
    this rank's shard of h, with gradients in a and b."""
    from accunet_tpu_torch.ops.kernels.scan import chunked_linear_scan

    h_local = chunked_linear_scan(a.contiguous(), b.contiguous())
    if group is None:
        return h_local
    a_cum = torch.cumprod(a, dim=1)
    h_in = _CarryIn.apply(a_cum[:, -1], h_local[:, -1], group)
    return h_local + a_cum * h_in[:, None, :]


def shard_mapped_scan(a: torch.Tensor, b: torch.Tensor, mesh):
    """The scan of global (B, L, D) a, b that every rank of `mesh`'s seq
    axis holds: each scans its own L slice, and h is all-gathered along L
    (with gradient), replicated again for the rest of the model."""
    group = mesh.group("seq")
    h = sequence_parallel_scan(slice_replicated(a, 1, group), slice_replicated(b, 1, group),
                               group)
    return gather_replicated(h, 1, group)


def sharded_hidden(u, delta, A, B, delta_bias, delta_softplus):
    """Every hidden state (B, L, D, N) of a selective scan, in float32, by
    JAX's unfused route (`_scan_bldn`) with the L axis over the active
    context's seq axis; None outside a context, or when the seq axis does
    not divide L (after the one-shot warning): the caller then runs its
    fused kernel. Layouts as ops/selective_scan.py."""
    mesh = active()
    if mesh is None:
        return None
    length = u.shape[-1]
    if length % mesh.shape["seq"]:
        warn_divisibility_fallback(length, mesh.shape["seq"])
        return None
    delta = delta.float()
    if delta_bias is not None:
        delta = delta + delta_bias.float()[None, :, None]
    if delta_softplus:
        delta = F.softplus(delta)
    a = torch.exp(torch.einsum("bdl,dn->bldn", delta, A.float()))
    bu = torch.einsum("bdl,bnl,bdl->bldn", delta, B.float(), u.float())
    bsz, _, d, n = a.shape
    h = shard_mapped_scan(a.reshape(bsz, length, d * n), bu.reshape(bsz, length, d * n), mesh)
    return h.reshape(bsz, length, d, n)
