"""Collectives over a torch.distributed group that carry gradients.

The port runs one process per device, so every tensor of a step is either
distinct on each rank of a group (its slice of the batch or of the
sequence) or replicated across it (the same value on every rank, computed by
each). These autograd Functions move between the two, and each backward is
the adjoint under that reading:

  * `gather_replicated`: every rank's x concatenated along `dim`, the same
    on every rank, and so is the cotangent that comes back (the consumers
    compute the same thing on every rank): each rank takes its own slice.
  * `slice_replicated`: a rank's slice along `dim` of a tensor replicated
    over the group; the cotangent of the whole is every rank's slice
    gathered.
  * `gather_stacked`: every rank's x stacked on a new first axis, which
    each rank then uses in its own way (BatchNorm's per-rank statistics
    normalise each rank's slice): the cotangent of rank r's x is the sum of
    every rank's cotangent of entry r.

They use all-reduce and all-gather only, which gloo runs on CUDA tensors
too, so the same code runs several ranks on one card over gloo, or one rank
a card over NCCL. A group of None is a single rank: each Function is then the
identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_gather_list(x: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's x (same shape on every rank), in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x, group=group)
    return parts


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.size = dim, group, x.shape[dim]
        return torch.cat(all_gather_list(x, group), dim)

    @staticmethod
    def backward(ctx, g):
        lo = group_rank(ctx.group) * ctx.size
        return g.narrow(ctx.dim, lo, ctx.size).contiguous(), None, None


def gather_replicated(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _GatherReplicated.apply(x, dim, group)


class _SliceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        n = group_size(group)
        if x.shape[dim] % n:
            raise ValueError(f"axis {dim} of {tuple(x.shape)} does not split into {n} slices")
        ctx.dim, ctx.group = dim, group
        size = x.shape[dim] // n
        return x.narrow(dim, group_rank(group) * size, size).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return torch.cat(all_gather_list(g, ctx.group), ctx.dim), None, None


def slice_replicated(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _SliceReplicated.apply(x, dim, group)


class _GatherStacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return torch.stack(all_gather_list(x, group))

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[group_rank(ctx.group)], None


def gather_stacked(x: torch.Tensor, group) -> torch.Tensor:
    return x[None] if group is None else _GatherStacked.apply(x, group)
