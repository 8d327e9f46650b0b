"""The mesh of ranks and the placement of a train step on it: counterpart of
accunet_tpu/parallel/mesh.py.

The port runs one process per device, so a mesh is a grid of the ranks of
the default process group with JAX's axes:

    data  — the global batch is split across it (each rank its contiguous
            batch / data slice);
    model — parameters of at least `min_weight_size` elements are stored
            sharded across it along their output features;
    seq   — the selective scan's L axis is split across it
            (parallel/seq_scan.py).

Rank r sits at (r // (model * seq), r // seq % model, r % seq), JAX's device
order (`np.array(devices).reshape(data, model, seq)`). Each axis has the
process group of the ranks that share the other two coordinates; an axis of
size 1 has none. What pjit gives JAX the step here gets from the collectives
of parallel/comm.py, so a step on any mesh computes what one process does on
the global batch: BatchNorm's statistics over the global batch
(`set_batch_group`), the loss and metrics on the gathered predictions
(`gather_batch`), the gradients summed over the data axis
(`reduce_gradients`), and the sharded weights gathered whole for the step
(`ShardedParams`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator

import torch
import torch.distributed as dist
from torch import nn

from accunet_tpu_torch.parallel.comm import all_gather_list, gather_replicated

AXES = ("data", "model", "seq")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    data: int = -1  # -1: all remaining ranks
    model: int = 1
    seq: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int]:
        d = self.data
        if d == -1:
            d = n_devices // (self.model * self.seq)
        if d * self.model * self.seq != n_devices:
            raise ValueError(f"mesh {d}x{self.model}x{self.seq} != {n_devices} devices")
        return d, self.model, self.seq


class Mesh:
    """A (data, model, seq) grid of `world_size` ranks, seen from `rank`.
    Building one with more than one rank creates the axes' process groups,
    so every rank of the default group builds it, in the same order."""

    def __init__(self, spec: MeshSpec, world_size: int, rank: int):
        d, m, s = spec.resolve(world_size)
        self.shape = {"data": d, "model": m, "seq": s}
        self.rank = rank
        self.coords = {"data": rank // (m * s), "model": rank // s % m, "seq": rank % s}
        self._groups = {}
        for axis in AXES:
            self._groups[axis] = None
            if self.shape[axis] == 1:
                continue
            for ranks in self._axis_rank_lists(axis):
                group = dist.new_group(ranks)
                if rank in ranks:
                    self._groups[axis] = group

    def _axis_rank_lists(self, axis: str) -> list[list[int]]:
        d, m, s = (self.shape[a] for a in AXES)
        flat = lambda c: (c["data"] * m + c["model"]) * s + c["seq"]  # noqa: E731
        others = [a for a in AXES if a != axis]
        lists = []
        for i in range(self.shape[others[0]]):
            for j in range(self.shape[others[1]]):
                lists.append([flat({axis: k, others[0]: i, others[1]: j})
                              for k in range(self.shape[axis])])
        return lists

    def group(self, axis: str):
        """The process group of `axis` (None for an axis of size 1)."""
        return self._groups[axis]

    @property
    def is_chief(self) -> bool:
        """Rank 0, the rank that logs and writes checkpoints."""
        return self.rank == 0


def make_mesh(spec: MeshSpec | None = None) -> Mesh:
    """The mesh of the default process group (one rank when there is none)."""
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    return Mesh(spec or MeshSpec(), world, rank)


def batch_slice(mesh: Mesh, global_batch: int) -> slice:
    """This rank's contiguous slice of a global batch (JAX's shard_batch):
    data coordinate i takes rows [i * b, (i + 1) * b), b = global_batch /
    data. Ranks that share a data coordinate take the same rows. The train
    CLI's loaders load only that slice (BatchLoader's process_index and
    process_count are the data coordinate and size)."""
    n = mesh.shape["data"]
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by the data axis {n}")
    per = global_batch // n
    return slice(mesh.coords["data"] * per, (mesh.coords["data"] + 1) * per)


def gather_batch(mesh: Mesh, preds):
    """The global batch's predictions (or each head of a tuple), concatenated
    over the data axis in rank order, with gradient: the loss and metrics
    of the global batch are computed from them on every rank alike."""
    if isinstance(preds, (tuple, list)):
        return type(preds)(gather_batch(mesh, p) for p in preds)
    return gather_replicated(preds, 0, mesh.group("data"))


def set_batch_group(model: nn.Module, group) -> None:
    """Attach `group` (the data axis's, or None) to every BatchNorm of
    `model`: in train mode each then takes its statistics over the global
    batch (nn/acc_blocks.BatchNorm)."""
    from accunet_tpu_torch.nn.acc_blocks import BatchNorm

    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.batch_group = group


def _flat_collective(tensors, op) -> None:
    """op(flat) on one flat copy of `tensors` per dtype (in the order of
    first appearance, the same on every rank), copied back in place."""
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        same = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in same])
        op(flat)
        offset = 0
        for t in same:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def reduce_gradients(params, group) -> None:
    """Sum the gradients of `params` over `group`, one all-reduce per dtype.
    Each data rank holds the part of the global batch's gradient that flows
    through its own slice; the ranks of the model and seq axes hold the
    same gradients already, so the sum is over the data axis alone."""
    if group is not None:
        _flat_collective([p.grad for p in params if p.grad is not None],
                         lambda flat: dist.all_reduce(flat, group=group))


def broadcast_from_rank0(model: nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank, one broadcast per
    dtype."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return
    with torch.no_grad():
        _flat_collective([t.data for t in list(model.parameters()) + list(model.buffers())],
                         lambda flat: dist.broadcast(flat, src=0))


def param_sharding_rules(mesh: Mesh, min_weight_size: int = 2 ** 18):
    """The rule of JAX's param_sharding_rules: a kernel of at least
    `min_weight_size` elements, of rank 2 or more, is sharded over the model
    axis along its output features when the model axis divides them, and
    every other parameter is replicated. In torch's layout the output
    features are dim 0 of a conv or linear weight (dim 1 of a transposed
    conv's) and the last dim of a raw parameter, as JAX's last axis. Returns
    rules(model) -> {parameter name: dim} of the sharded ones."""
    n = mesh.shape["model"]

    def rules(model: nn.Module) -> dict[str, int]:
        out = {}
        for mod_name, mod in model.named_modules():
            for p_name, p in mod.named_parameters(recurse=False):
                if n == 1 or p.dim() < 2 or p.numel() < min_weight_size:
                    continue
                if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Linear)) and p_name == "weight":
                    dim = 0
                elif isinstance(mod, nn.ConvTranspose2d) and p_name == "weight":
                    dim = 1
                else:
                    dim = p.dim() - 1
                if p.shape[dim] % n == 0:
                    out[f"{mod_name}.{p_name}" if mod_name else p_name] = dim
        return out

    return rules


@dataclasses.dataclass
class _Shard:
    name: str
    full: nn.Parameter  # the module's own; empty between steps
    shape: torch.Size  # its whole shape
    dim: int
    shard: nn.Parameter  # what the optimizer steps


class ShardedParams:
    """The parameters `dims` ({name: dim}, from param_sharding_rules) stored
    sharded over the mesh's model axis: model rank m keeps slice m of each
    along its dim as a Parameter of its own, which the optimizer steps, so
    the parameter and its optimizer state hold 1/model of that dim. The
    module's Parameter is an empty tensor between steps; inside
    `gathered()` it holds the whole weight, all-gathered (the kernels read
    it whole), and `take_grads` hands its gradient's own slice to the
    shard. The model ranks compute the same step, so that slice is the
    shard's gradient: the all-gather's adjoint in a replicated step."""

    def __init__(self, model: nn.Module, mesh: Mesh, dims: dict[str, int]):
        self.group, self.index, n = mesh.group("model"), mesh.coords["model"], mesh.shape["model"]
        named = dict(model.named_parameters())
        self.items = []
        for name, dim in dims.items():
            p = named[name]
            size = p.shape[dim] // n
            shard = nn.Parameter(p.detach().narrow(dim, self.index * size, size).clone())
            self.items.append(_Shard(name, p, p.shape, dim, shard))
        self.release()

    def _own(self, it: _Shard, t: torch.Tensor) -> torch.Tensor:
        size = it.shard.shape[it.dim]
        return t.narrow(it.dim, self.index * size, size)

    def optimizer_params(self, model: nn.Module) -> list[nn.Parameter]:
        """model.parameters() in order, each sharded one by its shard."""
        by_id = {id(it.full): it.shard for it in self.items}
        return [by_id.get(id(p), p) for p in model.parameters()]

    def gather(self) -> None:
        with torch.no_grad():
            for it in self.items:
                it.full.data = torch.cat(all_gather_list(it.shard.detach(), self.group), it.dim)

    def release(self) -> None:
        for it in self.items:
            it.full.data = it.full.data.new_empty(0)
            it.full.grad = None

    @contextlib.contextmanager
    def gathered(self) -> Iterator[None]:
        self.gather()
        try:
            yield
        finally:
            self.release()

    def take_grads(self) -> None:
        for it in self.items:
            g = it.full.grad
            it.shard.grad = None if g is None else self._own(it, g).clone()
            it.full.grad = None

    def reshard(self) -> None:
        """Each shard from its whole (gathered or just loaded) weight."""
        with torch.no_grad():
            for it in self.items:
                it.shard.copy_(self._own(it, it.full))

    def _map_state(self, opt_state: dict, optimizer_params, fn) -> dict:
        index = {id(p): i for i, p in enumerate(optimizer_params)}
        state = dict(opt_state["state"])
        for it in self.items:
            i = index[id(it.shard)]
            if i in state:
                state[i] = {k: fn(it, v) if torch.is_tensor(v) and v.dim() else v
                            for k, v in state[i].items()}
        return {**opt_state, "state": state}

    def full_optimizer_state(self, opt_state: dict, optimizer_params) -> dict:
        """The optimizer's state_dict with each sharded parameter's moments
        gathered whole: the state a one-process run holds (a collective)."""
        return self._map_state(opt_state, optimizer_params, lambda it, v: torch.cat(
            all_gather_list(v, self.group), it.dim))

    def local_optimizer_state(self, opt_state: dict, optimizer_params) -> dict:
        """A whole optimizer state_dict cut to this rank's shards."""
        return self._map_state(opt_state, optimizer_params,
                               lambda it, v: self._own(it, v).clone())
