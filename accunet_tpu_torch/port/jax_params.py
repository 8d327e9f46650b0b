"""JAX variables -> port state_dict.

The exact inverse of the torch -> flax mapping in
accunet_tpu/port/torch_state.py (`_torch_key` / `_convert_leaf`): flax
submodule names mirror the reference torch attribute names, with

  * `foo_3` for the ModuleList entry `foo.3` (and `a__b` for a literal `a_b`),
  * conv kernels HWIO -> OIHW, Conv1d kernels (K, I/g, O) -> (O, I/g, K),
    transposed-conv `kernel_t` (kh,kw,I,O) -> (I,O,kh,kw), Dense kernels
    (in,out) -> (out,in),
  * BatchNorm scale/bias -> weight/bias and batch_stats mean/var ->
    running_mean/running_var (plus a zero num_batches_tracked).

The result loads into the port with `load_state_dict(strict=True)`.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


def _rewrite_indices(piece: str) -> str:
    m = re.match(r"^(.*)_(\d+)$", piece)
    if m:
        return f"{_rewrite_indices(m.group(1))}.{m.group(2)}"
    return piece


def _torch_key(path: tuple[str, ...]) -> str:
    return ".".join(
        "_".join(_rewrite_indices(seg) for seg in p.split("__")) for p in path
    )


def _convert(leaf: str, v: np.ndarray) -> np.ndarray:
    if leaf == "kernel_t":
        return v.transpose(2, 3, 0, 1)
    if leaf == "kernel":
        if v.ndim == 4:
            return v.transpose(3, 2, 0, 1)
        if v.ndim == 3:
            return v.transpose(2, 1, 0)
        if v.ndim == 2:
            return v.T
        raise ValueError(f"unsupported kernel rank {v.ndim}")
    return v


def state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a flax {'params', 'batch_stats'} tree (numpy or jax arrays) to a
    flat torch state_dict of fp32 tensors."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, path, coll):
        if isinstance(tree, Mapping):
            for k, v in tree.items():
                walk(v, path + (k,), coll)
            return
        v = np.array(tree, dtype=np.float32)  # a writable copy
        mod, leaf = _torch_key(path[:-1]), path[-1]
        if coll == "batch_stats":
            name = {"mean": "running_mean", "var": "running_var"}[leaf]
            out[f"{mod}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        elif leaf == "scale":
            name = "weight"
        elif leaf in ("kernel", "kernel_t"):
            name = "weight"
        elif leaf == "bias":
            name = "bias"
        else:  # scalar parameters such as the MLFC blend 'W'
            out[_torch_key(path)] = torch.from_numpy(np.ascontiguousarray(v))
            return
        out[f"{mod}.{name}"] = torch.from_numpy(np.ascontiguousarray(_convert(leaf, v)))

    for coll in ("params", "batch_stats"):
        if coll in variables:
            walk(variables[coll], (), coll)
    return out
