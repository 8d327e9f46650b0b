"""Reference-format checkpoints (.pth.tar) into the port: counterpart of
accunet_tpu/port/torch_state.py (`load_torch_checkpoint` and the 5-D branch
of `_convert_leaf`).

The reference's train script saves {'state_dict': model.state_dict(), ...},
with DataParallel's 'module.' prefixes when it trained on several cards. Its
SegMamba models are 3-D: each Conv3d / ConvTranspose3d runs on a volume of
depth 1, so with 'same' depth padding only the centre depth tap of a kernel
meets data (tap 0 of a depth-1 kernel). The port's 2-D convs hold that tap.
"""

from __future__ import annotations

import logging

import torch
from torch import nn


def read_checkpoint(path: str) -> dict:
    """The flat state dict of a .pth.tar ({'state_dict': ...} or a bare
    state dict), without 'module.' prefixes."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k.removeprefix("module."): v for k, v in state.items()}


def reference_state_dict(path: str, model: nn.Module) -> dict:
    """The checkpoint at `path` as `model`'s state dict entries: a 5-D
    kernel where the model holds a 4-D conv (O, I, kh, kw) or transposed
    conv (I, O, kh, kw) gives its centre depth tap; any other shape that
    differs from the model's raises, naming the key. Entries the model lacks
    pass through unchanged."""
    target = model.state_dict()
    out = {}
    for key, v in read_checkpoint(path).items():
        want = target.get(key)
        if want is not None and v.shape != want.shape:
            if v.ndim == 5 and want.ndim == 4 and v.shape[:2] + v.shape[3:] == want.shape:
                v = v[:, :, v.shape[2] // 2]
            else:
                raise ValueError(f"checkpoint entry {key!r} has shape {tuple(v.shape)}, the "
                                 f"model's {tuple(want.shape)}")
        out[key] = v
    return out


def load_reference_checkpoint(model: nn.Module, path: str) -> None:
    """Load a reference-format .pth.tar into `model`: every entry of the
    model but BN's num_batches_tracked must be in the file; entries the
    model lacks (the reference's unused modules) are ignored with a log
    line."""
    missing, unexpected = model.load_state_dict(reference_state_dict(path, model), strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} entries, e.g. {missing[:5]}")
    if unexpected:  # e.g. the Lite reference's unused MLFC convs, KNUnet's vssblock
        logging.info("ignored %d checkpoint entries, e.g. %s", len(unexpected), unexpected[:3])
