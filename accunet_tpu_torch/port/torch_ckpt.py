"""Reference-format checkpoints (.pth.tar) into the port: counterpart of
accunet_tpu/port/torch_state.py (`load_torch_checkpoint`, the 5-D branch
of `_convert_leaf`, and the Swin surgery `swin_rename` / `swin_load_from`).

The reference's train script saves {'state_dict': model.state_dict(), ...},
with DataParallel's 'module.' prefixes when it trained on several cards. Its
SegMamba models are 3-D: each Conv3d / ConvTranspose3d runs on a volume of
depth 1, so with 'same' depth padding only the centre depth tap of a kernel
meets data (tap 0 of a depth-1 kernel). The port's 2-D convs hold that tap.
"""

from __future__ import annotations

import logging
import re
from typing import Mapping

import numpy as np
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


def swin_rename(n: str) -> str:
    """A port (JAX-tree) key of SwinUnet / SMESwinUnet -> the reference
    SwinTransformerSys key it loads from (nets/SwinUnet.py's layout)."""
    n = re.sub(r"^layers_(\d)_blocks\.", r"layers.\1.blocks.", n)
    n = re.sub(r"^layers_(\d)_downsample\.", r"layers.\1.downsample.", n)
    n = re.sub(r"^layers_up_(\d)_blocks\.", r"layers_up.\1.blocks.", n)
    n = re.sub(r"^layers_up_(\d)_upsample\.", r"layers_up.\1.upsample.", n)
    n = n.replace("patch_embed_proj.", "patch_embed.proj.")
    n = n.replace("patch_embed_norm.", "patch_embed.norm.")
    return n.replace("mlp_fc1.", "mlp.fc1.").replace("mlp_fc2.", "mlp.fc2.")


def swin_load_from(model: nn.Module, ckpt: Mapping) -> list[str]:
    """The reference's `SwinUnet.load_from` on the port's SwinUnet or
    SMESwinUnet, as JAX's `swin_load_from` does it:

      * a backbone checkpoint ({'model': ...}, e.g.
        swin_tiny_patch4_window7_224.pth) loads the encoder, and every entry
        `layers.{n}...` also loads the decoder's `layers_up.{3-n}...`;
      * a full-model dump (no 'model' key) loses the first 17 characters of
        each key and every key holding 'output';
      * the load is non-strict: an entry the model lacks, or whose shape
        differs from the model's (a bias table at another window size, other
        heads), leaves the model's value as it was.

    Values may be tensors or arrays. Returns the model's keys it loaded."""
    if "model" in ckpt:
        sd = dict(ckpt["model"])
        for k, v in list(sd.items()):
            if k.startswith("layers."):
                sd[f"layers_up.{3 - int(k[7:8])}" + k[8:]] = v
    else:
        sd = {k[17:]: v for k, v in ckpt.items() if "output" not in k}
    new = {}
    for key, want in model.state_dict().items():
        v = sd.get(swin_rename(key))
        if v is None or key.endswith("num_batches_tracked"):
            continue
        v = torch.from_numpy(np.array(v.detach().cpu() if hasattr(v, "detach") else v,
                                      dtype=np.float32))
        if v.shape == want.shape:
            new[key] = v
    model.load_state_dict(new, strict=False)
    return sorted(new)
