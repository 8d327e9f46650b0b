"""UNeXt, the tokenized-MLP UNet (torch.nn, NHWC): counterpart of
accunet_tpu/models/unext.py (`UNext`, `UNext_S`).

UNext is the port's UNextCMRF (models/unext_cmrf.py) with the plain stem
(encoder "conv"): the same modules and parameter names as JAX's UNext.

    stem: 3 x (3x3 conv -> BN -> 2x2 max-pool -> ReLU), 16/32/128 channels
        (pool before ReLU)
    tokenized MLP: OverlapPatchEmbed (k3 s2) 128 -> 160 -> 256, one
        ShiftedBlock each, LayerNorm
    decoder: 3x3 conv -> BN -> 2x bilinear upsample (align_corners=False)
        -> ReLU -> + skip (resized with align_corners=True when ragged),
        ShiftedBlocks at 160 / 128
    head: 1x1 conv to n_classes, sigmoid when n_classes == 1
    -> float32 (B, H', W', n_classes): H' is 32 times the bottleneck's
       side, H itself when 32 divides H (48 -> 64)

Every ShiftMLP's depthwise conv takes its weight gradient from the
`dwconv2d_wgrad` kernel, so a train step launches it once per ShiftedBlock
(4); an eval forward runs no hand-written kernel. `dtype` is the compute
type, as ACCUNet's (JAX's `dtype=`): None computes in the parameters' type,
torch.bfloat16 in bf16 with the fp32 parameters cast at use; the output is
float32.
"""

from __future__ import annotations

from typing import Sequence

import torch

from accunet_tpu_torch.models.unext_cmrf import UNextCMRF


class UNext(UNextCMRF):
    def __init__(self, n_channels: int = 3, n_classes: int = 1,
                 stem_dims: Sequence[int] = (16, 32, 128),
                 embed_dims: Sequence[int] = (128, 160, 256), final_sigmoid: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__(n_channels, n_classes, stem_dims, embed_dims, final_sigmoid,
                         encoder="conv", dtype=dtype)


def UNext_S(n_channels: int = 3, n_classes: int = 1, **kw) -> UNext:
    """The small variant: stem 8/16/32, token dims 32/64/128."""
    return UNext(n_channels, n_classes, stem_dims=(8, 16, 32), embed_dims=(32, 64, 128), **kw)
