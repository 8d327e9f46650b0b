"""SMESwin-Unet, Swin-Unet with its skips refined by a boundary cue, a
channel transformer and external attention (torch.nn, NHWC): counterpart of
accunet_tpu/models/sme_swin_unet.py.

    boundary_support_image: the channel mean's Sobel gradient magnitude
        (zero padding); pixels above 0.3 painted (1, 1, 0). JAX's in-graph
        stand-in for the reference's `mark_boundaries(x, slic(x))`
    cnnt1: a 3x3 stride-2 conv of the support image to 48 channels (d0)
    mcct: the ChannelTransformer (models/uctransnet.py) over d0 and the
        first three Swin skips d1-d3, img_size / 2 with patches img / 2,
        img / 4, img / 8 and img / 16, so one token a level; its
        Reconstructs' BatchNorms follow the train mode
    EA_channeld1-3: ExternalAttention(S = 8) on the refined d1-d3 tokens
    the Swin encoder, decoder and head: SwinUnet's, under the same names,
        so the Swin checkpoint surgery (`port.swin_load_from`) applies

The reference also builds a `cnn4supp` it never calls; it is not built, as
in JAX. No hand-written kernel runs on this model's path.
"""

from __future__ import annotations

import torch
from torch import nn

from accunet_tpu_torch.models.swin_unet import DEPTHS, SwinUnet
from accunet_tpu_torch.models.uctransnet import ChannelTransformer
from accunet_tpu_torch.nn.attention import ExternalAttention
from accunet_tpu_torch.ops.conv import conv2d_strided

SUPPORT_CHANNELS = 48  # cnnt1's width: d0's channels in the mcct
EA_SLOTS = 8


def boundary_mask(x: torch.Tensor, threshold: float = 0.3) -> torch.Tensor:
    """(B, H, W, 1) in x's type: 1 where the Sobel gradient magnitude of the
    channel mean of x (B, H, W, C) exceeds `threshold`. The mean sums in fp32
    (or wider), as jnp.mean does; the taps are shifted slices summed in a
    fixed order, so every device computes the same magnitudes (a library
    convolution could pick an FFT or Winograd engine and move one across
    the threshold)."""
    ct = torch.promote_types(x.dtype, torch.float32)
    gray = x[..., :1].to(ct)
    for i in range(1, x.shape[-1]):
        gray = gray + x[..., i:i + 1].to(ct)
    g = torch.nn.functional.pad((gray / x.shape[-1]).to(x.dtype), (0, 0, 1, 1, 1, 1))
    h, w = x.shape[1], x.shape[2]

    def at(di, dj):  # gray[i + di, j + dj], zero outside the map
        return g[:, 1 + di:1 + di + h, 1 + dj:1 + dj + w]

    gx = (at(-1, 1) - at(-1, -1)) + 2 * (at(0, 1) - at(0, -1)) + (at(1, 1) - at(1, -1))
    gy = (at(1, -1) - at(-1, -1)) + 2 * (at(1, 0) - at(-1, 0)) + (at(1, 1) - at(-1, 1))
    return (torch.sqrt(gx * gx + gy * gy) > threshold).to(x.dtype)


def boundary_support_image(x: torch.Tensor, threshold: float = 0.3) -> torch.Tensor:
    """x (B, H, W, 3) with the boundary pixels painted (1, 1, 0), the colour
    of `mark_boundaries`."""
    mask = boundary_mask(x, threshold)
    color = torch.tensor([1.0, 1.0, 0.0], dtype=x.dtype, device=x.device)
    return x * (1 - mask) + color * mask


class SMESwinUnet(SwinUnet):
    """x (B, img_size, img_size, n_channels) -> float32 (B, img_size,
    img_size, 1 or n_classes + 1), as SwinUnet."""

    def __init__(self, n_channels: int = 3, n_classes: int = 1, img_size: int = 224,
                 embed_dim: int = 96, window_size: int = 7, final_sigmoid: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__(n_channels, n_classes, img_size, embed_dim, window_size,
                         final_sigmoid, dtype)
        sup, ed = img_size // 2, embed_dim
        self.cnnt1 = nn.Conv2d(3 if n_channels == 1 else n_channels, SUPPORT_CHANNELS, 3,
                               stride=2, padding=1)
        self.mcct = ChannelTransformer((SUPPORT_CHANNELS, ed, 2 * ed, 4 * ed), sup,
                                       patch_sizes=(sup, sup // 2, sup // 4, sup // 8))
        for i in range(1, len(DEPTHS)):
            setattr(self, f"EA_channeld{i}", ExternalAttention(ed << (i - 1), EA_SLOTS))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.prepare(x)
        c = self.cnnt1
        d0 = conv2d_strided(boundary_support_image(x), c.weight, c.bias, 2, 1)
        tok, skips = self.encode(x)
        b = x.shape[0]
        maps = [s.reshape(b, self.pres >> i, self.pres >> i, -1) for i, s in enumerate(skips[:3])]
        refined = self.mcct([d0, *maps])[1:]
        skips = [getattr(self, f"EA_channeld{i + 1}")(m.flatten(1, 2))
                 for i, m in enumerate(refined)] + skips[3:]
        return self.decode(tok, skips)
