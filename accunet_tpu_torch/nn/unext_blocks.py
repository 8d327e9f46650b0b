"""UNeXt tokenized-MLP blocks (torch.nn, NHWC), counterpart of
accunet_tpu/nn/unext_blocks.py.

The JAX blocks carry tokens (B, H*W, C) beside H and W; here they stay
(B, H, W, C) maps, since `nn.Linear` and LayerNorm act on the last axis
either way. Attribute names follow the JAX tree (`state_dict_from_jax`).

  * axial_shift: per channel chunk a zero-filled shift along H or W;
  * DWConv: the 3x3 depthwise conv of the token MLP, whose weight gradient
    is the `dwconv2d_wgrad` kernel (ops/conv.py:depthwise_conv2d);
  * ShiftMLP: shift H -> fc1 -> DWConv -> exact GELU -> shift W -> fc2;
  * ShiftedBlock: x + ShiftMLP(LayerNorm(x));
  * OverlapPatchEmbed: a k3 s2 p1 conv, then LayerNorm.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from accunet_tpu_torch.ops.conv import depthwise_conv2d


def _torch_chunk_sizes(c: int, n: int) -> list[int]:
    """torch.chunk semantics: ceil(c/n) per chunk, the remainder in the last,
    zero-size chunks at the tail when c runs out."""
    size = -(-c // n)
    sizes = [min(size, c - start) for start in range(0, c, size)]
    return sizes + [0] * (n - len(sizes))


def axial_shift(x: torch.Tensor, axis: int, shift_size: int = 5) -> torch.Tensor:
    """Chunk i of the channels (torch.chunk into shift_size) shifted by
    i - shift_size // 2 along `axis` (1 = H, 2 = W of NHWC), zero-filled:
    out[h] = x[h - s]. One zero pad, then a slice per chunk (exact)."""
    pad = shift_size // 2
    n = x.shape[axis]
    xp = F.pad(x, (0, 0, pad, pad) if axis == 2 else (0, 0, 0, 0, pad, pad))
    chunks = xp.split(_torch_chunk_sizes(x.shape[-1], shift_size), dim=-1)
    return torch.cat([c.narrow(axis, pad - s, n)
                      for c, s in zip(chunks, range(-pad, pad + 1))], dim=-1)


class DWConv(nn.Module):
    """3x3 depthwise conv with bias, SAME padding."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return depthwise_conv2d(x, self.dwconv.weight, self.dwconv.bias)


class ShiftMLP(nn.Module):
    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 shift_size: int = 5):
        super().__init__()
        self.shift_size = shift_size
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.dwconv = DWConv(hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc1(axial_shift(x, 1, self.shift_size))
        x = F.gelu(self.dwconv(x))
        return self.fc2(axial_shift(x, 2, self.shift_size))


class ShiftedBlock(nn.Module):
    def __init__(self, dim: int, mlp_ratio: float = 1.0):
        super().__init__()
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = ShiftMLP(dim, int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.mlp(self.norm2(x))


class OverlapPatchEmbed(nn.Module):
    def __init__(self, in_chans: int, embed_dim: int, patch_size: int = 3, stride: int = 2):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=stride,
                              padding=patch_size // 2)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return self.norm(y)
