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
Each block computes in its input's type with its parameters cast at use;
LayerNorm normalises in fp32 and returns the input's type, as flax's
LayerNorm(dtype=bfloat16) does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from accunet_tpu_torch.ops.conv import conv2d_strided, depthwise_conv2d, linear


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


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm over the last axis, computed in fp32 (float64 stays
    float64) and returned in the input's type."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ct = torch.promote_types(x.dtype, torch.float32)
        return F.layer_norm(x.to(ct), self.normalized_shape, self.weight.to(ct),
                            self.bias.to(ct), self.eps).to(x.dtype)


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
        x = linear(axial_shift(x, 1, self.shift_size), self.fc1.weight, self.fc1.bias)
        x = F.gelu(self.dwconv(x))
        return linear(axial_shift(x, 2, self.shift_size), self.fc2.weight, self.fc2.bias)


class ShiftedBlock(nn.Module):
    def __init__(self, dim: int, mlp_ratio: float = 1.0):
        super().__init__()
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = ShiftMLP(dim, int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.mlp(self.norm2(x))


class OverlapPatchEmbed(nn.Module):
    def __init__(self, in_chans: int, embed_dim: int, patch_size: int = 3, stride: int = 2):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=stride,
                              padding=patch_size // 2)
        self.norm = LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.proj
        return self.norm(conv2d_strided(x, p.weight, p.bias, p.stride, p.padding))
