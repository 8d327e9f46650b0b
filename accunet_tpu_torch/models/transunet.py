"""TransUNet, a ViT encoder (optionally over a ResNetV2 hybrid stem) with the
CUP decoder (torch.nn, NHWC): counterpart of accunet_tpu/models/transunet.py.

    ResNetV2 (R50-ViT-B_16): weight-standardised convs (StdConv: the raw
        kernel standardised over I, H, W, eps 1e-5, in fp32), GroupNorm(32,
        eps 1e-6); root 7x7/2 conv, GN, ReLU, a 3/2 max-pool without padding;
        blocks of pre-activation bottlenecks (3, 4, 9 units; the first of
        blocks 2-3 strided, gn_proj a GroupNorm of one channel a group, eps
        1e-5); the root and block 1-2 outputs are the skips, zero-padded at
        the bottom and right to in_size // 4 // (b + 1)
    embeddings: a patchify conv (16x16 on the image, or 1x1 on the hybrid's
        1024 channels) plus zero-initialised position embeddings over the
        (img_size / 16)^2 grid
    ViTBlock: pre-LN multi-head attention (matmuls and an explicit softmax,
        no library attention kernel), then a pre-LN MLP: dense (exact GELU)
        or, with mlp_type 'fkan', a second LayerNorm and KAN((hidden,
        mlp_dim, hidden)) over the flattened tokens (fractional-Jacobi base);
        LayerNorms eps 1e-6
    decoder: conv_more (3x3 conv, BN, ReLU to 512), four DecoderBlocks
        (bilinear 2x upsample with align_corners=True, concat the skip,
        two Conv2dReLUs), a 3x3 segmentation head to n_classes (no +1),
        sigmoid for one class

One input channel is repeated to three. GroupNorm computes in fp32 or wider
and returns that type, as flax's GroupNorm without a dtype does, so under
dtype=torch.bfloat16 the ResNetV2 body runs in fp32 as in JAX. `img_size`
sizes the position embeddings, which JAX takes from the input at init: the
CLIs pass the image size (models/__init__.py `build`'s input_size). Names follow the
JAX tree (`layer_0` is `layer.0`, `blocks_0` is `blocks.0`, a Conv2dReLU's
conv and BN are `0` and `1`); `dtype` is the compute type, as UNetBase's. No
hand-written kernel runs on this model's path.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from accunet_tpu_torch.nn.acc_blocks import BatchNorm
from accunet_tpu_torch.nn.kan import KAN
from accunet_tpu_torch.nn.unext_blocks import LayerNorm
from accunet_tpu_torch.ops.conv import conv2d, conv2d_strided, linear, patchify
from accunet_tpu_torch.ops.resize import resize_bilinear

BLOCK_UNITS = (3, 4, 9)  # R50's bottleneck units per ResNetV2 block
ROOT_WIDTH = 64  # ResNetV2's root width (width factor 1)
SKIPS = (512, 256, 64)  # the hybrid's three skips' channels, deepest first


class StdConv(nn.Conv2d):
    """A bias-free conv (padding k // 2) with its weight standardised at use."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(torch.promote_types(self.weight.dtype, torch.float32))
        m = w.mean(dim=(1, 2, 3), keepdim=True)
        v = (w - m).square().mean(dim=(1, 2, 3), keepdim=True)
        w = (w - m) * torch.rsqrt(v + 1e-5)
        return conv2d_strided(x, w, None, self.stride[0], self.padding[0])


class GroupNorm(nn.GroupNorm):
    """GroupNorm over the last axis of an NHWC tensor, in fp32 (or float64)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ct = torch.promote_types(x.dtype, torch.float32)
        y = F.group_norm(x.to(ct).permute(0, 3, 1, 2), self.num_groups, self.weight.to(ct),
                         self.bias.to(ct), self.eps)
        return y.permute(0, 2, 3, 1)


class PreActBottleneck(nn.Module):
    def __init__(self, cin: int, cout: int, cmid: int, stride: int = 1):
        super().__init__()
        if stride != 1 or cin != cout:
            self.downsample = StdConv(cin, cout, 1, stride)
            self.gn_proj = GroupNorm(cout, cout, eps=1e-5)
        else:
            self.downsample = None
        self.conv1 = StdConv(cin, cmid, 1)
        self.gn1 = GroupNorm(32, cmid, eps=1e-6)
        self.conv2 = StdConv(cmid, cmid, 3, stride)
        self.gn2 = GroupNorm(32, cmid, eps=1e-6)
        self.conv3 = StdConv(cmid, cout, 1)
        self.gn3 = GroupNorm(32, cout, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.gn_proj(self.downsample(x))
        y = F.relu(self.gn1(self.conv1(x)))
        y = F.relu(self.gn2(self.conv2(y)))
        return F.relu(residual + self.gn3(self.conv3(y)))


class ResNetV2(nn.Module):
    """x (B, S, S, 3) -> (features (B, S', S', 1024), the skips at S / 8,
    S / 4, S / 2 with 512, 256 and 64 channels)."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        w = ROOT_WIDTH
        self.root_conv = StdConv(in_channels, w, 7, 2)
        self.root_gn = GroupNorm(32, w, eps=1e-6)
        widths = [(w, w * 4, w), (w * 4, w * 8, w * 2), (w * 8, w * 16, w * 4)]
        for bi, ((cin, cout, cmid), units) in enumerate(zip(widths, BLOCK_UNITS)):
            for u in range(1, units + 1):
                setattr(self, f"block{bi + 1}_unit{u}", PreActBottleneck(
                    cin if u == 1 else cout, cout, cmid, 1 if bi == 0 or u > 1 else 2))

    def forward(self, x: torch.Tensor):
        in_size = x.shape[1]
        x = F.relu(self.root_gn(self.root_conv(x)))
        features = [x]
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)
        for bi, units in enumerate(BLOCK_UNITS):
            for u in range(1, units + 1):
                x = getattr(self, f"block{bi + 1}_unit{u}")(x)
            if bi < 2:
                pad = in_size // 4 // (bi + 1) - x.shape[1]
                features.append(F.pad(x, (0, 0, 0, pad, 0, pad)) if pad else x)
        return x, features[::-1]


def hybrid_grid(img_size: int) -> int:
    """The side of ResNetV2's output on an img_size input (7x7/2 pad 3, the
    3/2 pool, two 3x3/2 pad 1 convs)."""
    s = (img_size - 1) // 2 + 1
    s = (s - 3) // 2 + 1
    for _ in range(2):
        s = (s - 1) // 2 + 1
    return s


class ViTBlock(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_dim: int, mlp_type: str = "dense"):
        super().__init__()
        self.heads = heads
        self.attention_norm = LayerNorm(hidden, eps=1e-6)
        for name in ("attn_query", "attn_key", "attn_value", "attn_out"):
            setattr(self, name, nn.Linear(hidden, hidden))
        self.ffn_norm = LayerNorm(hidden, eps=1e-6)
        if mlp_type == "fkan":
            self.ffn_pre_norm = LayerNorm(hidden, eps=1e-6)
            self.ffn_kan = KAN((hidden, mlp_dim, hidden))
        else:
            self.ffn_fc1 = nn.Linear(hidden, mlp_dim)
            self.ffn_fc2 = nn.Linear(mlp_dim, hidden)
        self.mlp_type = mlp_type

    def _proj(self, name: str, t: torch.Tensor) -> torch.Tensor:
        m = getattr(self, name)
        return linear(t, m.weight, m.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        y = self.attention_norm(x)
        q, k, v = (self._proj(f"attn_{s}", y).unflatten(-1, (self.heads, -1)).transpose(1, 2)
                   for s in ("query", "key", "value"))
        att = torch.softmax(q @ k.transpose(2, 3) / math.sqrt(c // self.heads), dim=-1)
        x = self._proj("attn_out", (att @ v).transpose(1, 2).reshape(b, n, c)) + x
        y = self.ffn_norm(x)
        if self.mlp_type == "fkan":
            y = self.ffn_kan(self.ffn_pre_norm(y).reshape(b * n, c)).reshape(b, n, c)
        else:
            y = self._proj("ffn_fc2", F.gelu(self._proj("ffn_fc1", y)))
        return y + x


class Conv2dReLU(nn.ModuleDict):
    """3x3 bias-free conv -> BN -> ReLU (Sequential indices 0 and 1)."""

    def __init__(self, cin: int, cout: int):
        super().__init__({"0": nn.Conv2d(cin, cout, 3, padding=1, bias=False),
                          "1": BatchNorm(cout)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self["1"](conv2d(x, self["0"].weight)))


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, skip: int, cout: int):
        super().__init__()
        self.conv1 = Conv2dReLU(cin + skip, cout)
        self.conv2 = Conv2dReLU(cout, cout)

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None = None) -> torch.Tensor:
        x = resize_bilinear(x, (2 * x.shape[1], 2 * x.shape[2]), align_corners=True)
        if skip is not None:
            # JAX concatenates the fp32 skip beside a bf16 x and its conv
            # casts the result back: the same values as a bf16 skip
            x = torch.cat([x, skip.to(x.dtype)], dim=-1)
        return self.conv2(self.conv1(x))


class SegmentationHead(nn.Conv2d):
    """The 3x3 'SAME' head conv on NHWC, called as a module so that hooks
    (Seg-Grad-CAM's default layer) see it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias)


class TransUNet(nn.Module):
    """x (B, img_size, img_size, n_channels) -> float32 (B, img_size,
    img_size, n_classes); img_size divisible by 16."""

    def __init__(self, n_channels: int = 3, n_classes: int = 1, img_size: int = 224,
                 backbone: str = "R50-ViT-B_16", hidden: int = 768, num_layers: int = 12,
                 heads: int = 12, mlp_dim: int = 3072,
                 decoder_channels: Sequence[int] = (256, 128, 64, 16), mlp_type: str = "dense",
                 final_sigmoid: bool = True, dtype: torch.dtype | None = None):
        super().__init__()
        self.sigmoid = n_classes == 1 and final_sigmoid
        self.dtype = dtype
        cin = 3 if n_channels == 1 else n_channels
        self.hybrid = backbone.startswith("R50")
        if self.hybrid:
            self.hybrid_model = ResNetV2(in_channels=cin)
            self.patch_embeddings = nn.Conv2d(1024, hidden, 1)
            grid, skips = hybrid_grid(img_size), SKIPS
        else:
            self.patch_embeddings = nn.Conv2d(cin, hidden, 16, stride=16)
            grid, skips = img_size // 16, ()
        self.position_embeddings = nn.Parameter(torch.zeros(1, grid * grid, hidden))
        self.layer = nn.ModuleList(ViTBlock(hidden, heads, mlp_dim, mlp_type)
                                   for _ in range(num_layers))
        self.encoder_norm = LayerNorm(hidden, eps=1e-6)
        self.conv_more = Conv2dReLU(hidden, 512)
        ins = (512, *decoder_channels[:-1])
        self.blocks = nn.ModuleList(
            DecoderBlock(i, skips[k] if k < len(skips) else 0, o)
            for k, (i, o) in enumerate(zip(ins, decoder_channels)))
        self.segmentation_head = SegmentationHead(decoder_channels[-1], n_classes, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ct = self.segmentation_head.weight.dtype if self.dtype is None else self.dtype
        x = x.to(ct)
        if x.shape[-1] == 1:
            x = x.expand(*x.shape[:-1], 3)
        features = ()
        if self.hybrid:
            x, features = self.hybrid_model(x)
            x = x.to(ct)
        p = self.patch_embeddings
        x = patchify(x, p.weight, p.bias)
        b, h, w, c = x.shape
        tok = x.flatten(1, 2) + self.position_embeddings.to(x.dtype)
        for layer in self.layer:
            tok = layer(tok)
        y = self.conv_more(self.encoder_norm(tok).reshape(b, h, w, c))
        for k, block in enumerate(self.blocks):
            y = block(y, features[k] if k < len(features) else None)
        y = self.segmentation_head(y)
        return (torch.sigmoid(y) if self.sigmoid else y).float()
