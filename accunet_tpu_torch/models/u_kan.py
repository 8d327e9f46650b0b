"""U-KAN, the UNet with a tokenized KAN bottleneck (torch.nn, NHWC):
counterpart of accunet_tpu/models/u_kan.py (`DWBnRelu`, `KANLayer`,
`KANBlock`, `ConvLayer`, `UKAN`).

    stem: 3 x ConvLayer ((3x3 conv, BN, ReLU) x 2) -> 2x2 max-pool -> ReLU,
        e0/8, e0/4, e0 channels (t1, t2, t3)
    tokens: OverlapPatchEmbed (k3 s2) to e1, one KANBlock, LayerNorm (t4);
        OverlapPatchEmbed to e2, one KANBlock, LayerNorm
    decoder: ConvLayer (its first conv at the input width) -> 2x bilinear
        upsample -> ReLU -> + skip, KANBlocks at e1 and e0 after the first
        two, down to e0/8 channels at the input's size
    head: 1x1 conv to n_classes, sigmoid when n_classes == 1 (probabilities;
        the loss applies its own sigmoid to them, as in JAX and the
        reference)
    KANBlock: x + KANLayer(LayerNorm(x)); KANLayer: three SiLU KANLinears
        fc1-fc3 over the tokens, each followed by DWBnRelu (a 3x3 depthwise
        conv with bias, BN, ReLU)

Each DWBnRelu's depthwise conv takes its weight and bias gradient from the
`dwconv2d_wgrad` kernel (ops/conv.py:depthwise_conv2d), so a train step
launches it three times per KANBlock (12); an eval forward runs no
hand-written kernel. BN is flax's (momentum 0.9, eps 1e-5, the biased batch
variance into `running_var`). Module names follow the JAX tree
(`state_dict_from_jax`: `conv_0` -> `conv.0`, `dwconv__1` -> `dwconv_1`,
`block1_0` -> `block1.0`). `dtype` is the compute type, as UNext's.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from accunet_tpu_torch.nn.acc_blocks import BatchNorm
from accunet_tpu_torch.nn.kan import KANLinear
from accunet_tpu_torch.nn.unext_blocks import LayerNorm, OverlapPatchEmbed
from accunet_tpu_torch.ops.conv import conv1x1, conv2d, depthwise_conv2d
from accunet_tpu_torch.ops.pooling import max_pool2d
from accunet_tpu_torch.ops.resize import upsample_bilinear_2x


class DWBnRelu(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)
        self.bn = BatchNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(depthwise_conv2d(x, self.dwconv.weight, self.dwconv.bias)))


class KANLayer(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        for i in (1, 2, 3):
            setattr(self, f"fc{i}", KANLinear(dim, dim, base_activation="silu"))
            setattr(self, f"dwconv_{i}", DWBnRelu(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        for i in (1, 2, 3):
            x = getattr(self, f"fc{i}")(x.reshape(b * h * w, c)).reshape(b, h, w, c)
            x = getattr(self, f"dwconv_{i}")(x)
        return x


class KANBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.layer = KANLayer(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.layer(self.norm2(x))


class ConvLayer(nn.Module):
    """(3x3 conv, BN, ReLU) x 2; the first conv goes to `pre_ch` (the
    reference's D_ConvLayer keeps its input width there), the second to
    `out_ch`. Sequential indices: conv.0, BN conv.1, conv.3, BN conv.4."""

    def __init__(self, in_ch: int, out_ch: int, pre_ch: int | None = None):
        super().__init__()
        mid = pre_ch or out_ch
        self.conv = nn.ModuleDict({"0": nn.Conv2d(in_ch, mid, 3, padding=1), "1": BatchNorm(mid),
                                   "3": nn.Conv2d(mid, out_ch, 3, padding=1),
                                   "4": BatchNorm(out_ch)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        x = F.relu(c["1"](conv2d(x, c["0"].weight, c["0"].bias)))
        return F.relu(c["4"](conv2d(x, c["3"].weight, c["3"].bias)))


class UKAN(nn.Module):
    """x (B, H, W, n_channels), H and W divisible by 32 -> float32
    (B, H, W, n_classes): probabilities for one class with final_sigmoid,
    else logits."""

    def __init__(self, n_channels: int = 3, n_classes: int = 1,
                 embed_dims: Sequence[int] = (256, 320, 512), final_sigmoid: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        e0, e1, e2 = embed_dims
        self.sigmoid = n_classes == 1 and final_sigmoid
        self.dtype = dtype
        self.encoder1 = ConvLayer(n_channels, e0 // 8)
        self.encoder2 = ConvLayer(e0 // 8, e0 // 4)
        self.encoder3 = ConvLayer(e0 // 4, e0)
        self.patch_embed3 = OverlapPatchEmbed(e0, e1)
        self.block1 = nn.ModuleList([KANBlock(e1)])
        self.norm3 = LayerNorm(e1, eps=1e-5)
        self.patch_embed4 = OverlapPatchEmbed(e1, e2)
        self.block2 = nn.ModuleList([KANBlock(e2)])
        self.norm4 = LayerNorm(e2, eps=1e-5)
        self.decoder1 = ConvLayer(e2, e1, e2)
        self.dblock1 = nn.ModuleList([KANBlock(e1)])
        self.dnorm3 = LayerNorm(e1, eps=1e-5)
        self.decoder2 = ConvLayer(e1, e0, e1)
        self.dblock2 = nn.ModuleList([KANBlock(e0)])
        self.dnorm4 = LayerNorm(e0, eps=1e-5)
        self.decoder3 = ConvLayer(e0, e0 // 4, e0)
        self.decoder4 = ConvLayer(e0 // 4, e0 // 8, e0 // 4)
        self.decoder5 = ConvLayer(e0 // 8, e0 // 8, e0 // 8)
        self.final = nn.Conv2d(e0 // 8, n_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.final.weight.dtype if self.dtype is None else self.dtype)
        t1 = F.relu(max_pool2d(self.encoder1(x), 2))
        t2 = F.relu(max_pool2d(self.encoder2(t1), 2))
        t3 = F.relu(max_pool2d(self.encoder3(t2), 2))
        t4 = self.norm3(self.block1[0](self.patch_embed3(t3)))
        out = self.norm4(self.block2[0](self.patch_embed4(t4)))

        def up(y, i):
            return F.relu(upsample_bilinear_2x(getattr(self, f"decoder{i}")(y)))

        out = self.dnorm3(self.dblock1[0](up(out, 1) + t4))
        out = self.dnorm4(self.dblock2[0](up(out, 2) + t3))
        out = up(up(up(out, 3) + t2, 4) + t1, 5)
        y = conv1x1(out, self.final.weight, self.final.bias)
        return (torch.sigmoid(y) if self.sigmoid else y).float()
