"""UNeXt with an InceptionNeXt (MetaNeXt) encoder and MLFC skip fusion
(torch.nn, NHWC): counterpart of accunet_tpu/models/unext_inceptionnext.py
(`InceptionDWConv2d`, `MetaNeXtBlock`, `MetaNeXtStage`,
`UNextInceptionNextMLFC`), with JAX's module names, so a converted JAX tree
loads strictly (`port/jax_params.state_dict_from_jax`).

    stem: 4x4 / 4 conv to 40 channels -> BN
    stages 1-3 (80 / 128 / 160 channels, band kernels 7 / 9 / 11): BN ->
        2x2 / 2 conv, then two MetaNeXtBlocks:
        x + gamma * fc2(gelu(fc1(BN(InceptionDWConv2d(x)))))
    InceptionDWConv2d: the channels split into an identity part and three
        depthwise branches of gc = int(dim * 0.25) channels each, a 3x3, a
        1xk band and a kx1 band, 'SAME'
    tokens: OverlapPatchEmbed (k3 s2) to 160, a ShiftedBlock, LayerNorm
        (t4); MLFC over (t1, t2, t3, t4) with (80, 128, 160, 160) channels;
        OverlapPatchEmbed to 256, a ShiftedBlock, LayerNorm
    decoder: 3x3 conv -> BN (not at decoder5) -> 2x bilinear upsample ->
        ReLU -> + skip (resized with align_corners=True when its map
        differs, through a learned 1x1 `match{k}` when its channels
        differ), ShiftedBlocks at 160 / 128
    head: bilinear resize to the input (align_corners=False), 1x1 conv to
        n_classes, sigmoid when n_classes == 1

As in JAX, the MLFC takes the stages' real channels and the channel match
is a learned conv (the reference builds MLFC(16, 32, 128, 160) and fresh
untrained convs inside its forward). The model builds at any side that 32
divides (its preset is 256); at 224 the MLFC's levels do not nest (7 -> 4)
and the forward raises a shape error, as JAX's does. `use_fkan` is kept for
the `_fKAN` registry name, and the forward never reads it, as JAX's never
does: both names build the same model (2,918,367 parameters).

The three depthwise branches are the library's grouped convs, as they are
XLA's convs in JAX. Each ShiftedBlock's depthwise conv takes its weight
gradient from the `dwconv2d_wgrad` kernel, so a train step launches it 4
times and an eval forward never. `dtype` is the compute type, as ACCUNet's;
the output is float32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from accunet_tpu_torch.nn.acc_blocks import MLFC, BatchNorm
from accunet_tpu_torch.nn.unext_blocks import LayerNorm, OverlapPatchEmbed, ShiftedBlock
from accunet_tpu_torch.ops.conv import conv1x1, conv2d, patchify
from accunet_tpu_torch.ops.resize import resize_bilinear, upsample_bilinear_2x


class InceptionDWConv2d(nn.Module):
    def __init__(self, dim: int, square_kernel: int = 3, band_kernel: int = 11,
                 branch_ratio: float = 0.125):
        super().__init__()
        gc = int(dim * branch_ratio)
        self.split = (dim - 3 * gc, gc, gc, gc)
        k, bk = square_kernel, band_kernel
        self.dwconv_hw = nn.Conv2d(gc, gc, k, padding=k // 2, groups=gc)
        self.dwconv_w = nn.Conv2d(gc, gc, (1, bk), padding=(0, bk // 2), groups=gc)
        self.dwconv_h = nn.Conv2d(gc, gc, (bk, 1), padding=(bk // 2, 0), groups=gc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_id, x_hw, x_w, x_h = x.split(self.split, dim=-1)
        gc = self.split[1]
        ys = [conv2d(t, c.weight, c.bias, groups=gc)
              for t, c in ((x_hw, self.dwconv_hw), (x_w, self.dwconv_w), (x_h, self.dwconv_h))]
        return torch.cat([x_id, *ys], dim=-1)


class MetaNeXtBlock(nn.Module):
    def __init__(self, dim: int, band_kernel: int = 11, branch_ratio: float = 0.25,
                 mlp_ratio: int = 4, ls_init: float = 1.0):
        super().__init__()
        self.token_mixer = InceptionDWConv2d(dim, 3, band_kernel, branch_ratio)
        self.norm = BatchNorm(dim)
        self.mlp_fc1 = nn.Conv2d(dim, dim * mlp_ratio, 1)
        self.mlp_fc2 = nn.Conv2d(dim * mlp_ratio, dim, 1)
        # the layer scale, ls_init at construction (init_parameters keeps it)
        self.gamma = nn.Parameter(torch.full((dim,), ls_init)) if ls_init else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(self.token_mixer(x))
        y = F.gelu(conv1x1(y, self.mlp_fc1.weight, self.mlp_fc1.bias))
        y = conv1x1(y, self.mlp_fc2.weight, self.mlp_fc2.bias)
        if self.gamma is not None:
            y = y * self.gamma.to(y.dtype)
        return y + x


class MetaNeXtStage(nn.Module):
    def __init__(self, in_chs: int, out_chs: int, depth: int = 2, band_kernel: int = 11,
                 branch_ratio: float = 0.25, ds_stride: int = 2):
        super().__init__()
        self.downsample = (nn.ModuleList([BatchNorm(in_chs),
                                          nn.Conv2d(in_chs, out_chs, ds_stride, ds_stride)])
                           if ds_stride > 1 else None)
        self.blocks = nn.ModuleList(MetaNeXtBlock(out_chs, band_kernel, branch_ratio)
                                    for _ in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample is not None:
            bn, conv = self.downsample
            x = patchify(bn(x), conv.weight, conv.bias)
        for blk in self.blocks:
            x = blk(x)
        return x


class UNextInceptionNextMLFC(nn.Module):
    def __init__(self, n_channels: int = 3, n_classes: int = 1,
                 embed_dims: Sequence[int] = (128, 160, 256), use_fkan: bool = False,
                 final_sigmoid: bool = True, dtype: torch.dtype | None = None):
        super().__init__()
        e0, e1, e2 = embed_dims
        self.n_classes, self.final_sigmoid, self.dtype = n_classes, final_sigmoid, dtype
        self.use_fkan = use_fkan  # never read by the forward, as in JAX
        self.stem = nn.ModuleList([nn.Conv2d(n_channels, 40, 4, 4), BatchNorm(40)])
        self.stage1 = MetaNeXtStage(40, 80, 2, 7)
        self.stage2 = MetaNeXtStage(80, 128, 2, 9)
        self.stage3 = MetaNeXtStage(128, 160, 2, 11)
        self.patch_embed3 = OverlapPatchEmbed(160, e1, 3, 2)
        self.block1 = nn.ModuleList([ShiftedBlock(e1)])
        self.norm3 = LayerNorm(e1, eps=1e-5)
        self.skip_fusion = MLFC((80, 128, 160, 160), 1, "full")
        self.patch_embed4 = OverlapPatchEmbed(e1, e2, 3, 2)
        self.block2 = nn.ModuleList([ShiftedBlock(e2)])
        self.norm4 = LayerNorm(e2, eps=1e-5)
        # decoder k: (in, out, with BN); the skips it meets (t4, t3, t2, t1)
        dec = ((e2, e1, True), (e1, e0, True), (e0, 32, True), (32, 16, True), (16, 16, False))
        for k, (cin, cout, bn) in enumerate(dec, start=1):
            setattr(self, f"decoder{k}", nn.Conv2d(cin, cout, 3, padding=1))
            if bn:
                setattr(self, f"dbn{k}", BatchNorm(cout))
        for k, (skip, cout) in zip((4, 3, 2, 1), ((e1, e1), (160, e0), (128, 32), (80, 16))):
            if skip != cout:
                setattr(self, f"match{k}", nn.Conv2d(skip, cout, 1))
        self.dblock1 = nn.ModuleList([ShiftedBlock(e1)])
        self.dnorm3 = LayerNorm(e1, eps=1e-5)
        self.dblock2 = nn.ModuleList([ShiftedBlock(e0)])
        self.dnorm4 = LayerNorm(e0, eps=1e-5)
        self.final = nn.Conv2d(16, n_classes, 1)

    def _up(self, y: torch.Tensor, k: int) -> torch.Tensor:
        conv = getattr(self, f"decoder{k}")
        y = conv2d(y, conv.weight, conv.bias)
        if hasattr(self, f"dbn{k}"):
            y = getattr(self, f"dbn{k}")(y)
        return F.relu(upsample_bilinear_2x(y))

    def _add_skip(self, y: torch.Tensor, t: torch.Tensor, k: int) -> torch.Tensor:
        if t.shape[1:3] != y.shape[1:3]:
            t = resize_bilinear(t, tuple(y.shape[1:3]), align_corners=True)
        if t.shape[-1] != y.shape[-1]:
            m = getattr(self, f"match{k}")
            t = conv1x1(t, m.weight, m.bias)
        return y + t

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, n_channels) -> float32 (B, H, W, n_classes)."""
        hw = tuple(x.shape[1:3])
        x = x.to(self.final.weight.dtype if self.dtype is None else self.dtype)
        conv, bn = self.stem
        x = bn(patchify(x, conv.weight, conv.bias))
        t1 = self.stage1(x)
        t2 = self.stage2(t1)
        t3 = self.stage3(t2)
        t4 = self.norm3(self.block1[0](self.patch_embed3(t3)))
        t1, t2, t3, t4 = self.skip_fusion(t1, t2, t3, t4)
        out = self.norm4(self.block2[0](self.patch_embed4(t4)))

        out = self._add_skip(self._up(out, 1), t4, 4)
        out = self.dnorm3(self.dblock1[0](out))
        out = self._add_skip(self._up(out, 2), t3, 3)
        out = self.dnorm4(self.dblock2[0](out))
        out = self._add_skip(self._up(out, 3), t2, 2)
        out = self._add_skip(self._up(out, 4), t1, 1)
        out = resize_bilinear(self._up(out, 5), hw, align_corners=False)
        logits = conv1x1(out, self.final.weight, self.final.bias)
        if self.n_classes == 1 and self.final_sigmoid:
            logits = torch.sigmoid(logits)
        return logits.float()
