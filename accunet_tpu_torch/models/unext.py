"""UNeXt, the tokenized-MLP UNet (torch.nn, NHWC): counterpart of
accunet_tpu/models/unext.py (`UNext`, `UNext_S`) and of the ported axes of
accunet_tpu/models/unext_cmrf.py (`UNextCMRF`, whose plain "conv" axes are
UNext: the same modules and parameter names; models/unext_cmrf.py holds its
variant table).

    stem: 3 x (3x3 conv | CMRF -> [BN, conv stem only] -> 2x2 max-pool ->
        ReLU), 16/32/128 channels (pool before ReLU)
    tokenized MLP: OverlapPatchEmbed (k3 s2) 128 -> 160 -> 256, one
        ShiftedBlock each, LayerNorm
    decoder: 3x3 conv (| CMRF at decoder3-5) -> BN -> 2x bilinear upsample
        (align_corners=False) -> ReLU -> + skip (resized with
        align_corners=True when ragged), ShiftedBlocks at 160 / 128
    head: 1x1 conv to n_classes, sigmoid when n_classes == 1
    -> float32 (B, H', W', n_classes): H' is 32 times the bottleneck's
       side, H itself when 32 divides H (48 -> 64)

Axes (the JAX names): `encoder` "conv" | "cmrf"; `decoder` "conv" | "cmrf"
(CMRF at decoder3-5, which then drop dbn3 / dbn4, accunet_tpu/models/
unext_cmrf.py:254-256); `skip` "add" | "mlfc" (the port's MLFC over t1..t4)
| "dense" (the UNet++-style H{i}__{j} heads refine t1..t3). Every ShiftMLP's
depthwise conv takes its weight gradient from the `dwconv2d_wgrad` kernel, so
a train step launches it once per ShiftedBlock (4); an eval forward runs no
hand-written kernel.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from accunet_tpu_torch.nn.acc_blocks import MLFC, BatchNorm
from accunet_tpu_torch.nn.cmrf_blocks import CMRF
from accunet_tpu_torch.nn.unext_blocks import OverlapPatchEmbed, ShiftedBlock
from accunet_tpu_torch.ops.conv import conv1x1, conv2d
from accunet_tpu_torch.ops.pooling import max_pool2d
from accunet_tpu_torch.ops.resize import resize_bilinear, upsample_bilinear_2x

_TODO = "not ported yet (ROADMAP Queue 1 item 7)"


def _conv3(c1: int, c2: int, bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(c1, c2, 3, padding=1, bias=bias)


def _apply(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A 3x3 conv (stride 1, SAME) or a CMRF on NHWC."""
    if isinstance(block, nn.Conv2d):
        return conv2d(x, block.weight, block.bias)
    return block(x)


def _match(t: torch.Tensor, ref: torch.Tensor, align_corners: bool) -> torch.Tensor:
    if t.shape[1:3] != ref.shape[1:3]:
        t = resize_bilinear(t, tuple(ref.shape[1:3]), align_corners)
    return t


class UNext(nn.Module):
    def __init__(self, n_channels: int = 3, n_classes: int = 1,
                 stem_dims: Sequence[int] = (16, 32, 128),
                 embed_dims: Sequence[int] = (128, 160, 256), final_sigmoid: bool = True,
                 encoder: str = "conv", decoder: str = "conv", skip: str = "add",
                 pool: str = "max", token_block: str = "shift"):
        super().__init__()
        for axis, value, ported in (("encoder", encoder, ("conv", "cmrf")),
                                    ("decoder", decoder, ("conv", "cmrf")),
                                    ("skip", skip, ("add", "mlfc", "dense")),
                                    ("pool", pool, ("max",)),
                                    ("token_block", token_block, ("shift",))):
            if value not in ported:
                raise NotImplementedError(f"UNext {axis}={value!r}: {_TODO}")
        s1, s2, s3 = stem_dims
        e0, e1, e2 = embed_dims
        self.n_classes, self.final_sigmoid = n_classes, final_sigmoid
        self.skip = skip
        enc = _conv3 if encoder == "conv" else CMRF
        self.encoder1 = enc(n_channels, s1)
        self.encoder2 = enc(s1, s2)
        self.encoder3 = enc(s2, s3)
        if encoder == "conv":  # the CMRF stems pool without a BN
            self.ebn1, self.ebn2, self.ebn3 = BatchNorm(s1), BatchNorm(s2), BatchNorm(s3)
        self.patch_embed3 = OverlapPatchEmbed(s3, e1)
        self.block1 = nn.ModuleList([ShiftedBlock(e1)])
        self.norm3 = nn.LayerNorm(e1, eps=1e-5)
        self.patch_embed4 = OverlapPatchEmbed(e1, e2)
        self.block2 = nn.ModuleList([ShiftedBlock(e2)])
        self.norm4 = nn.LayerNorm(e2, eps=1e-5)
        if skip == "dense":
            for name, cin, cout in (("H0_1", s1 + s2, s1), ("H1_1", s2 + s3, s2),
                                    ("H2_1", s3 + e1, s3), ("H0_2", 2 * s1 + s2, s1),
                                    ("H1_2", 2 * s2 + s3, s2), ("H0_3", 3 * s1 + s2, s1)):
                setattr(self, f"{name}_conv", _conv3(cin, cout, bias=False))
                setattr(self, f"{name}_bn", BatchNorm(cout))
        elif skip == "mlfc":
            self.mlfc = MLFC((s1, s2, s3, e1), 1, "full")
        self.decoder1 = _conv3(e2, e1)
        self.dbn1 = BatchNorm(e1)
        self.dblock1 = nn.ModuleList([ShiftedBlock(e1)])
        self.dnorm3 = nn.LayerNorm(e1, eps=1e-5)
        self.decoder2 = _conv3(e1, e0)
        self.dbn2 = BatchNorm(e0)
        self.dblock2 = nn.ModuleList([ShiftedBlock(e0)])
        self.dnorm4 = nn.LayerNorm(e0, eps=1e-5)
        dec = _conv3 if decoder == "conv" else CMRF
        self.decoder3 = dec(e0, s2)
        self.decoder4 = dec(s2, s1)
        self.decoder5 = dec(s1, s1)
        if decoder == "conv":  # the CMRF decoders drop dbn3 / dbn4
            self.dbn3, self.dbn4 = BatchNorm(s2), BatchNorm(s1)
        self.final = nn.Conv2d(s1, n_classes, 1)

    def _stem(self, x: torch.Tensor, i: int) -> torch.Tensor:
        y = _apply(getattr(self, f"encoder{i}"), x)
        if hasattr(self, f"ebn{i}"):
            y = getattr(self, f"ebn{i}")(y)
        return F.relu(max_pool2d(y, 2))

    def _up(self, y: torch.Tensor, i: int) -> torch.Tensor:
        y = _apply(getattr(self, f"decoder{i}"), y)
        if hasattr(self, f"dbn{i}"):
            y = getattr(self, f"dbn{i}")(y)
        return F.relu(upsample_bilinear_2x(y))

    def _head(self, name: str, *maps: torch.Tensor) -> torch.Tensor:
        """A dense-skip head (3x3 conv without bias, BN, ReLU; JAX
        `H{i}__{j}_conv` / `_bn`) over the concat of `maps`, the last resized
        to the first (align_corners=False)."""
        *same, coarse = maps
        x = torch.cat([*same, _match(coarse, same[0], False)], dim=-1)
        y = conv2d(x, getattr(self, f"{name}_conv").weight)
        return F.relu(getattr(self, f"{name}_bn")(y))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, n_channels) -> float32 (B, H', W', n_classes)."""
        x = x.to(self.final.weight.dtype)
        t1 = self._stem(x, 1)
        t2 = self._stem(t1, 2)
        t3 = self._stem(t2, 3)
        t4 = self.norm3(self.block1[0](self.patch_embed3(t3)))
        out = self.norm4(self.block2[0](self.patch_embed4(t4)))

        if self.skip == "dense":  # refined t1..t3; t4 stays
            x01 = self._head("H0_1", t1, t2)
            x11 = self._head("H1_1", t2, t3)
            x21 = self._head("H2_1", t3, t4)
            x02 = self._head("H0_2", t1, x01, x11)
            x12 = self._head("H1_2", t2, x11, x21)
            t1, t2, t3 = self._head("H0_3", t1, x01, x02, x12), x12, x21
        elif self.skip == "mlfc":
            t1, t2, t3, t4 = self.mlfc(t1, t2, t3, t4)

        out = self._up(out, 1)
        out = self.dnorm3(self.dblock1[0](out + _match(t4, out, True)))
        out = self._up(out, 2)
        out = self.dnorm4(self.dblock2[0](out + _match(t3, out, True)))
        out = self._up(out, 3)
        out = self._up(out + _match(t2, out, True), 4)
        out = self._up(out + _match(t1, out, True), 5)
        logits = conv1x1(out, self.final.weight, self.final.bias)
        if self.n_classes == 1 and self.final_sigmoid:
            logits = torch.sigmoid(logits)
        return logits.float()


def UNext_S(n_channels: int = 3, n_classes: int = 1, **kw) -> UNext:
    """The small variant: stem 8/16/32, token dims 32/64/128."""
    return UNext(n_channels, n_classes, stem_dims=(8, 16, 32), embed_dims=(32, 64, 128), **kw)
