"""SegMamba, the reference's baseline (nets/segmamba.py), in torch.nn on NHWC
tensors: counterpart of accunet_tpu/models/segmamba.py (`PlainMambaLayer`,
`MlpChannel`, `MambaEncoder`, `SegMamba`, `VARIANTS`, `build_segmamba`).

    encoder "vit": stem 7x7/2 conv, then per stage (IN + 2x2/2 conv from
        stage 1 on) -> depths[i] PlainMambaLayers (token LayerNorm + BiMamba
        + residual) -> IN + MlpChannel (1x1 conv, GELU, 1x1 conv)
    UNETR decoder: encoder1..5 UnetrBasicBlocks on the input and the four
        stage outputs, decoder5..2 UnetrUpBlocks, decoder1, UnetOutBlock
    -> float32 logits (B, H, W, out_chans)

Every BiMamba runs two selective scans (forward and time-flipped), so a
forward launches 2 * sum(depths) chunked linear-scan kernels, and a train
step as many reverse ones.

Only the baseline is ported: block="plain", use_gsc=False, no text fusion,
no final refine, no deep supervision. The other axes of the family (GSC,
the hybrid and Spatial-Mamba blocks, text fusion, FKAN refine, deep
supervision heads) raise NotImplementedError (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from accunet_tpu_torch.nn.ssm import BiMamba
from accunet_tpu_torch.nn.unetr import (
    UnetOutBlock,
    UnetrBasicBlock,
    UnetrUpBlock,
    instance_norm,
)
from accunet_tpu_torch.ops.conv import conv1x1

_TODO = "not ported yet (ROADMAP Queue 1 item 6)"


def _conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A strided, explicitly padded nn.Conv2d on an NHWC tensor."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class PlainMambaLayer(nn.Module):
    """Token LayerNorm + bimamba-v2 mixer + residual on (B, H, W, C)."""

    def __init__(self, dim: int, d_state: int = 16, d_conv: int = 4, expand: int = 2):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.mamba = BiMamba(dim, d_state, d_conv, expand)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        t = x.reshape(b, h * w, c)
        return (t + self.mamba(self.norm(t))).reshape(b, h, w, c)


class MlpChannel(nn.Module):
    """1x1 conv -> exact GELU -> 1x1 conv."""

    def __init__(self, hidden_size: int, mlp_dim: int):
        super().__init__()
        self.fc1 = nn.Conv2d(hidden_size, mlp_dim, 1)
        self.fc2 = nn.Conv2d(mlp_dim, hidden_size, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.gelu(conv1x1(x, self.fc1.weight, self.fc1.bias))
        return conv1x1(y, self.fc2.weight, self.fc2.bias)


class MambaEncoder(nn.Module):
    def __init__(self, in_chans: int = 1, depths: Sequence[int] = (2, 2, 2, 2),
                 dims: Sequence[int] = (48, 96, 192, 384), block: str = "plain",
                 block_kwargs: dict | None = None, use_gsc: bool = False,
                 stage_mlp: bool = True):
        super().__init__()
        if block != "plain" or block_kwargs:
            raise NotImplementedError(f"MambaEncoder block={block!r}: {_TODO}")
        if use_gsc:
            raise NotImplementedError(f"MambaEncoder use_gsc=True (GSC): {_TODO}")
        self.stem = nn.Conv2d(in_chans, dims[0], 7, stride=2, padding=3)
        self.downsample = nn.ModuleDict(
            {str(i): nn.Conv2d(dims[i - 1], dims[i], 2, stride=2) for i in range(1, 4)})
        self.stages = nn.ModuleList(
            nn.ModuleList(PlainMambaLayer(dims[i]) for _ in range(depths[i])) for i in range(4))
        self.mlps = (nn.ModuleList(MlpChannel(dims[i], 2 * dims[i]) for i in range(4))
                     if stage_mlp else None)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        outs = []
        for i in range(4):
            if i == 0:
                x = _conv_nhwc(self.stem, x)
            else:
                x = _conv_nhwc(self.downsample[str(i)], instance_norm(x))
            for layer in self.stages[i]:
                x = layer(x)
            if self.mlps is not None:
                x = self.mlps[i](instance_norm(x))
            outs.append(x)
        return tuple(outs)


class SegMamba(nn.Module):
    def __init__(self, in_chans: int = 1, out_chans: int = 1,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 feat_size: Sequence[int] = (48, 96, 192, 384), hidden_size: int = 768,
                 block: str = "plain", block_kwargs: dict | None = None,
                 use_gsc: bool = False, stage_mlp: bool = True,
                 text_fusion: str | None = None, text_fusion_hidden: bool | None = None,
                 deep_supervision: bool = False, final_refine: str | None = None,
                 ds_in_output: bool = False):
        super().__init__()
        if text_fusion is not None or text_fusion_hidden:
            raise NotImplementedError(f"SegMamba text_fusion={text_fusion!r}: {_TODO}")
        if deep_supervision or ds_in_output:
            raise NotImplementedError(f"SegMamba deep supervision: {_TODO}")
        if final_refine is not None:
            raise NotImplementedError(f"SegMamba final_refine={final_refine!r}: {_TODO}")
        f = list(feat_size)
        self.vit = MambaEncoder(in_chans, depths, f, block, block_kwargs, use_gsc, stage_mlp)
        self.encoder1 = UnetrBasicBlock(in_chans, f[0])
        self.encoder2 = UnetrBasicBlock(f[0], f[1])
        self.encoder3 = UnetrBasicBlock(f[1], f[2])
        self.encoder4 = UnetrBasicBlock(f[2], f[3])
        self.encoder5 = UnetrBasicBlock(f[3], hidden_size)
        self.decoder5 = UnetrUpBlock(hidden_size, f[3])
        self.decoder4 = UnetrUpBlock(f[3], f[2])
        self.decoder3 = UnetrUpBlock(f[2], f[1])
        self.decoder2 = UnetrUpBlock(f[1], f[0])
        self.decoder1 = UnetrBasicBlock(f[0], f[0])
        self.out = UnetOutBlock(f[0], out_chans)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, in_chans), H and W divisible by 16 -> float32 logits
        (B, H, W, out_chans)."""
        x = x.to(self.out.conv.weight.dtype)
        outs = self.vit(x)
        enc1 = self.encoder1(x)
        enc2 = self.encoder2(outs[0])
        enc3 = self.encoder3(outs[1])
        enc4 = self.encoder4(outs[2])
        enc_hidden = self.encoder5(outs[3])
        dec3 = self.decoder5(enc_hidden, enc4)
        dec2 = self.decoder4(dec3, enc3)
        dec1 = self.decoder3(dec2, enc2)
        dec0 = self.decoder2(dec1, enc1)
        return self.out(self.decoder1(dec0)).float()


_NO_EXTRAS = dict(text_fusion=None, deep_supervision=False, final_refine=None)

# registry name -> constructor kwargs (the JAX package's VARIANTS entry)
VARIANTS = {
    "Segmamba": dict(block="plain", use_gsc=False, stage_mlp=True, **_NO_EXTRAS),
}


def build_segmamba(name: str, in_chans: int = 1, out_chans: int = 1, **overrides) -> SegMamba:
    if name not in VARIANTS:
        raise NotImplementedError(f"SegMamba variant {name!r}: {_TODO}")
    kwargs = dict(VARIANTS[name])
    kwargs.update(overrides)
    return SegMamba(in_chans=in_chans, out_chans=out_chans, **kwargs)
