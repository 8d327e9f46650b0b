"""The SegMamba family in torch.nn on NHWC tensors: counterpart of
accunet_tpu/models/segmamba.py (`GSC`, `PlainMambaLayer`, `MlpChannel`,
`MambaEncoder`, `SegMamba`, `VARIANTS`, `build_segmamba`).

    encoder "vit": stem 7x7/2 conv, then per stage (IN + 2x2/2 conv from
        stage 1 on) -> [GSC] -> depths[i] blocks: PlainMambaLayers (token
        LayerNorm + BiMamba + residual; the baseline) or SpatialMambaBlocks
        (block "spatial", or "spatial_kan" with the KAN FFN) -> [IN +
        MlpChannel (1x1 conv, GELU, 1x1 conv)]
    UNETR decoder: encoder1..5 UnetrBasicBlocks on the input and the four
        stage outputs, decoder5..2 UnetrUpBlocks, decoder1, [the FKAN final
        refine over its tokens], UnetOutBlock
    -> float32 logits (B, H, W, out_chans), or with deep supervision and
       ds_in_output the tuple (main, ds1, ds2, ds3) of the main head and the
       1x1 heads on decoder3, 4 and 5, resized bilinearly (align_corners
       False) to the main head's size

Every BiMamba runs two selective scans (forward and time-flipped) and every
SpatialMambaBlock one return-hidden scan, each one fused kernel forward and
one backward.

The defaults are the baseline's (block "plain", no GSC, stage MLPs, no
text fusion, refine or deep supervision); JAX's are the flagship's, so each
VARIANTS entry here spells out every axis. Not ported yet, and raising
NotImplementedError (ROADMAP Queue 1 item 6): text fusion, the hybrid
TransformerMambaBlock (block "tmb") and the SimpleTokenMLP final refine.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from accunet_tpu_torch.nn.kan import FKANMLP
from accunet_tpu_torch.nn.ssm import BiMamba, SpatialMambaBlock
from accunet_tpu_torch.nn.unetr import (
    UnetOutBlock,
    UnetrBasicBlock,
    UnetrUpBlock,
    instance_norm,
)
from accunet_tpu_torch.ops.conv import conv1x1, conv2d
from accunet_tpu_torch.ops.resize import resize_bilinear

_TODO = "not ported yet (ROADMAP Queue 1 item 6)"


def _conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A strided, explicitly padded nn.Conv2d on an NHWC tensor."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class GSC(nn.Module):
    """Gated spatial conv block: x1 = relu(IN(proj2(relu(IN(proj(x)))))),
    x2 = relu(IN(proj3(x))), out = relu(IN(proj4(x1 + x2))) + x; proj and
    proj2 3x3, proj3 and proj4 1x1, all with bias."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.proj = nn.Conv2d(c, c, 3)
        self.proj2 = nn.Conv2d(c, c, 3)
        self.proj3 = nn.Conv2d(c, c, 1)
        self.proj4 = nn.Conv2d(c, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def block(conv, y):
            return F.relu(instance_norm(conv2d(y, conv.weight, conv.bias)))

        x1 = block(self.proj2, block(self.proj, x))
        x2 = block(self.proj3, x)
        return block(self.proj4, x1 + x2) + x


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
        blocks = {"plain": PlainMambaLayer, "spatial": SpatialMambaBlock,
                  "spatial_kan": lambda c: SpatialMambaBlock(c, mlp_type="kan")}
        if block not in blocks or block_kwargs:
            raise NotImplementedError(f"MambaEncoder block={block!r}: {_TODO}")
        self.stem = nn.Conv2d(in_chans, dims[0], 7, stride=2, padding=3)
        self.downsample = nn.ModuleDict(
            {str(i): nn.Conv2d(dims[i - 1], dims[i], 2, stride=2) for i in range(1, 4)})
        self.gscs = nn.ModuleList(GSC(dims[i]) for i in range(4)) if use_gsc else None
        self.stages = nn.ModuleList(
            nn.ModuleList(blocks[block](dims[i]) for _ in range(depths[i])) for i in range(4))
        self.mlps = (nn.ModuleList(MlpChannel(dims[i], 2 * dims[i]) for i in range(4))
                     if stage_mlp else None)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        outs = []
        for i in range(4):
            if i == 0:
                x = _conv_nhwc(self.stem, x)
            else:
                x = _conv_nhwc(self.downsample[str(i)], instance_norm(x))
            if self.gscs is not None:
                x = self.gscs[i](x)
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
        if final_refine not in (None, "fkan"):
            raise NotImplementedError(f"SegMamba final_refine={final_refine!r}: {_TODO}")
        f = list(feat_size)
        self.ds_in_output = deep_supervision and ds_in_output
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
        self.final_refine_kan_mlp = FKANMLP(f[0], 4 * f[0]) if final_refine else None
        self.out = UnetOutBlock(f[0], out_chans)
        if deep_supervision:  # the heads exist even where only the main head is returned
            self.ds_head3 = UnetOutBlock(f[3], out_chans)
            self.ds_head2 = UnetOutBlock(f[2], out_chans)
            self.ds_head1 = UnetOutBlock(f[1], out_chans)

    def forward(self, x: torch.Tensor):
        """x (B, H, W, in_chans), H and W divisible by 16 -> float32 logits
        (B, H, W, out_chans), or the tuple (main, ds1, ds2, ds3) of such."""
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
        out = self.decoder1(dec0)
        if self.final_refine_kan_mlp is not None:
            b, h, w, c = out.shape
            out = self.final_refine_kan_mlp(out.reshape(b, h * w, c)).reshape(b, h, w, c)
        out_main = self.out(out)
        if not self.ds_in_output:
            return out_main.float()
        target = tuple(out_main.shape[1:3])
        heads = [resize_bilinear(head(dec), target).float()
                 for head, dec in ((self.ds_head1, dec1), (self.ds_head2, dec2),
                                   (self.ds_head3, dec3))]
        return (out_main.float(), *heads)


_NO_EXTRAS = dict(text_fusion=None, deep_supervision=False, final_refine=None)

# registry name -> constructor kwargs: the model of the JAX package's VARIANTS
# entry, with every axis spelt out (the defaults here are the baseline's, JAX's
# the flagship's)
VARIANTS = {
    "Segmamba": dict(block="plain", use_gsc=False, stage_mlp=True, **_NO_EXTRAS),
    "Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn_HSLCA_SpatialMamba_no_text": dict(
        block="spatial", use_gsc=True, stage_mlp=False, text_fusion=None,
        deep_supervision=True, final_refine="fkan", ds_in_output=True),
}


def build_segmamba(name: str, in_chans: int = 1, out_chans: int = 1, **overrides) -> SegMamba:
    if name not in VARIANTS:
        raise NotImplementedError(f"SegMamba variant {name!r}: {_TODO}")
    kwargs = dict(VARIANTS[name])
    kwargs.update(overrides)
    return SegMamba(in_chans=in_chans, out_chans=out_chans, **kwargs)
