"""KNUnet / KMUNet (torch.nn, NHWC): counterpart of accunet_tpu/models/knunet.py.

    encoder: KAN_PatchEmbed (the 16 offsets x[:, i::4, j::4] concatenated,
        j outer, i inner; LayerNorm(16C); a SiLU KANLinear to hidden[0]),
        then four CnnDownBlocks: (3x3 conv, LeakyReLU(0.01), Dropout) x depth,
        and but for the last stage a KAN PatchMerging2D (offsets (0,0),
        (1,0), (0,1), (1,1); LayerNorm(4C); KANLinear 4C -> 2C); the
        pre-merge maps are the skips
    bridge (KAN_SCA): a shared dilated 7x7 conv gate on [mean, max] of each
        skip, then a channel gate from a Conv1d(k=3) across the stacked
        channel means and one SiLU KANLinear per skip, with the reference's
        double residual
    decoder: up1-up3 (VSSLayerUp: KAN PatchExpand2D, KANLinear C -> 2C, a
        2x pixel shuffle and LayerNorm; conv1x1 of cat(skip, up); a VSSBlock,
        LayerNorm then SS2D plus the residual), Final_PatchExpand2D (a Linear
        without bias to 4C, a 4x pixel shuffle, LayerNorm) and a 1x1 head
    -> float32 (B, H, W, n_classes) logits

The reference's VSSLayerUp runs every block on the same conv1x1(cat(skip,
up)) and keeps the last block's output only, so the earlier blocks change
nothing the model returns: this port runs the last block alone. The earlier
blocks keep their parameters, so a reference or JAX tree loads strictly; they
get no gradient (None), which under Adam leaves them as JAX's zero gradient
does. Every SS2D runs the fused selective-scan kernel, one launch per
direction forward and one backward (nn/ss2d.py). Module and parameter names
follow the JAX tree (`state_dict_from_jax`). `dtype` is the compute type, as
UNext's: None computes in the parameters' type, torch.bfloat16 in bf16 with
the fp32 parameters cast at use; the output is float32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from accunet_tpu_torch.nn.kan import KANLinear
from accunet_tpu_torch.nn.ss2d import SS2D
from accunet_tpu_torch.nn.unext_blocks import LayerNorm
from accunet_tpu_torch.ops.conv import conv1x1, conv2d, linear


def pixel_shuffle_nhwc(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, H, W, p*p*c) -> (B, p*H, p*W, c): einops
    'b h w (p1 p2 c) -> b (h p1) (w p2) c'."""
    b, h, w, cc = x.shape
    c = cc // (p * p)
    return x.reshape(b, h, w, p, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h * p, w * p, c)


class KANTokens(nn.Module):
    """PatchbedLayer / PatchmergingLayer / PatchexpandLayer inside their
    block: one SiLU KANLinear over the tokens of a map, keyed
    `<name>.layer.fc1` as in the reference."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.layer = nn.ModuleDict({"fc1": KANLinear(in_features, out_features,
                                                     base_activation="silu")})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        return self.layer["fc1"](x.reshape(b * h * w, c)).reshape(b, h, w, -1)


class KANPatchEmbed(nn.Module):
    def __init__(self, in_chans: int, out_dim: int):
        super().__init__()
        self.norm = LayerNorm(16 * in_chans, eps=1e-5)
        self.reduction = KANTokens(16 * in_chans, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([x[:, i::4, j::4] for j in range(4) for i in range(4)], dim=-1)
        return self.reduction(self.norm(y))


class KANPatchMerging2D(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=1e-5)
        self.reduction = KANTokens(4 * dim, 2 * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return self.reduction(self.norm(y))


class KANPatchExpand2D(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.expand = KANTokens(dim, 2 * dim)
        self.norm = LayerNorm(dim // 2, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(pixel_shuffle_nhwc(self.expand(x), 2))


class FinalPatchExpand2D(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.expand = nn.Linear(dim, 4 * dim, bias=False)
        self.norm = LayerNorm(dim // 4, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(pixel_shuffle_nhwc(linear(x, self.expand.weight), 4))


class VSSBlock(nn.Module):
    """LayerNorm (eps 1e-5, the decoder's norm_layer) -> SS2D, plus x."""

    def __init__(self, hidden_dim: int, d_state: int = 16):
        super().__init__()
        self.ln_1 = LayerNorm(hidden_dim, eps=1e-5)
        self.self_attention = SS2D(hidden_dim, d_state)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.self_attention(self.ln_1(x))


class VSSLayerUp(nn.Module):
    """forward(x1, x2): x1 upsampled, then the last block on conv1x1(cat(x2,
    x1)) (the module docstring says why only the last)."""

    def __init__(self, dim: int, depth: int, d_state: int = 16):
        super().__init__()
        self.upsample = KANPatchExpand2D(dim)
        self.conv1x1 = nn.Conv2d(dim, dim // 2, 1)
        self.blocks = nn.ModuleList(VSSBlock(dim // 2, d_state) for _ in range(depth))

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        y = conv1x1(torch.cat([x2, self.upsample(x1)], dim=-1), self.conv1x1.weight,
                    self.conv1x1.bias)
        return self.blocks[-1](y)


class DownConvBlock(nn.Module):
    """(3x3 conv, LeakyReLU(0.01), Dropout) x depth; the conv is Sequential
    index 0 (`blocks.j.0`)."""

    def __init__(self, channels: int, depth: int, dropout_p: float = 0.0):
        super().__init__()
        self.dropout_p = dropout_p
        self.blocks = nn.ModuleList(
            nn.ModuleList([nn.Conv2d(channels, channels, 3, padding=1)]) for _ in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for (conv,) in self.blocks:
            x = F.leaky_relu(conv2d(x, conv.weight, conv.bias), 0.01)
            x = F.dropout(x, self.dropout_p, self.training)
        return x


class CnnDownBlock(nn.Module):
    """DownConvBlock, then (but on the last stage) a KAN PatchMerging2D;
    returns (the merged map, the pre-merge skip)."""

    def __init__(self, channels: int, depth: int, dropout_p: float, downsample: bool):
        super().__init__()
        self.DownConvBlock = DownConvBlock(channels, depth, dropout_p)
        self.down = KANPatchMerging2D(channels) if downsample else None

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        skip = self.DownConvBlock(x)
        return (skip if self.down is None else self.down(skip)), skip


class KMUNetEncoder(nn.Module):
    def __init__(self, n_channels: int, hidden_dims: Sequence[int], depths: Sequence[int],
                 drop_rate: Sequence[float]):
        super().__init__()
        self.KAN_PatchEmbed = KANPatchEmbed(n_channels, hidden_dims[0])
        last = len(depths) - 1
        self.layers = nn.ModuleList(
            CnnDownBlock(hidden_dims[i], depth, drop_rate[i + 1], downsample=i != last)
            for i, depth in enumerate(depths))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x, feats = self.KAN_PatchEmbed(x), []
        for layer in self.layers:
            x, skip = layer(x)
            feats.append(skip)
        return feats


class SpatialAttBridge(nn.Module):
    """sigmoid(shared conv 2 -> 1, 7x7, dilation 3, padding 9) of each map's
    channel mean and max."""

    def __init__(self):
        super().__init__()
        self.shared_conv2d = nn.ModuleList([nn.Conv2d(2, 1, 7, padding=9, dilation=3)])

    def forward(self, ts: list[torch.Tensor]) -> list[torch.Tensor]:
        conv = self.shared_conv2d[0]
        outs = []
        for t in ts:
            y = torch.cat([t.mean(dim=-1, keepdim=True), t.amax(dim=-1, keepdim=True)], dim=-1)
            y = F.conv2d(y.permute(0, 3, 1, 2), conv.weight.to(y.dtype), conv.bias.to(y.dtype),
                         padding=9, dilation=3)
            outs.append(torch.sigmoid(y.permute(0, 2, 3, 1)))
        return outs


class ChannelAttBridge(nn.Module):
    """The maps' channel means stacked (B, sum C), a Conv1d(1, 1, 3) without
    bias across them, then one SiLU KANLinear (sum C -> C_i) and a sigmoid
    per map: gates (B, 1, 1, C_i)."""

    def __init__(self, c_list: Sequence[int]):
        super().__init__()
        self.n = len(c_list)
        self.get_all_att = nn.Conv1d(1, 1, 3, padding=1, bias=False)
        for i, c in enumerate(c_list):
            setattr(self, f"att{i + 1}", KANLinear(sum(c_list), c, base_activation="silu"))

    def forward(self, ts: list[torch.Tensor]) -> list[torch.Tensor]:
        att = torch.cat([t.mean(dim=(1, 2)) for t in ts], dim=-1)
        att = F.conv1d(att[:, None], self.get_all_att.weight.to(att.dtype), padding=1)[:, 0]
        return [torch.sigmoid(getattr(self, f"att{i + 1}")(att))[:, None, None, :]
                for i in range(self.n)]


class KANSCABridge(nn.Module):
    def __init__(self, c_list: Sequence[int]):
        super().__init__()
        self.satt = SpatialAttBridge()
        self.catt = ChannelAttBridge(c_list)

    def forward(self, ts: list[torch.Tensor]) -> list[torch.Tensor]:
        gated = [s * t for s, t in zip(self.satt(ts), ts)]
        summed = [g + t for g, t in zip(gated, ts)]
        return [c * s + g for c, s, g in zip(self.catt(summed), summed, gated)]


class KMUNetDecoder(nn.Module):
    """up1-up3 from the deepest skip up (the reference's unused `vssblock` is
    not built), Final_PatchExpand2D and the 1x1 head."""

    def __init__(self, n_classes: int, hidden_dims: Sequence[int], depths: Sequence[int],
                 d_state: int = 16):
        super().__init__()
        for k, i in enumerate((3, 2, 1)):
            setattr(self, f"up{k + 1}", VSSLayerUp(hidden_dims[i], depths[i], d_state))
        self.final_up = FinalPatchExpand2D(hidden_dims[0])
        self.final_conv = nn.Conv2d(hidden_dims[0] // 4, n_classes, 1)

    def forward(self, feats: list[torch.Tensor]) -> torch.Tensor:
        x = feats[3]
        for k, i in enumerate((3, 2, 1)):
            x = getattr(self, f"up{k + 1}")(x, feats[i - 1])
        x = self.final_up(x)
        return conv1x1(x, self.final_conv.weight, self.final_conv.bias)


class KMUNet(nn.Module):
    """x (B, H, W, n_channels), H and W divisible by 32 -> float32 logits
    (B, H, W, n_classes). Each hidden width is twice the one before, as the
    merges and expands assume."""

    def __init__(self, n_channels: int = 3, n_classes: int = 2,
                 depths: Sequence[int] = (1, 2, 6, 2),
                 hidden_dims: Sequence[int] = (64, 128, 256, 512), d_state: int = 16,
                 bridge: bool = True, drop_rate: Sequence[float] = (0.1, 0.2, 0.3, 0.4, 0.5),
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.encoder = KMUNetEncoder(n_channels, hidden_dims, depths, drop_rate)
        self.KAN_SCA = KANSCABridge(hidden_dims) if bridge else None
        self.decoder = KMUNetDecoder(n_classes, hidden_dims, depths, d_state)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.decoder.final_conv.weight.dtype if self.dtype is None else self.dtype)
        feats = self.encoder(x)
        if self.KAN_SCA is not None:
            feats = self.KAN_SCA(feats)
        return self.decoder(feats).float()
