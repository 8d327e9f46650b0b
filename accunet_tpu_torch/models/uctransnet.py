"""UCTransNet, a UNet whose skips pass a channel-wise transformer (torch.nn,
NHWC): counterpart of accunet_tpu/models/uctransnet.py.

    encoder: UNet's inc and down1-down4 (c, 2c, 4c, 8c, 8c)
    ChannelTransformer over the four skips: each patchified (patch 16 / 8 /
        4 / 2, stride = patch, so all give (img_size // 16)^2 tokens) plus a
        zero-initialised position embedding; num_layers BlockViTs; a final
        LayerNorm per level; Reconstruct (nearest upsample by the patch,
        1x1 conv, BN, ReLU) added to the skip
    BlockViT: per level pre-LN channel attention over all levels' tokens,
        then a per-level pre-LN GELU MLP (4x), both residual; LayerNorms eps
        1e-6
    AttentionOrg: per head, Q_i = query{i}_h(level i) (C_i x n) against K,
        V = key_h, value_h of the concatenated KV = sum(C_i) channels;
        scores Q_i K / sqrt(KV) pass an instance norm per head over
        (C_i, KV) (eps 1e-5, no affine) and a softmax over KV; the context
        is averaged over heads, then out{i}. Matmuls and an explicit
        softmax, no library attention kernel
    decoder: UpBlockAttention (nearest 2x upsample; CCA gate on the skip,
        relu(skip * sigmoid((mlp_x(avg skip) + mlp_g(avg up)) / 2)); concat
        [gated skip, up]; two ConvBatchNorms) up4-up1
    head: 1x1 conv, 1 or n_classes + 1 channels, sigmoid for one

`img_size` sizes the position embeddings and defaults to 224, as in JAX,
whose train CLI does not pass it (`get_config` trains UCTransNet at 256, where
both fail: train it with --img-size 224). Names follow the JAX tree
(`embeddings__1` is `embeddings_1`, `layer_0` is `layer.0`, `query1_0` is
`query1.0`, `mlp_x_1` is `mlp_x.1`); `dtype` is the compute type, as
UNetBase's. No hand-written kernel runs on this model's path.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from accunet_tpu_torch.models.unet import ConvBatchNorm, _NConvs
from accunet_tpu_torch.nn.acc_blocks import BatchNorm
from accunet_tpu_torch.nn.unext_blocks import LayerNorm
from accunet_tpu_torch.ops.conv import conv1x1, linear, patchify
from accunet_tpu_torch.ops.pooling import global_avg_pool, max_pool2d, upsample_nearest

PATCH_SIZES = (16, 8, 4, 2)  # UCTransNet's, one per skip level: (img_size // 16)^2 tokens
EXPAND_RATIO = 4  # BlockViT's MLP width over its level's channels
NUM_HEADS = 4  # AttentionOrg's heads


class ChannelEmbeddings(nn.Module):
    def __init__(self, patch: int, channels: int, n_patches: int):
        super().__init__()
        self.patch_embeddings = nn.Conv2d(channels, channels, patch, stride=patch)
        self.position_embeddings = nn.Parameter(torch.zeros(1, n_patches, channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch_embeddings
        tok = patchify(x, p.weight, p.bias).flatten(1, 2)
        return tok + self.position_embeddings.to(tok.dtype)


def _instance_norm_scores(s: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """s (B, heads, C_i, KV) normalised per head over its (C_i, KV) map."""
    mean = s.mean(dim=(2, 3), keepdim=True)
    var = (s - mean).square().mean(dim=(2, 3), keepdim=True)
    return (s - mean) * torch.rsqrt(var + eps)


def _heads(t: torch.Tensor, weights: nn.ModuleList) -> torch.Tensor:
    """Each head's bias-free projection of t (B, n, c), in one product:
    (B, heads, n, out)."""
    w = torch.cat([m.weight for m in weights])
    y = linear(t, w)
    return y.unflatten(-1, (len(weights), -1)).transpose(1, 2)


class AttentionOrg(nn.Module):
    def __init__(self, channel_num: Sequence[int]):
        super().__init__()
        kv = sum(channel_num)
        self.kv_size = kv

        def per_head(cin, cout):
            return nn.ModuleList(nn.Linear(cin, cout, bias=False) for _ in range(NUM_HEADS))

        self.key = per_head(kv, kv)
        self.value = per_head(kv, kv)
        for i, c in enumerate(channel_num):
            setattr(self, f"query{i + 1}", per_head(c, c))
            setattr(self, f"out{i + 1}", nn.Linear(c, c, bias=False))

    def forward(self, embs, emb_all: torch.Tensor) -> list[torch.Tensor]:
        k = _heads(emb_all, self.key)                    # (B, heads, n, KV)
        v = _heads(emb_all, self.value)
        outs = []
        for i, emb in enumerate(embs):
            q = _heads(emb, getattr(self, f"query{i + 1}")).transpose(2, 3)  # (B, h, C_i, n)
            scores = q @ k / math.sqrt(self.kv_size)
            probs = torch.softmax(_instance_norm_scores(scores), dim=-1)
            ctx = (probs @ v.transpose(2, 3)).mean(dim=1).transpose(1, 2)  # (B, n, C_i)
            out = getattr(self, f"out{i + 1}")
            outs.append(linear(ctx, out.weight))
        return outs


class Mlp(nn.Module):
    def __init__(self, channels: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(channels, hidden)
        self.fc2 = nn.Linear(hidden, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(linear(x, self.fc1.weight, self.fc1.bias))
        return linear(x, self.fc2.weight, self.fc2.bias)


class BlockViT(nn.Module):
    def __init__(self, channel_num: Sequence[int]):
        super().__init__()
        for i, c in enumerate(channel_num):
            setattr(self, f"attn_norm{i + 1}", LayerNorm(c, eps=1e-6))
            setattr(self, f"ffn_norm{i + 1}", LayerNorm(c, eps=1e-6))
            setattr(self, f"ffn{i + 1}", Mlp(c, c * EXPAND_RATIO))
        self.attn_norm = LayerNorm(sum(channel_num), eps=1e-6)
        self.channel_attn = AttentionOrg(channel_num)

    def forward(self, embs):
        emb_all = self.attn_norm(torch.cat(embs, dim=2))
        cxs = [getattr(self, f"attn_norm{i + 1}")(e) for i, e in enumerate(embs)]
        cxs = [e + a for e, a in zip(embs, self.channel_attn(cxs, emb_all))]
        return [getattr(self, f"ffn{i + 1}")(getattr(self, f"ffn_norm{i + 1}")(cx)) + cx
                for i, cx in enumerate(cxs)]


class CTransEncoder(nn.Module):
    def __init__(self, channel_num: Sequence[int], num_layers: int = 4):
        super().__init__()
        self.layer = nn.ModuleList(BlockViT(channel_num)
                                   for _ in range(num_layers))
        for i, c in enumerate(channel_num):
            setattr(self, f"encoder_norm{i + 1}", LayerNorm(c, eps=1e-6))

    def forward(self, embs):
        for layer in self.layer:
            embs = layer(embs)
        return [getattr(self, f"encoder_norm{i + 1}")(e) for i, e in enumerate(embs)]


class Reconstruct(nn.Module):
    """Tokens (B, n, C) back to a (B, sqrt(n) * scale, .., C) map: nearest
    upsample, 1x1 conv, BN, ReLU."""

    def __init__(self, channels: int, out_channels: int, scale: int):
        super().__init__()
        self.scale = scale
        self.conv = nn.Conv2d(channels, out_channels, 1)
        self.norm = BatchNorm(out_channels)

    def forward(self, tok: torch.Tensor) -> torch.Tensor:
        b, n, c = tok.shape
        hw = math.isqrt(n)
        y = upsample_nearest(tok.reshape(b, hw, hw, c), self.scale)
        return F.relu(self.norm(conv1x1(y, self.conv.weight, self.conv.bias)))


class ChannelTransformer(nn.Module):
    """The four skips en (B, H / 2^i, .., C_i) -> the same shapes. Level i
    is patchified by patch_sizes[i]; every level gives (img_size //
    patch_sizes[0])^2 tokens (SMESwinUnet's patches give one)."""

    def __init__(self, channel_num: Sequence[int], img_size: int,
                 patch_sizes: Sequence[int] = PATCH_SIZES, num_layers: int = 4):
        super().__init__()
        n_patches = (img_size // patch_sizes[0]) ** 2
        for i, (p, c) in enumerate(zip(patch_sizes, channel_num)):
            setattr(self, f"embeddings_{i + 1}", ChannelEmbeddings(p, c, n_patches))
            setattr(self, f"reconstruct_{i + 1}", Reconstruct(c, c, p))
        self.encoder = CTransEncoder(channel_num, num_layers)

    def forward(self, en):
        embs = [getattr(self, f"embeddings_{i + 1}")(x) for i, x in enumerate(en)]
        return [getattr(self, f"reconstruct_{i + 1}")(e) + x
                for i, (e, x) in enumerate(zip(self.encoder(embs), en))]


class CCA(nn.Module):
    """The channel gate of the skip x from the decoder's g."""

    def __init__(self, f_g: int, f_x: int):
        super().__init__()
        self.mlp_x = nn.ModuleDict({"1": nn.Linear(f_x, f_x)})  # Sequential(Flatten, Linear)
        self.mlp_g = nn.ModuleDict({"1": nn.Linear(f_g, f_x)})

    def forward(self, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        mx, mg = self.mlp_x["1"], self.mlp_g["1"]
        att = (linear(global_avg_pool(x), mx.weight, mx.bias)
               + linear(global_avg_pool(g), mg.weight, mg.bias))
        return F.relu(x * torch.sigmoid(att / 2.0)[:, None, None, :])


class UpBlockAttention(_NConvs):
    def __init__(self, in_channels: int, skip_channels: int, out_channels: int):
        super().__init__(in_channels + skip_channels, out_channels)
        self.coatt = CCA(in_channels, skip_channels)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up = upsample_nearest(x, 2)
        return super().forward(torch.cat([self.coatt(up, skip), up], dim=-1))


class UCTransNet(nn.Module):
    """x (B, img_size, img_size, n_channels) -> float32 (B, img_size,
    img_size, 1 or n_classes + 1)."""

    def __init__(self, n_channels: int = 3, n_classes: int = 1, img_size: int = 224,
                 base_channel: int = 64, num_layers: int = 4, final_sigmoid: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        c = base_channel
        self.sigmoid = n_classes == 1 and final_sigmoid
        self.dtype = dtype
        self.inc = ConvBatchNorm(n_channels, c)
        self.down1 = _NConvs(c, c * 2)
        self.down2 = _NConvs(c * 2, c * 4)
        self.down3 = _NConvs(c * 4, c * 8)
        self.down4 = _NConvs(c * 8, c * 8)
        self.mtc = ChannelTransformer((c, c * 2, c * 4, c * 8), img_size,
                                      num_layers=num_layers)
        self.up4 = UpBlockAttention(c * 8, c * 8, c * 4)
        self.up3 = UpBlockAttention(c * 4, c * 4, c * 2)
        self.up2 = UpBlockAttention(c * 2, c * 2, c)
        self.up1 = UpBlockAttention(c, c, c)
        self.outc = nn.Conv2d(c, n_classes if n_classes == 1 else n_classes + 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.outc.weight.dtype if self.dtype is None else self.dtype)
        x1 = self.inc(x)
        x2 = self.down1(max_pool2d(x1, 2))
        x3 = self.down2(max_pool2d(x2, 2))
        x4 = self.down3(max_pool2d(x3, 2))
        x5 = self.down4(max_pool2d(x4, 2))
        x1, x2, x3, x4 = self.mtc((x1, x2, x3, x4))
        y = self.up1(self.up2(self.up3(self.up4(x5, x4), x3), x2), x1)
        y = conv1x1(y, self.outc.weight, self.outc.bias)
        return (torch.sigmoid(y) if self.sigmoid else y).float()
