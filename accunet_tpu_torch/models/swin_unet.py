"""Swin-Unet, the shifted-window transformer UNet (torch.nn, tokens (B, L, C)
over NHWC images): counterpart of accunet_tpu/models/swin_unet.py.

    WindowAttention on windows (B*nW, ws*ws, C): one qkv Linear, per head
        softmax(q k^T / sqrt(hd) + the relative position bias [+ mask]) v,
        proj; matmuls and an explicit softmax, no library attention kernel
    SwinBlock: LN -> (shifted) window attention -> residual, LN -> fc1 ->
        exact GELU -> fc2 -> residual. A shifted block rolls the map by
        -shift before the attention and by +shift after it, and masks
        cross-region pairs with -100; a map no larger than the window takes
        the whole map as its window and no shift
    PatchMerging: x[0::2, 0::2], x[1::2, 0::2], x[0::2, 1::2], x[1::2, 1::2]
        concatenated, LN, a bias-free 4C -> 2C Linear
    PatchExpand / FinalPatchExpandX4: a bias-free Linear to 2C / 16C, the
        (2, 2) / (4, 4) pixel shuffle, LN
    SwinUnet: a 4x4 patch embedding (LN), four stages (depths 2, 2, 2, 2,
        heads 3, 6, 12, 24), each stage's input kept as a skip, PatchMerging
        between them, LN; the decoder expands, concatenates each skip and
        applies concat_back_dim, then the stage's blocks; LN, the 4x expand
        and a bias-free 1x1 head: 1 channel (sigmoid when final_sigmoid) or
        n_classes + 1

One input channel is repeated to three. The token grid is fixed by
`img_size`, as in JAX: another input size fails to reshape. Names follow the
JAX tree through `state_dict_from_jax` (`layers_0_blocks_1` is
`layers_0_blocks.1`, `layers_up_0` is `layers_up.0`, `concat_back_dim_1` is
`concat_back_dim.1`); `port.swin_load_from` maps them to the reference's
checkpoint names. `dtype` is the compute type, as UNetBase's. No
hand-written kernel runs on this model's path.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from accunet_tpu_torch.nn.unext_blocks import LayerNorm
from accunet_tpu_torch.ops.conv import conv1x1, linear, patchify

PATCH_SIZE = 4
DEPTHS = (2, 2, 2, 2)  # SwinBlocks per stage, encoder and decoder
NUM_HEADS = (3, 6, 12, 24)
MLP_RATIO = 4


def _rel_pos_index(ws: int) -> np.ndarray:
    """(ws^2, ws^2) index into the ((2 ws - 1)^2, heads) bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * H/ws * W/ws, ws*ws, C), windows row by row."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(wins: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """The inverse of window_partition: windows -> (B, H, W, C)."""
    b = wins.shape[0] // (h * w // ws // ws)
    x = wins.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def _attn_mask(h: int, w: int, ws: int, shift: int) -> torch.Tensor:
    """(nW, ws^2, ws^2): -100 where two tokens of a window of the rolled map
    come from different regions (three slices per axis), else 0."""
    img = torch.zeros(1, h, w, 1)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    mw = window_partition(img, ws).reshape(-1, ws * ws)
    return torch.where(mw[:, None, :] != mw[:, :, None], -100.0, 0.0)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(_rel_pos_index(window_size)).reshape(-1),
                             persistent=False)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        nn.init.normal_(self.relative_position_bias_table, std=0.02)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        """x (B*nW, N, C); mask (nW, N, N) additive, or None."""
        bw, n, c = x.shape
        heads = self.num_heads
        hd = c // heads
        qkv = linear(x, self.qkv.weight, self.qkv.bias)
        q, k, v = qkv.reshape(bw, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        attn = (q * hd ** -0.5) @ k.transpose(-1, -2)
        bias = self.relative_position_bias_table[self.relative_position_index]
        attn = attn + bias.reshape(n, n, heads).permute(2, 0, 1)[None].to(attn.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(bw // nw, nw, heads, n, n)
                    + mask[None, :, None].to(attn.dtype)).reshape(bw, heads, n, n)
        out = (torch.softmax(attn, dim=-1) @ v).transpose(1, 2).reshape(bw, n, c)
        return linear(out, self.proj.weight, self.proj.bias)


class SwinBlock(nn.Module):
    """Tokens (B, h*w, dim) of an h x w map -> the same shape."""

    def __init__(self, dim: int, input_resolution: tuple[int, int], num_heads: int,
                 shift: int = 0, window_size: int = 7):
        super().__init__()
        h, w = input_resolution
        if min(h, w) <= window_size:  # the window covers the map: no shift
            window_size, shift = min(h, w), 0
        self.h, self.w, self.ws, self.shift = h, w, window_size, shift
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp_fc1 = nn.Linear(dim, MLP_RATIO * dim)
        self.mlp_fc2 = nn.Linear(MLP_RATIO * dim, dim)
        self.register_buffer("attn_mask", _attn_mask(h, w, window_size, shift) if shift else None,
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, c = x.shape
        h, w, ws, s = self.h, self.w, self.ws, self.shift
        y = self.norm1(x).reshape(b, h, w, c)
        if s:
            y = torch.roll(y, (-s, -s), (1, 2))
        y = window_reverse(self.attn(window_partition(y, ws), self.attn_mask), ws, h, w)
        if s:
            y = torch.roll(y, (s, s), (1, 2))
        x = x + y.reshape(b, l, c)
        y = F.gelu(linear(self.norm2(x), self.mlp_fc1.weight, self.mlp_fc1.bias))
        return x + linear(y, self.mlp_fc2.weight, self.mlp_fc2.bias)


class PatchMerging(nn.Module):
    """Tokens (B, h*w, dim) -> (B, h*w / 4, 2 dim)."""

    def __init__(self, dim: int, input_resolution: tuple[int, int]):
        super().__init__()
        self.h, self.w = input_resolution
        self.norm = LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, c = x.shape
        y = x.reshape(b, self.h, self.w, c)
        y = torch.cat([y[:, 0::2, 0::2], y[:, 1::2, 0::2], y[:, 0::2, 1::2], y[:, 1::2, 1::2]],
                      dim=-1)
        return linear(self.norm(y.reshape(b, l // 4, 4 * c)), self.reduction.weight)


def _pixel_shuffle(y: torch.Tensor, h: int, w: int, s: int) -> torch.Tensor:
    """Tokens (B, h*w, s*s*c) of an h x w map -> (B, s*h * s*w, c): token
    (i, j)'s channel block (a, b) goes to pixel (s*i + a, s*j + b)."""
    b, l, c = y.shape
    y = y.reshape(b, h, w, s, s, c // (s * s)).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, s * s * l, c // (s * s))


class PatchExpand(nn.Module):
    """Tokens (B, h*w, dim) -> (B, 4 h*w, dim / 2)."""

    def __init__(self, dim: int, input_resolution: tuple[int, int]):
        super().__init__()
        self.h, self.w = input_resolution
        self.expand = nn.Linear(dim, 2 * dim, bias=False)
        self.norm = LayerNorm(dim // 2, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(_pixel_shuffle(linear(x, self.expand.weight), self.h, self.w, 2))


class FinalPatchExpandX4(nn.Module):
    """Tokens (B, h*w, dim) -> (B, 16 h*w, dim)."""

    def __init__(self, dim: int, input_resolution: tuple[int, int]):
        super().__init__()
        self.h, self.w = input_resolution
        self.expand = nn.Linear(dim, 16 * dim, bias=False)
        self.norm = LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(_pixel_shuffle(linear(x, self.expand.weight), self.h, self.w, 4))


class SwinUnet(nn.Module):
    """x (B, img_size, img_size, n_channels) -> float32 (B, img_size,
    img_size, 1 or n_classes + 1); img_size divisible by 4 * 2^3 * the
    window size (224 at window 7)."""

    def __init__(self, n_channels: int = 3, n_classes: int = 1, img_size: int = 224,
                 embed_dim: int = 96, window_size: int = 7, final_sigmoid: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        nl, p = len(DEPTHS), PATCH_SIZE
        self.pres = pres = img_size // p
        self.embed_dim = embed_dim
        self.sigmoid = n_classes == 1 and final_sigmoid
        self.dtype = dtype

        def blocks(i):
            res = pres >> i
            return nn.ModuleList(
                SwinBlock(embed_dim << i, (res, res), NUM_HEADS[i],
                          0 if j % 2 == 0 else window_size // 2, window_size)
                for j in range(DEPTHS[i]))

        self.patch_embed_proj = nn.Conv2d(3 if n_channels == 1 else n_channels, embed_dim, p,
                                          stride=p)
        self.patch_embed_norm = LayerNorm(embed_dim, eps=1e-5)
        for i in range(nl):
            setattr(self, f"layers_{i}_blocks", blocks(i))
            if i < nl - 1:
                setattr(self, f"layers_{i}_downsample",
                        PatchMerging(embed_dim << i, (pres >> i, pres >> i)))
        self.norm = LayerNorm(embed_dim << (nl - 1), eps=1e-5)
        last = pres >> (nl - 1)
        self.layers_up = nn.ModuleList([PatchExpand(embed_dim << (nl - 1), (last, last))])
        self.concat_back_dim = nn.ModuleDict()
        for i in range(1, nl):
            rev = nl - 1 - i
            dim = embed_dim << rev
            self.concat_back_dim[str(i)] = nn.Linear(2 * dim, dim)
            setattr(self, f"layers_up_{i}_blocks", blocks(rev))
            if i < nl - 1:
                setattr(self, f"layers_up_{i}_upsample",
                        PatchExpand(dim, (pres >> rev, pres >> rev)))
        self.norm_up = LayerNorm(embed_dim, eps=1e-5)
        self.up = FinalPatchExpandX4(embed_dim, (pres, pres))
        self.output = nn.Conv2d(embed_dim, n_classes if n_classes == 1 else n_classes + 1, 1,
                                bias=False)

    def prepare(self, x: torch.Tensor) -> torch.Tensor:
        """The input in the compute type, one channel repeated to three."""
        x = x.to(self.output.weight.dtype if self.dtype is None else self.dtype)
        return x.expand(*x.shape[:-1], 3) if x.shape[-1] == 1 else x

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """The bottleneck tokens (after `norm`) and the four stages' inputs."""
        p = self.patch_embed_proj
        tok = self.patch_embed_norm(patchify(x, p.weight, p.bias).flatten(1, 2))
        skips = []
        for i in range(len(DEPTHS)):
            skips.append(tok)
            for blk in getattr(self, f"layers_{i}_blocks"):
                tok = blk(tok)
            if i < len(DEPTHS) - 1:
                tok = getattr(self, f"layers_{i}_downsample")(tok)
        return self.norm(tok), skips

    def decode(self, tok: torch.Tensor, skips: list[torch.Tensor]) -> torch.Tensor:
        nl = len(DEPTHS)
        tok = self.layers_up[0](tok)
        for i in range(1, nl):
            cb = self.concat_back_dim[str(i)]
            tok = linear(torch.cat([tok, skips[nl - 1 - i]], dim=-1), cb.weight, cb.bias)
            for blk in getattr(self, f"layers_up_{i}_blocks"):
                tok = blk(tok)
            if i < nl - 1:
                tok = getattr(self, f"layers_up_{i}_upsample")(tok)
        tok = self.up(self.norm_up(tok))
        side = 4 * self.pres
        y = conv1x1(tok.reshape(tok.shape[0], side, side, self.embed_dim), self.output.weight)
        return (torch.sigmoid(y) if self.sigmoid else y).float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(*self.encode(self.prepare(x)))
