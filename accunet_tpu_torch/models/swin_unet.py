"""Swin window attention in torch.nn: the part of
accunet_tpu/models/swin_unet.py that the SegMamba `_SWAttn` rung uses
(`_rel_pos_index`, `window_partition`, `window_reverse`, `WindowAttention`).

    WindowAttention on windows (B*nW, ws*ws, C): one qkv Linear, per head
    softmax(q k^T / sqrt(hd) + the relative position bias [+ mask]) v, proj

The model SwinUnet itself (shifted blocks, patch merging and expanding) is
not ported yet (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


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
        q, k, v = self.qkv(x).reshape(bw, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        attn = (q * hd ** -0.5) @ k.transpose(-1, -2)
        bias = self.relative_position_bias_table[self.relative_position_index]
        attn = attn + bias.reshape(n, n, heads).permute(2, 0, 1)[None].to(attn.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(bw // nw, nw, heads, n, n)
                    + mask[None, :, None].to(attn.dtype)).reshape(bw, heads, n, n)
        out = (torch.softmax(attn, dim=-1) @ v).transpose(1, 2).reshape(bw, n, c)
        return self.proj(out)
