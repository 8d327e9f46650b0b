"""CMRF blocks (torch.nn, NHWC), counterpart of the plain-CMRF part of
accunet_tpu/nn/cmrf_blocks.py (`ConvBNAct`, `_cmrf_split_chain`, `CMRF`).

  * ConvBNAct: conv without bias -> BN (eps 1e-3, flax momentum 0.97) ->
    exact GELU;
  * CMRF (Cascade Multi-Receptive-Fields): 1x1 to c2/N, even/odd channel
    split, a chain of N-1 3x3 depthwise convs each fed by the last, the
    two halves summed, concat, 1x1 back to c2, a residual when c1 == c2.

The chain's depthwise convs are plain grouped convs (`F.conv2d`), as in JAX,
where they are `nn.Conv(feature_group_count=c)` with no Pallas VJP. The OD,
BS and BSRB encoders, CSSE, GAB, the TopFormer injection and the wavelet
pools are not ported yet (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from accunet_tpu_torch.nn.acc_blocks import BatchNorm
from accunet_tpu_torch.ops.conv import conv1x1, conv2d


class ConvBNAct(nn.Module):
    """Stride-1 'SAME' conv (bias-free) + BatchNorm(eps 1e-3, momentum 0.03)
    + exact GELU when `act`."""

    def __init__(self, c1: int, c2: int, k: int = 1, groups: int = 1, act: bool = True):
        super().__init__()
        self.act = act
        self.conv = nn.Conv2d(c1, c2, k, padding=k // 2, groups=groups, bias=False)
        self.bn = BatchNorm(c2, eps=1e-3, momentum=0.03)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.conv.weight
        if w.shape[2] == 1 and self.conv.groups == 1:
            y = conv1x1(x, w)
        else:
            y = conv2d(x, w, groups=self.conv.groups)
        y = self.bn(y)
        return F.gelu(y) if self.act else y


def _cmrf_split_chain(x: torch.Tensor, m_blocks) -> torch.Tensor:
    """Even/odd channel split, each block fed by the last part, the two
    halves summed: cat([even + odd, m_0(odd), m_1(m_0(odd)), ...])."""
    parts = [x[..., 0::2], x[..., 1::2]]
    for m in m_blocks:
        parts.append(m(parts[-1]))
    parts[0] = parts[0] + parts.pop(1)
    return torch.cat(parts, dim=-1)


class CMRF(nn.Module):
    def __init__(self, c1: int, c2: int, N: int = 8, shortcut: bool = True):
        super().__init__()
        c = int(c2 * 0.5 / N)
        self.add = shortcut and c1 == c2
        self.pwconv1 = ConvBNAct(c1, c2 // N, 1)
        self.m = nn.ModuleList(ConvBNAct(c, c, 3, groups=c, act=False) for _ in range(N - 1))
        # the concat: the even half of c2 // N channels, then N - 1 chain outputs
        self.pwconv2 = ConvBNAct((c2 // N + 1) // 2 + (N - 1) * c, c2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pwconv2(_cmrf_split_chain(self.pwconv1(x), self.m))
        return x + y if self.add else y
