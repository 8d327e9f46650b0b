"""CMRF / UNeXt-variant blocks (torch.nn, NHWC), counterpart of
accunet_tpu/nn/cmrf_blocks.py.

  * ConvBNAct: conv without bias -> BN (eps 1e-3, flax momentum 0.97) ->
    exact GELU;
  * CMRF (Cascade Multi-Receptive-Fields): 1x1 to c2/N, even/odd channel
    split, a chain of N-1 3x3 depthwise convs each fed by the last, the
    two halves summed, concat, 1x1 back to c2, a residual when c1 == c2;
    CMRF_OD and CMRF_BS are the same cascade over other blocks;
  * ODAttention / ODConv2d / ODConvBNAct / CMRF_OD: the omni-dimensional
    dynamic conv (channel, filter, spatial and kernel attentions from the
    input's channel means); its raw 5-D `weight` (Kn, O, I/g, k, k) is
    aggregated per sample, and its BNs run at eps 1e-5, flax momentum 0.9;
  * BSConvU / BSRB / CMRF_BS: blueprint-separable convs; CMRF_BS is JAX's
    completion of the reference's CMRF_BS (which never defines its chain): a
    BSConvU or a BSRB chain;
  * ChannelSE2 / SpatialSE / ChannelSpatialSE: CSSE with an exact-GELU
    squeeze and a max merge;
  * h_sigmoid / ConvModule / InjectionMultiSum(CBR): TopFormer's semantic
    injection (the mmcv-fallback ConvModule: a bias-free 1x1, a BN, no
    activation);
  * ChannelsFirstLN / GroupAggregationBridge / GHPA: EGE-UNet's GAB (four
    depthwise 3x3 convs dilated 1, 2, 5, 7 over (high, low, mask) groups)
    and its grouped multi-axis Hadamard product attention;
  * haar_wavelet_pool2d / AdaptiveWaveletPool2d: single-level wavelet
    pooling that keeps the LL band and rescales it by mean(x) / mean(LL),
    a mean over the whole batch tensor, so one image's output depends on
    the rest of its batch, as in JAX and the reference.

The depthwise convs here (the CMRF chains, BSConvU, GAB, GHPA) are plain
grouped convs (`F.conv2d`; GAB's dilated ones through
`ops.conv.dilated_depthwise_conv2d`), as in JAX, where they are
`nn.Conv(feature_group_count=...)` with no Pallas VJP. Parameter names are
the JAX tree's (`state_dict_from_jax`; raw leaves such as ODConv2d's
`weight`, GHPA's `params_*` and the wavelet filters keep JAX's layout).
"""

from __future__ import annotations

import math
import torch
import torch.nn.functional as F
from torch import nn

from accunet_tpu_torch.nn.acc_blocks import BatchNorm
from accunet_tpu_torch.nn.unext_blocks import LayerNorm
from accunet_tpu_torch.ops.conv import (
    conv1x1,
    conv2d,
    depthwise_conv1d,
    dilated_depthwise_conv2d,
    linear,
)
from accunet_tpu_torch.ops.pooling import avg_pool2d, global_avg_pool
from accunet_tpu_torch.ops.resize import resize_bilinear

OD_REDUCTION = 0.0625  # ODAttention's squeeze width: max(in_planes * this, 16)
SE_REDUCTION = 2  # ChannelSE2's squeeze: num_channels // this
GAB_DILATIONS = (1, 2, 5, 7)  # the GAB's four depthwise convs
GHPA_GRID = 8  # the side of GHPA's learned grids


def _conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """A stride-1 'SAME' nn.Conv2d (1x1 as a matmul) on NHWC."""
    w = conv.weight
    if w.shape[2] == 1 and w.shape[3] == 1 and conv.groups == 1:
        return conv1x1(x, w, conv.bias)
    return conv2d(x, w, conv.bias, groups=conv.groups)


class ConvBNAct(nn.Module):
    """Stride-1 'SAME' conv (bias-free) + BatchNorm(eps 1e-3, momentum 0.03)
    + exact GELU when `act`."""

    def __init__(self, c1: int, c2: int, k: int = 1, groups: int = 1, act: bool = True):
        super().__init__()
        self.act = act
        self.conv = nn.Conv2d(c1, c2, k, padding=k // 2, groups=groups, bias=False)
        self.bn = BatchNorm(c2, eps=1e-3, momentum=0.03)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn(_conv(x, self.conv))
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
    """`pw(c_in, c_out)` builds the two 1x1 blocks (ConvBNAct by default),
    `m(c)` each block of the chain (a 3x3 depthwise ConvBNAct without GELU)."""

    def __init__(self, c1: int, c2: int, N: int = 8, shortcut: bool = True, pw=None, m=None):
        super().__init__()
        pw = pw or (lambda a, b: ConvBNAct(a, b, 1))
        m = m or (lambda c: ConvBNAct(c, c, 3, groups=c, act=False))
        c = int(c2 * 0.5 / N)
        self.add = shortcut and c1 == c2
        self.pwconv1 = pw(c1, c2 // N)
        self.m = nn.ModuleList(m(c) for _ in range(N - 1))
        # the concat: the even half of c2 // N channels, then N - 1 chain outputs
        self.pwconv2 = pw((c2 // N + 1) // 2 + (N - 1) * c, c2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pwconv2(_cmrf_split_chain(self.pwconv1(x), self.m))
        return x + y if self.add else y


# ------------------------------------------------------------------ ODConv


class ODAttention(nn.Module):
    """The four attentions of ODConv2d from the channel means of x (B, H, W,
    Cin): channel (B, 1, 1, Cin); filter (B, 1, 1, O), None for a depthwise
    conv; spatial (B, 1, 1, 1, k, k), None for k 1; kernel (B, Kn, 1, 1, 1,
    1), None for Kn 1. Its BN normalises the (B, 1, 1, C) squeeze: in train
    mode at batch 1 the variance is 0 and the BN returns its shift, as flax's."""

    def __init__(self, in_planes: int, out_planes: int, kernel_size: int, groups: int = 1,
                 kernel_num: int = 4):
        super().__init__()
        att = max(int(in_planes * OD_REDUCTION), 16)
        self.kernel_size, self.kernel_num = kernel_size, kernel_num
        self.fc = nn.Conv2d(in_planes, att, 1, bias=False)
        self.bn = BatchNorm(att)
        self.channel_fc = nn.Conv2d(att, in_planes, 1)
        if not (in_planes == groups and in_planes == out_planes):
            self.filter_fc = nn.Conv2d(att, out_planes, 1)
        if kernel_size > 1:
            self.spatial_fc = nn.Conv2d(att, kernel_size ** 2, 1)
        if kernel_num > 1:
            self.kernel_fc = nn.Conv2d(att, kernel_num, 1)

    def forward(self, x: torch.Tensor):
        s = F.relu(self.bn(conv1x1(global_avg_pool(x)[:, None, None, :], self.fc.weight)))
        channel = torch.sigmoid(_conv(s, self.channel_fc))
        flt = torch.sigmoid(_conv(s, self.filter_fc)) if hasattr(self, "filter_fc") else None
        spatial = kernel = None
        if hasattr(self, "spatial_fc"):
            k = self.kernel_size
            spatial = torch.sigmoid(_conv(s, self.spatial_fc)).reshape(-1, 1, 1, 1, k, k)
        if hasattr(self, "kernel_fc"):
            kernel = torch.softmax(_conv(s, self.kernel_fc).reshape(-1, self.kernel_num,
                                                                    1, 1, 1, 1), dim=1)
        return channel, flt, spatial, kernel


class ODConv2d(nn.Module):
    """Omni-dimensional dynamic conv, stride 1, padding k // 2. The kernel is
    sum_n weight[n] * spatial * kernel[n], per sample where a spatial or
    kernel attention exists (one grouped conv over the batch folded into the
    channels, groups B * g), else one conv for the batch; the input is
    scaled by the channel attention, the output by the filter attention."""

    def __init__(self, in_planes: int, out_planes: int, kernel_size: int, groups: int = 1,
                 kernel_num: int = 4):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(kernel_num, out_planes, in_planes // groups,
                                               kernel_size, kernel_size))
        nn.init.kaiming_normal_(self.weight)
        self.attention = ODAttention(in_planes, out_planes, kernel_size, groups, kernel_num)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        channel, flt, spatial, kernel = self.attention(x)
        x = x * channel
        k, p = self.weight.shape[-1], self.weight.shape[-1] // 2
        if spatial is None and kernel is None:  # one kernel for the batch
            w = self.weight.sum(dim=0)
            if k == 1 and self.groups == 1:
                out = conv1x1(x, w)
            else:
                out = conv2d(x, w, groups=self.groups)
        else:
            w = self.weight[None]
            if spatial is not None:
                w = w * spatial
            if kernel is not None:
                w = w * kernel
            w = w.sum(dim=1).expand(x.shape[0], *self.weight.shape[1:])  # (B, O, I/g, k, k)
            b, h, wd, c = x.shape
            y = F.conv2d(x.permute(0, 3, 1, 2).reshape(1, b * c, h, wd),
                         w.reshape(-1, *w.shape[2:]).to(x.dtype), None, 1, p,
                         groups=b * self.groups)
            out = y.reshape(b, -1, *y.shape[2:]).permute(0, 2, 3, 1)
        return out if flt is None else out * flt


class ODConvBNAct(nn.Module):
    """ODConv2d with one kernel (kernel_num 1) + BN (eps 1e-5) + exact GELU
    when `act`."""

    def __init__(self, c1: int, c2: int, k: int = 3, groups: int = 1, act: bool = True):
        super().__init__()
        self.act = act
        self.conv = ODConv2d(c1, c2, k, groups=groups, kernel_num=1)
        self.bn = BatchNorm(c2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn(self.conv(x))
        return F.gelu(y) if self.act else y


class CMRF_OD(CMRF):
    def __init__(self, c1: int, c2: int, N: int = 8, shortcut: bool = True):
        super().__init__(c1, c2, N, shortcut, pw=lambda a, b: ODConvBNAct(a, b, 1),
                         m=lambda c: ODConvBNAct(c, c, 3, groups=c, act=False))


# ---------------------------------------------------------------- BSDN


class BSConvU(nn.Module):
    """A bias-free 1x1 to c2, then a 3x3 depthwise conv with bias."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.pw = nn.Conv2d(c1, c2, 1, bias=False)
        self.dw = nn.Conv2d(c2, c2, 3, padding=1, groups=c2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv(_conv(x, self.pw), self.dw)


class BSRB(nn.Module):
    """gelu(BSConvU(x) + x), x through a bias-free 1x1 `proj` when the widths differ."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.bsconv = BSConvU(c1, c2)
        if c1 != c2:
            self.proj = nn.Conv2d(c1, c2, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = _conv(x, self.proj) if hasattr(self, "proj") else x
        return F.gelu(self.bsconv(x) + residual)


class CMRF_BS(CMRF):
    """CMRF with a BSConvU (`block='bsconv'`) or BSRB (`'bsrb'`) chain."""

    def __init__(self, c1: int, c2: int, N: int = 8, shortcut: bool = True,
                 block: str = "bsconv"):
        m = {"bsconv": lambda c: BSConvU(c, c), "bsrb": lambda c: BSRB(c, c)}[block]
        super().__init__(c1, c2, N, shortcut, m=m)


# ------------------------------------------------------------------ SE zoo


class ChannelSE2(nn.Module):
    """x * sigmoid(fc2(gelu(fc1(mean_hw(x))))), squeezed by SE_REDUCTION."""

    def __init__(self, num_channels: int):
        super().__init__()
        self.fc1 = nn.Linear(num_channels, num_channels // SE_REDUCTION)
        self.fc2 = nn.Linear(num_channels // SE_REDUCTION, num_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.gelu(linear(global_avg_pool(x), self.fc1.weight, self.fc1.bias))
        s = torch.sigmoid(linear(s, self.fc2.weight, self.fc2.bias))
        return x * s[:, None, None, :]


class SpatialSE(nn.Module):
    def __init__(self, num_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(num_channels, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(_conv(x, self.conv))


class ChannelSpatialSE(nn.Module):
    def __init__(self, num_channels: int):
        super().__init__()
        self.cSE = ChannelSE2(num_channels)
        self.sSE = SpatialSE(num_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.maximum(self.cSE(x), self.sSE(x))


# ------------------------------------------------------- TopFormer SIM


def h_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


class ConvModule(nn.Module):
    """A bias-free 1x1 conv, then a BN (eps 1e-5) when `use_bn`."""

    def __init__(self, c1: int, c2: int, use_bn: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, 1, bias=False)
        if use_bn:
            self.bn = BatchNorm(c2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv1x1(x, self.conv.weight)
        return self.bn(y) if hasattr(self, "bn") else y


class InjectionMultiSum(nn.Module):
    """local_embedding(x_l) * h_sigmoid(global_act(x_g)) +
    global_embedding(x_g), the global terms resized to x_l's map
    (align_corners=False); InjectionMultiSumCBR's global_act has no BN."""

    act_bn = True

    def __init__(self, inp_l: int, inp_g: int, oup: int):
        super().__init__()
        self.local_embedding = ConvModule(inp_l, oup)
        self.global_act = ConvModule(inp_g, oup, self.act_bn)
        self.global_embedding = ConvModule(inp_g, oup)

    def forward(self, x_l: torch.Tensor, x_g: torch.Tensor) -> torch.Tensor:
        hw = tuple(x_l.shape[1:3])
        sig = resize_bilinear(h_sigmoid(self.global_act(x_g)), hw)
        gfeat = resize_bilinear(self.global_embedding(x_g), hw)
        return self.local_embedding(x_l) * sig + gfeat


class InjectionMultiSumCBR(InjectionMultiSum):
    act_bn = False


# ------------------------------------------------------------- EGE GAB


class ChannelsFirstLN(LayerNorm):
    """EGE-UNet's LayerNorm over the channels (the last axis of NHWC), eps 1e-6."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)


class GroupAggregationBridge(nn.Module):
    """xh (B, h, w, dim_xh) through a 1x1 to dim_xl and resized
    (align_corners=True) to xl (B, H, W, dim_xl); group i of four:
    [xh chunk i, xl chunk i, mask] -> LN -> 3x3 depthwise conv dilated
    GAB_DILATIONS[i]; the concat -> LN -> 1x1 to dim_xl."""

    def __init__(self, dim_xh: int, dim_xl: int):
        super().__init__()
        gsize = dim_xl // 2
        self.pre_project = nn.Conv2d(dim_xh, dim_xl, 1)
        for i in range(len(GAB_DILATIONS)):
            setattr(self, f"g{i}_ln", ChannelsFirstLN(gsize + 1))
            setattr(self, f"g{i}_conv", nn.Conv2d(gsize + 1, gsize + 1, 3, groups=gsize + 1))
        self.tail_ln = ChannelsFirstLN(2 * dim_xl + 4)
        self.tail_conv = nn.Conv2d(2 * dim_xl + 4, dim_xl, 1)

    def forward(self, xh: torch.Tensor, xl: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        xh = resize_bilinear(_conv(xh, self.pre_project), tuple(xl.shape[1:3]), True)
        xh_chunks, xl_chunks = xh.split(xh.shape[-1] // 4, -1), xl.split(xl.shape[-1] // 4, -1)
        outs = []
        for i, d in enumerate(GAB_DILATIONS):
            t = getattr(self, f"g{i}_ln")(torch.cat([xh_chunks[i], xl_chunks[i], mask], -1))
            conv = getattr(self, f"g{i}_conv")
            outs.append(dilated_depthwise_conv2d(t, conv.weight, conv.bias, d))
        return _conv(self.tail_ln(torch.cat(outs, -1)), self.tail_conv)


class GHPA(nn.Module):
    """Grouped multi-axis Hadamard product attention (EGE-UNet): the
    channel quarters x1-x3 gated by learned grids of side g = GHPA_GRID
    (`params_xy` (1, g, g, c4) over (H, W), `params_zx` / `params_zy` (1,
    c4, g, 1) over (C, H) /
    (C, W)) resized with align_corners=True and passed through a depthwise
    conv, GELU and a 1x1 (1-D along H or W for zx / zy); x4 through a 1x1,
    GELU, a 3x3 depthwise; then LN, a 3x3 depthwise, GELU, a 1x1 to dim_out."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        c4, grid = dim_in // 4, GHPA_GRID
        self.norm1 = ChannelsFirstLN(dim_in)
        self.params_xy = nn.Parameter(torch.empty(1, grid, grid, c4))
        self.conv_xy = nn.ModuleDict({"0": nn.Conv2d(c4, c4, 3, padding=1, groups=c4),
                                      "2": nn.Conv2d(c4, c4, 1)})
        for axis in ("zx", "zy"):
            setattr(self, f"params_{axis}", nn.Parameter(torch.empty(1, c4, grid, 1)))
            setattr(self, f"conv_{axis}", nn.ModuleDict({
                "0": nn.Conv1d(c4, c4, 3, padding=1, groups=c4), "2": nn.Conv1d(c4, c4, 1)}))
        self.dw = nn.ModuleDict({"0": nn.Conv2d(dim_in - 3 * c4, c4, 1),
                                 "2": nn.Conv2d(c4, c4, 3, padding=1, groups=c4)})
        self.norm2 = ChannelsFirstLN(dim_in)
        self.ldw = nn.ModuleDict({"0": nn.Conv2d(dim_in, dim_in, 3, padding=1, groups=dim_in),
                                  "2": nn.Conv2d(dim_in, dim_out, 1)})
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        for p in (self.params_xy, self.params_zx, self.params_zy):
            p.fill_(1.0)

    def _axis_gate(self, axis: str, n: int, dt: torch.dtype) -> torch.Tensor:
        """The (1, n, c4) gate along H (zx) or W (zy) of length n."""
        p, conv = getattr(self, f"params_{axis}"), getattr(self, f"conv_{axis}")
        gate = resize_bilinear(p.to(dt), (p.shape[1], n), True)[..., 0]  # (1, c4, n)
        gate = F.gelu(depthwise_conv1d(gate, conv["0"].weight, conv["0"].bias))
        return conv1x1(gate.transpose(1, 2), conv["2"].weight, conv["2"].bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        c4 = self.params_xy.shape[-1]
        x = self.norm1(x)
        x1, x2, x3, x4 = x[..., :c4], x[..., c4:2 * c4], x[..., 2 * c4:3 * c4], x[..., 3 * c4:]
        h, w = x.shape[1], x.shape[2]
        gate = resize_bilinear(self.params_xy.to(dt), (h, w), True)
        x1 = x1 * _conv(F.gelu(_conv(gate, self.conv_xy["0"])), self.conv_xy["2"])
        x2 = x2 * self._axis_gate("zx", h, dt)[:, :, None, :]
        x3 = x3 * self._axis_gate("zy", w, dt)[:, None, :, :]
        x4 = _conv(F.gelu(_conv(x4, self.dw["0"])), self.dw["2"])
        y = self.norm2(torch.cat([x1, x2, x3, x4], -1))
        return _conv(F.gelu(_conv(y, self.ldw["0"])), self.ldw["2"])


# ------------------------------------------------------------- wavelet


def haar_wavelet_pool2d(x: torch.Tensor) -> torch.Tensor:
    """StaticWaveletPool2d(haar, scales=1): the LL band of a one-level Haar
    transform (2x the 2x2 average) rescaled by mean(x) / mean(LL) over the
    whole tensor, batch included; a |mean(LL)| below 1e-12 keeps the scale 1
    (JAX's guard; the reference divides by it)."""
    ll = avg_pool2d(x, 2) * 2.0
    denom = ll.mean()
    return ll * torch.where(denom.abs() < 1e-12, torch.ones_like(denom), x.mean() / denom)


class AdaptiveWaveletPool2d(nn.Module):
    """Learnable one-level wavelet pooling with 2-tap filters (the only
    length JAX's takes): a 2x2 stride-2
    depthwise conv with the outer product of the FLIPPED `dec_lo` (the
    reference's flip=True cross-correlation), rescaled by mean(x) /
    mean(out) over the whole tensor. `scales_weights` and `dec_hi` enter
    only `product_filter_loss` and the state, as in JAX. Haar at init."""

    def __init__(self):
        super().__init__()
        self.dec_lo = nn.Parameter(torch.empty(2))
        self.scales_weights = nn.Parameter(torch.empty(1))
        self.dec_hi = nn.Parameter(torch.empty(2))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        r = 1.0 / math.sqrt(2.0)
        self.dec_lo.fill_(r)
        self.scales_weights.fill_(1.0)
        self.dec_hi.copy_(torch.tensor([r, -r]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lo = self.dec_lo.flip(0)
        ll = (lo[:, None] * lo[None, :]).to(x.dtype)
        b, h, w, c = x.shape
        win = x[:, :h - h % 2, :w - w % 2].reshape(b, h // 2, 2, w // 2, 2, c)
        out = torch.einsum("bipjqc,pq->bijc", win, ll)
        return out * (x.mean() / out.mean())

    @staticmethod
    def product_filter_loss(dec_lo: torch.Tensor, dec_hi: torch.Tensor) -> torch.Tensor:
        """sum((lo (*) flip(lo) + hi (*) flip(hi) - 2 delta_centre)^2), (*) the
        full convolution: the orthogonality condition for perfect
        reconstruction."""
        def convolve(a, b):
            n = a.numel() + b.numel() - 1
            return sum(F.pad(a[i] * b, (i, n - b.numel() - i)) for i in range(a.numel()))

        p = convolve(dec_lo, dec_lo.flip(0)) + convolve(dec_hi, dec_hi.flip(0))
        target = torch.zeros_like(p)
        target[p.shape[0] // 2] = 2.0
        return ((p - target) ** 2).sum()
