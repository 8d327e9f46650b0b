"""ACC-UNet building blocks (torch.nn, NHWC tensors).

Counterpart of accunet_tpu/nn/acc_blocks.py. Attribute names are the
reference torch names (the ones accunet_tpu/port/torch_state.py derives from
the flax tree), so a reference `.pth.tar` and a converted JAX tree load with
a strict `load_state_dict`.

Every block takes and returns NHWC tensors. In eval mode the level-1/2
HANCBlocks and ResPaths built with `fused=True` run their fused kernels
(ops/kernels), and every other HANC layer with k >= 2 runs the `hanc_mix`
kernel. An unfused HANCBlock built with `hybrid=True` whose interior width
E = n_filts * inv_fctr is at least `hybrid_e_min` runs its eval-mode front
half (expand, BN, lrelu, depthwise, BN, lrelu) as the `expand_dw` kernel;
its HANC mix (`hanc_mix`) and tail stay as they are. In train mode every
block takes the unfused path; its HANC layers still run `hanc_mix` forward
(`HancMixFn`) and its depthwise convs take their weight gradient from the
`dwconv2d_wgrad` kernel. On a CPU tensor each kernel wrapper runs its plain
PyTorch version.

The blocks compute in the type of their input (bfloat16 or float32): the
parameters stay as they are (fp32 in training) and are cast at use, as
flax's `dtype=` does, and every BatchNorm takes its statistics and
normalises in fp32 and returns the input's type. A gradient through a
fused eval kernel (Seg-Grad-CAM) is the VJP of the kernel's plain version,
recomputed from the saved inputs (`HancBlockFn`, `RespathLevelFn`,
`ExpandDwFn`).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn

from accunet_tpu_torch.ops.activation import lrelu
from accunet_tpu_torch.ops.conv import conv1x1, conv2d, depthwise_conv2d, linear
from accunet_tpu_torch.ops.kernels.expand_dw import ExpandDwFn
from accunet_tpu_torch.ops.kernels.hanc_block import HANCBlockWeights, HancBlockFn, fold
from accunet_tpu_torch.ops.kernels.hanc_mix import HancMixFn
from accunet_tpu_torch.ops.kernels.respath import RespathLevelFn
from accunet_tpu_torch.ops.pooling import (
    avg_pool2d,
    global_avg_pool,
    interleave_channels,
    upsample_nearest,
)

__all__ = [
    "lrelu", "BatchNorm", "ChannelSELayer", "HANCLayer", "Conv2dBatchnorm",
    "HANCBlock", "PendingSE", "ResPath", "MLFC",
]


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over the last axis of an NHWC tensor (run on its
    channels_last NCHW view), with flax's semantics (`batch_norm`,
    accunet_tpu/nn/acc_blocks.py:98-105): eps 1e-5 by default; in train
    mode it normalises with the biased batch variance and updates
    running = (1 - momentum) * running + momentum * batch (momentum 0.1,
    flax's 0.9, by default) for the mean and the *biased* variance, in fp32
    (torch's BatchNorm2d would take the unbiased one). CMRF's ConvBNAct
    takes eps 1e-3 and momentum 0.03 (flax 0.97). A bfloat16 input is
    normalised in fp32 with fp32 statistics and returned in bfloat16, as
    flax's BatchNorm(dtype=bfloat16) does (its `_compute_stats` reduces in
    fp32).

    `frozen_stats` skips that update; the model sets it while activation
    checkpointing recomputes a block, so a step updates the statistics once."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.frozen_stats = False

    def scale_shift(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The inference affine (scale', shift') in fp32."""
        s = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
        return s, self.bias.float() - self.running_mean.float() * s

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc = x.permute(0, 3, 1, 2)
        if not self.training:
            return super().forward(xc).permute(0, 2, 3, 1)
        # batch statistics without running buffers; save_invstd is
        # 1/sqrt(biased var + eps), so the stats need no second pass over x.
        # torch's CPU kernel for a channels_last input sums the fp32 variance
        # ~30x less precisely than its NCHW one (3e-5 of invstd at 8k values
        # a channel), so a CPU tensor goes through an NCHW copy
        if xc.device.type == "cpu":
            xc = xc.contiguous()
        y, mean, invstd = torch.native_batch_norm(xc, self.weight, self.bias, None, None,
                                                  True, 0.0, self.eps)
        if not self.frozen_stats:
            with torch.no_grad():
                var = invstd.to(self.running_var.dtype).pow(-2) - self.eps
                mean = mean.to(self.running_mean.dtype)
                self.running_mean.mul_(1 - self.momentum).add_(mean, alpha=self.momentum)
                self.running_var.mul_(1 - self.momentum).add_(var, alpha=self.momentum)
                self.num_batches_tracked.add_(1)
        return y.permute(0, 2, 3, 1)


class ChannelSELayer(nn.Module):
    """Squeeze-excitation with BN + LeakyReLU applied after the recalibration."""

    def __init__(self, num_channels: int):
        super().__init__()
        self.fc1 = nn.Linear(num_channels, num_channels // 8)
        self.fc2 = nn.Linear(num_channels // 8, num_channels)
        self.bn = BatchNorm(num_channels)

    def gate(self, squeezed: torch.Tensor) -> torch.Tensor:
        """(B, C) channel means -> (B, C) sigmoid gate, in squeezed's type."""
        h = lrelu(linear(squeezed, self.fc1.weight, self.fc1.bias))
        return torch.sigmoid(linear(h, self.fc2.weight, self.fc2.bias))

    def forward(self, x: torch.Tensor, squeezed: torch.Tensor | None = None) -> torch.Tensor:
        # `squeezed` lets a fused producer hand over the channel means from
        # its per-tile sums, so x is not re-read for the squeeze
        squeezed = global_avg_pool(x) if squeezed is None else squeezed.to(x.dtype)
        return lrelu(self.bn(x * self.gate(squeezed)[:, None, None, :]))


class HANCLayer(nn.Module):
    """HANC aggregation + 1x1 mix, decomposed: the 1x1 kernel is sliced per
    pyramid variant and each pooled branch is mixed at its low resolution
    before the nearest upsample (the reference builds the (2k-1)C-wide
    interleaved stack first; the two agree up to fp reassociation)."""

    def __init__(self, in_chnl: int, out_chnl: int, k: int):
        super().__init__()
        self.k = k
        self.cnv = nn.Conv2d(in_chnl * (2 * k - 1), out_chnl, 1)
        self.bn = BatchNorm(out_chnl)

    def mix_weight(self) -> torch.Tensor:
        """(C, 2k-1, Cout): input channel c*(2k-1)+j is variant j of channel c."""
        o, i = self.cnv.weight.shape[:2]
        return self.cnv.weight.reshape(o, i).t().reshape(i // (2 * self.k - 1), 2 * self.k - 1, o)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.k == 1:
            y = conv1x1(x, self.cnv.weight, self.cnv.bias)
        else:
            # the kernel takes NHWC-contiguous maps; a cuDNN conv upstream
            # may hand back another layout. The weights in x's type, as JAX
            # casts them before its hanc_mix
            y = HancMixFn.apply(x.contiguous(), self.mix_weight().to(x.dtype),
                                self.cnv.bias.to(x.dtype), self.k)
        return lrelu(self.bn(y))


class Conv2dBatchnorm(nn.Module):
    """conv -> BN -> LeakyReLU -> SE (reference Conv2d_batchnorm)."""

    def __init__(self, in_filters: int, num_out_filters: int, kernel_size: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_filters, num_out_filters, kernel_size)
        self.batchnorm = BatchNorm(num_out_filters)
        self.sqe = ChannelSELayer(num_out_filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv2d(x, self.conv1.weight, self.conv1.bias)
        return self.sqe(lrelu(self.batchnorm(x)))


class PendingSE(NamedTuple):
    """A fused HANCBlock's output whose trailing SE apply is left to the next
    fused block: y before the SE, gs = gate * SE-BN scale (B, C) fp32 and
    tb = SE-BN shift (C,) fp32. `apply()` gives the finished map."""

    y: torch.Tensor
    gs: torch.Tensor
    tb: torch.Tensor

    def apply(self) -> torch.Tensor:
        dt = self.y.dtype
        return lrelu(self.y * self.gs[:, None, None, :].to(dt) + self.tb.to(dt))


def _mat(conv: nn.Conv2d) -> torch.Tensor:  # 1x1 conv weight (O, I, 1, 1) -> (I, O)
    return conv.weight.reshape(conv.weight.shape[:2]).t()


class HANCBlock(nn.Module):
    """Inverted bottleneck: 1x1 expand -> depthwise 3x3 -> HANC -> residual BN
    -> 1x1 project -> SE.

    `fused=True` (the level-1/2 blocks of ACCUNet) runs the eval forward as
    the `hanc_block` kernel; `defer_se=True` then returns a `PendingSE` so the
    next fused block applies this block's SE in its kernel prologue.

    `hybrid=True` (JAX's ACCUNET_HYBRID_EXPAND_DW, nn/acc_blocks.py:387-403)
    runs an unfused block's eval front half as the `expand_dw` kernel when
    E >= `hybrid_e_min` (JAX's ACCUNET_HYBRID_E_MIN); the parameters are the
    same either way."""

    def __init__(self, n_filts: int, out_channels: int, k: int = 3, inv_fctr: int = 3,
                 fused: bool = False, defer_se: bool = False, hybrid: bool = False,
                 hybrid_e_min: int = 2048):
        super().__init__()
        e = n_filts * inv_fctr
        self.k, self.fused, self.defer_se = k, fused, defer_se
        self.hybrid, self.hybrid_e_min = hybrid, hybrid_e_min
        self.conv1 = nn.Conv2d(n_filts, e, 1)
        self.norm1 = BatchNorm(e)
        self.conv2 = nn.Conv2d(e, e, 3, padding=1, groups=e)
        self.norm2 = BatchNorm(e)
        self.hnc = HANCLayer(e, n_filts, k)
        self.norm = BatchNorm(n_filts)
        self.conv3 = nn.Conv2d(n_filts, out_channels, 1)
        self.norm3 = BatchNorm(out_channels)
        self.sqe = ChannelSELayer(out_channels)

    def forward(self, inp):
        if self.fused and not self.training:
            return self._forward_fused(inp)
        if isinstance(inp, PendingSE):
            inp = inp.apply()
        if self.takes_hybrid():
            w1, b1, wd, bd, bn1, bn2 = self.expand_dw_args()
            x = ExpandDwFn.apply(inp.contiguous(), w1, b1, wd, bd, *bn1, *bn2)
        else:
            x = self.front_unfused(inp)
        x = self.hnc(x)
        x = self.norm(x + inp)
        x = lrelu(self.norm3(conv1x1(x, self.conv3.weight, self.conv3.bias)))
        return self.sqe(x)

    def takes_hybrid(self) -> bool:
        """Whether the forward runs the front half as the `expand_dw` kernel:
        eval mode, a block off the fused `hanc_block` path, E >= hybrid_e_min
        (the gate of JAX `_hybrid_nhwc_ok` without its TPU tile conditions)."""
        return (self.hybrid and not self.training and not self.fused
                and self.conv2.weight.shape[0] >= self.hybrid_e_min)

    def front_unfused(self, inp: torch.Tensor) -> torch.Tensor:
        """The front half as separate ops: 1x1 expand, BN, lrelu, depthwise
        3x3, BN, lrelu."""
        x = lrelu(self.norm1(conv1x1(inp, self.conv1.weight, self.conv1.bias)))
        return lrelu(self.norm2(depthwise_conv2d(x, self.conv2.weight, self.conv2.bias)))

    def expand_dw_args(self):
        """(w1 (cin,E), b1, wd (3,3,E), bd, bn1, bn2): `expand_dw`'s weights,
        BNs as inference (scale, shift) pairs."""
        return (_mat(self.conv1), self.conv1.bias, self._wd(), self.conv2.bias,
                self.norm1.scale_shift(), self.norm2.scale_shift())

    def _wd(self) -> torch.Tensor:  # (E, 1, 3, 3) -> (3, 3, E)
        e = self.conv2.weight.shape[0]
        return self.conv2.weight.reshape(e, 9).t().reshape(3, 3, e)

    def folded_weights(self) -> HANCBlockWeights:
        return fold(
            _mat(self.conv1), self.conv1.bias, self._wd(), self.conv2.bias,
            self.hnc.mix_weight(), self.hnc.cnv.bias,
            _mat(self.conv3), self.conv3.bias,
            {"norm1": self.norm1.scale_shift(), "norm2": self.norm2.scale_shift(),
             "hnc": self.hnc.bn.scale_shift(), "norm": self.norm.scale_shift(),
             "norm3": self.norm3.scale_shift()},
        )

    def _forward_fused(self, inp):
        pre = None
        if isinstance(inp, PendingSE):
            pre = torch.stack([inp.gs, inp.tb.expand_as(inp.gs)], dim=1).contiguous()
            inp = inp.y
        y, sums = HancBlockFn.apply(inp.contiguous(), pre, self.k, *self.folded_weights())
        squeezed = sums / (y.shape[1] * y.shape[2])
        if not self.defer_se:
            return self.sqe(y, squeezed=squeezed)
        g = self.sqe.gate(squeezed.to(y.dtype))
        s_se, t_se = self.sqe.bn.scale_shift()
        return PendingSE(y, g.float() * s_se, t_se)


class ResPath(nn.Module):
    """n_lvl residual stages (conv3x3 -> BN -> lrelu -> SE, added to x), then
    BN -> lrelu -> BN (the reference's trailing `sqe` is a second BN).

    `fused=True` (rspth1/rspth2 of ACCUNet) runs each eval-mode stage as the
    `respath_level` kernel; the SE gate MLPs stay plain ops off the kernel's
    channel sums."""

    def __init__(self, in_chnls: int, n_lvl: int, fused: bool = False):
        super().__init__()
        self.fused = fused
        self.convs = nn.ModuleList(nn.Conv2d(in_chnls, in_chnls, 3, padding=1) for _ in range(n_lvl))
        self.bns = nn.ModuleList(BatchNorm(in_chnls) for _ in range(n_lvl))
        self.sqes = nn.ModuleList(ChannelSELayer(in_chnls) for _ in range(n_lvl))
        self.bn = BatchNorm(in_chnls)
        self.sqe = BatchNorm(in_chnls)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused and not self.training:
            return self._forward_fused(x)
        for conv, bn, sqe in zip(self.convs, self.bns, self.sqes):
            y = bn(conv2d(x, conv.weight, conv.bias))
            x = x + sqe(lrelu(y))
        return self.sqe(lrelu(self.bn(x)))

    def _forward_fused(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        hw = x.shape[1] * x.shape[2]
        x = x.contiguous()
        y = gate = s_se = t_se = None
        for conv, bn, sqe in zip(self.convs, self.bns, self.sqes):
            s_bn, t_bn = bn.scale_shift()
            w = conv.weight.float().permute(2, 3, 1, 0).contiguous()  # HWIO
            y, x, sums = RespathLevelFn.apply(x, w, s_bn, t_bn + conv.bias.float() * s_bn,
                                              y, gate, s_se, t_se)
            # this level's SE gate, applied by the next level's kernel
            gate = sqe.gate((sums / hw).to(dt)).float()
            s_se, t_se = sqe.bn.scale_shift()
        se = lrelu((y * gate[:, None, None, :].to(dt)) * s_se.to(dt) + t_se.to(dt))
        return self.sqe(lrelu(self.bn(x + se)))


class _MLFCFusedConv(nn.Module):
    """Decomposed MLFC cross-level fusion: the 1x1 conv over the concat of all
    four levels (resampled to this level) is split per source level, and
    sources coarser than this level are mixed at their native resolution
    before the nearest upsample. Conv1 -> BN -> lrelu -> SE."""

    def __init__(self, filts: Sequence[int], lvl: int):
        super().__init__()
        self.filts, self.lvl = list(filts), lvl
        self.conv1 = nn.Conv2d(sum(filts), filts[lvl], 1)
        self.batchnorm = BatchNorm(filts[lvl])
        self.sqe = ChannelSELayer(filts[lvl])

    def forward(self, ins) -> torch.Tensor:
        """`ins[src]`: source src avg-pooled to this level's resolution for
        src <= lvl, at its native resolution for src > lvl."""
        w = self.conv1.weight.reshape(self.conv1.weight.shape[:2]).t()  # (sum, f_lvl)
        y, off = None, 0
        for src, t in enumerate(ins):
            term = t @ w[off:off + self.filts[src]].to(t.dtype)
            off += self.filts[src]
            if src > self.lvl:
                term = upsample_nearest(term, 2 ** (src - self.lvl))
            y = term if y is None else y + term
        y = self.batchnorm(y + self.conv1.bias.to(y.dtype))
        return self.sqe(lrelu(y))


class MLFC(nn.Module):
    """Multi-level feature compilation in three modes: 'full' (cross-level
    fusion), 'lite' (per-level SE only) and 'w' (learned blend
    fused*W + x*(1-W), W initialised to 0)."""

    def __init__(self, in_filters: Sequence[int], lenn: int = 1, mode: str = "full"):
        super().__init__()
        self.filts, self.lenn, self.mode = tuple(in_filters), lenn, mode
        for lvl, f in enumerate(self.filts, start=1):
            setattr(self, f"sqe{lvl}", ChannelSELayer(f))
        if mode == "lite":
            return
        if mode == "w":
            self.W = nn.Parameter(torch.zeros(1))
        for lvl, f in enumerate(self.filts, start=1):
            setattr(self, f"cnv_blks{lvl}",
                    nn.ModuleList(_MLFCFusedConv(self.filts, lvl - 1) for _ in range(lenn)))
            setattr(self, f"bns{lvl}", nn.ModuleList(BatchNorm(f) for _ in range(lenn)))
            setattr(self, f"cnv_mrg{lvl}",
                    nn.ModuleList(Conv2dBatchnorm(2 * f, f) for _ in range(lenn)))
            setattr(self, f"bns_mrg{lvl}", nn.ModuleList(BatchNorm(f) for _ in range(lenn)))

    def forward(self, x1, x2, x3, x4):
        xs = (x1, x2, x3, x4)
        if self.mode != "lite":
            for i in range(self.lenn):
                xs = self._stage(xs, i)
        return tuple(getattr(self, f"sqe{lvl + 1}")(xs[lvl]) for lvl in range(4))

    def _stage(self, xs, i):
        # hierarchical avg-pool pyramid per source, shared by all levels
        pyr = []
        for src in range(4):
            maps = [xs[src]]
            for _ in range(3 - src):
                maps.append(avg_pool2d(maps[-1], 2))
            pyr.append(maps)
        fused = []
        for lvl in range(4):
            ins = [pyr[src][lvl - src] if src <= lvl else xs[src] for src in range(4)]
            y = getattr(self, f"cnv_blks{lvl + 1}")[i](ins)
            fused.append(lrelu(getattr(self, f"bns{lvl + 1}")[i](y)))
        merged = []
        for lvl in range(4):
            y = getattr(self, f"cnv_mrg{lvl + 1}")[i](interleave_channels(fused[lvl], xs[lvl]))
            if self.mode == "w":
                wb = self.W.to(y.dtype)
                y = y * wb + xs[lvl] * (1 - wb)
            else:
                y = y + xs[lvl]
            merged.append(lrelu(getattr(self, f"bns_mrg{lvl + 1}")[i](y)))
        return tuple(merged)
