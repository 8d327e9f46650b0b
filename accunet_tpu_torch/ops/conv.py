"""Convolution primitives on NHWC tensors with torch-layout weights.

Counterpart of accunet_tpu/ops/conv.py. Weights keep PyTorch's layouts
(Conv2d OIHW, ConvTranspose2d (I, O, kh, kw)) so reference checkpoints load
unchanged; activations stay NHWC. Every op computes in its input's type and
casts the weights to it at use (fp32 parameters under a bf16 input).
`F.conv2d` runs on the channels_last NCHW view of an NHWC tensor, so no data
moves around the call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from accunet_tpu_torch.ops.kernels.dwconv2d import DepthwiseConv2dFn


def _same_pad(k: int) -> tuple[int, int]:
    # torch padding='same': odd kernels pad symmetrically, even kernels put
    # the extra row/column after (the same split as the JAX package)
    lo = (k - 1) // 2
    return lo, k - 1 - lo


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
           groups: int = 1) -> torch.Tensor:
    """Stride-1 'SAME' convolution. x (B,H,W,Cin), weight (Cout,Cin/g,kh,kw)."""
    kh, kw = weight.shape[2], weight.shape[3]
    (t, b_), (l, r) = _same_pad(kh), _same_pad(kw)
    xc = x.permute(0, 3, 1, 2)
    if (t, l) == (b_, r):
        y = F.conv2d(xc, weight.to(x.dtype), None, padding=(t, l), groups=groups)
    else:
        y = F.conv2d(F.pad(xc, (l, r, t, b_)), weight.to(x.dtype), None, groups=groups)
    y = y.permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def conv2d_strided(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
                   stride=1, padding=0, groups: int = 1, dilation=1) -> torch.Tensor:
    """nn.Conv2d(stride, padding, groups, dilation) on NHWC, its weight and
    bias cast to x's type: symmetric zero padding, so a patchify conv
    (kernel = stride, padding 0) is flax's VALID one."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype),
                 None if bias is None else bias.to(x.dtype), stride, padding, dilation, groups)
    return y.permute(0, 2, 3, 1)


def patchify(x: torch.Tensor, weight: torch.Tensor,
             bias: torch.Tensor | None = None) -> torch.Tensor:
    """A patch embedding: nn.Conv2d with stride = kernel p and no padding on
    NHWC (flax's VALID; rows and columns past the last whole patch drop), as
    one product of each patch's (kh, kw, c) vector with the weight. torch's
    CPU (oneDNN) bf16 convolution returns wrong values for narrow ones (8
    channels, 8x8 or 16x16 patches: errors the size of the output); the
    product has no such case."""
    b, h, w, c = x.shape
    o, _, p, _ = weight.shape
    hp, wp = h // p, w // p
    x = x[:, :hp * p, :wp * p].reshape(b, hp, p, wp, p, c).transpose(2, 3)
    return linear(x.reshape(b, hp, wp, p * p * c), weight.permute(0, 2, 3, 1).reshape(o, -1),
                  bias)


def depthwise_conv1d(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise 'SAME' convolution over the last axis of x (B, C, L).
    weight (C, 1, k) (nn.Conv1d's layout)."""
    lo, hi = _same_pad(weight.shape[-1])
    return F.conv1d(F.pad(x, (lo, hi)), weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype), groups=weight.shape[0])


def depthwise_conv2d(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise 'SAME' convolution, odd kernels. weight (C, 1, kh, kw). Its
    weight gradient is the `dwconv2d_wgrad` kernel (ops/kernels/dwconv2d)."""
    return DepthwiseConv2dFn.apply(x, weight, bias)


def dilated_depthwise_conv2d(x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor | None = None,
                             dilation: int = 1) -> torch.Tensor:
    """Depthwise 'SAME' convolution with an odd k x k kernel dilated by
    `dilation` (padding dilation * (k // 2)): nn.Conv2d(dilation=,
    groups=C) on NHWC; weight (C, 1, k, k). It refuses a bf16 weight
    gradient on the CPU at dilation > 1: torch 2.13's is wrong (off by more
    than the gradient's size at dilation 2 on a 32x32 map, ~1e36 at 5),
    while its bf16 forward and input gradient, its fp32 weight gradient and
    CUDA's bf16 one are right."""
    if (dilation > 1 and x.device.type == "cpu" and x.dtype == torch.bfloat16
            and torch.is_grad_enabled() and weight.requires_grad):
        raise NotImplementedError(
            "the weight gradient of a dilated bf16 depthwise conv on the CPU (torch's is wrong): "
            "train in float32 on the CPU, or in bfloat16 on the card")
    k = weight.shape[-1]
    return conv2d_strided(x, weight, bias, 1, dilation * (k // 2), x.shape[-1], dilation)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """nn.Linear's product over the last axis, in x's type: weight (out, in)
    and bias cast at use, as flax's Dense(dtype=...) does."""
    return F.linear(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


def conv1x1(x: torch.Tensor, weight: torch.Tensor,
            bias: torch.Tensor | None = None) -> torch.Tensor:
    """1x1 convolution as a matmul over the channel axis. weight (Cout,Cin,1,1)."""
    w = weight.reshape(weight.shape[0], weight.shape[1]).to(x.dtype)
    return F.linear(x, w, None if bias is None else bias.to(x.dtype))


def conv_transpose_2x2(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor | None = None) -> torch.Tensor:
    """torch.nn.ConvTranspose2d(Cin, Cout, kernel_size=2, stride=2) on NHWC.

    out[b, 2i+ki, 2j+kj, o] = sum_c x[b,i,j,c] * weight[c,o,ki,kj] (+ bias):
    a k == s transposed conv has no window overlap, so it is one matmul to
    (kh*kw*Cout) followed by depth-to-space."""
    b, h, w, cin = x.shape
    _, cout, kh, kw = weight.shape
    wmat = weight.to(x.dtype).permute(0, 2, 3, 1).reshape(cin, kh * kw * cout)
    y = (x.reshape(b * h * w, cin) @ wmat).reshape(b, h, w, kh, kw, cout)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, h * kh, w * kw, cout)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
