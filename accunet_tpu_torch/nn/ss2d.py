"""SS2D, the four-direction 2-D selective scan (VMamba), and MedMamba's
SS_Conv_SSM block on NHWC maps: counterpart of accunet_tpu/nn/ss2d.py
(`SS2D`, `channel_shuffle`, `SSConvSSM`).

    SS2D: xs, z = split(in_proj(x)); xs = silu(dw conv 3x3(xs))
        four sequences of xs (B, D, L): row-major, column-major and both
        reversed; each direction k has its own x_proj_weight[k] (dt, B, C),
        dt_projs_weight[k], A_logs[k], Ds[k] and dt_projs_bias[k]:
        y_k = selective_scan(x_k, dt_k, -exp(A_logs[k]), B_k, C_k, Ds[k],
                             delta_bias=dt_projs_bias[k], softplus)
        y = y_0 + flip(y_2) + the column-major y_1 and flip(y_3) back in
            row-major order
        out = out_proj(out_norm(y) * silu(z))
    SSConvSSM: the left half of the channels through BN -> 3x3 conv, BN,
        ReLU -> 3x3 conv, BN, ReLU -> 1x1 conv, ReLU; the right half through
        LayerNorm -> SS2D; concatenated, channel-shuffled in 2 groups, plus x

JAX folds the four directions into one scan call (a vmap); the fused kernel
takes one A (D, N) and one B (B, N, L), so here each direction is one
kernel launch forward and one backward (a launch over all four, with B and
C grouped by direction, is later work: ROADMAP Queue 2); under
`parallel.sequence_sharding` each direction's scan takes the
sequence-parallel route alone, as JAX's unrolled directions do
(accunet_tpu/nn/ss2d.py:97-113). The flips and the column-major order are
copies made before the launch. SS2D computes in its
input's type with the parameters cast at use (the scan itself in fp32, the
norm in fp32), as KNUnet's `dtype` needs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from accunet_tpu_torch.nn.acc_blocks import BatchNorm
from accunet_tpu_torch.nn.ssm import ssm_init
from accunet_tpu_torch.nn.unext_blocks import LayerNorm
from accunet_tpu_torch.ops.conv import conv1x1, conv2d, linear
from accunet_tpu_torch.ops.selective_scan import selective_scan

K_DIRECTIONS = 4


class SS2D(nn.Module):
    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 3, expand: int = 2,
                 dt_rank: int | None = None):
        super().__init__()
        d_inner = expand * d_model
        k = K_DIRECTIONS
        self.d_inner, self.d_state = d_inner, d_state
        self.dt_rank = dt_rank or math.ceil(d_model / 16)
        self.in_proj = nn.Linear(d_model, 2 * d_inner, bias=False)
        self.conv2d = nn.Conv2d(d_inner, d_inner, d_conv, groups=d_inner)
        self.x_proj_weight = nn.Parameter(torch.empty(k, self.dt_rank + 2 * d_state, d_inner))
        self.dt_projs_weight = nn.Parameter(torch.empty(k, d_inner, self.dt_rank))
        self.dt_projs_bias = nn.Parameter(torch.empty(k, d_inner))
        self.A_logs = nn.Parameter(torch.empty(k, d_inner, d_state))
        self.Ds = nn.Parameter(torch.empty(k, d_inner))
        self.out_norm = LayerNorm(d_inner, eps=1e-5)
        self.out_proj = nn.Linear(d_inner, d_model, bias=False)
        self.reset_ssm_parameters()

    @torch.no_grad()
    def reset_ssm_parameters(self) -> None:
        """A_logs = log(1..d_state), Ds = 1, dt_projs_bias = log(expm1(0.01))
        (the JAX initialisers of the deterministic ones)."""
        ssm_init(self, self.d_state, "A_logs", "Ds")
        self.dt_projs_bias.copy_(torch.log(torch.expm1(torch.full_like(self.dt_projs_bias, 0.01))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        d, n, r, l = self.d_inner, self.d_state, self.dt_rank, h * w
        xs, z = linear(x, self.in_proj.weight).split(d, dim=-1)
        xs = F.silu(conv2d(xs, self.conv2d.weight, self.conv2d.bias, groups=d))
        x_hw = xs.permute(0, 3, 1, 2).reshape(b, d, l)  # row-major
        x_wh = xs.permute(0, 3, 2, 1).reshape(b, d, l)  # column-major
        ys = []
        for k, xk in enumerate((x_hw, x_wh, x_hw.flip(-1), x_wh.flip(-1))):
            x_dbl = torch.matmul(self.x_proj_weight[k].to(xk.dtype), xk)  # (B, R+2N, L)
            dts, bs, cs = x_dbl.split([r, n, n], dim=1)
            dts = torch.matmul(self.dt_projs_weight[k].to(dts.dtype), dts)
            ys.append(selective_scan(xk, dts, -torch.exp(self.A_logs[k].float()), bs, cs,
                                     self.Ds[k], delta_bias=self.dt_projs_bias[k],
                                     delta_softplus=True))

        def from_wh(t):
            return t.reshape(b, d, w, h).transpose(2, 3).reshape(b, d, l)

        y = ys[0] + ys[2].flip(-1) + from_wh(ys[1]) + from_wh(ys[3].flip(-1))
        y = self.out_norm(y.transpose(1, 2).reshape(b, h, w, d))
        return linear(y * F.silu(z), self.out_proj.weight)


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    b, h, w, c = x.shape
    return x.reshape(b, h, w, groups, c // groups).transpose(3, 4).reshape(b, h, w, c)


class SSConvSSM(nn.Module):
    """MedMamba's SS_Conv_SSM on (B, H, W, hidden_dim). The conv branch's
    modules keep the reference's Sequential indices (`conv.0` BN, `conv.1`
    conv, `conv.2` BN, `conv.4` conv, `conv.5` BN, `conv.7` 1x1 conv); BN is
    flax's (momentum 0.9, so 0.1 here; eps 1e-5)."""

    def __init__(self, hidden_dim: int, d_state: int = 16):
        super().__init__()
        half = hidden_dim // 2
        self.half = half
        self.ln_1 = nn.LayerNorm(half, eps=1e-6)
        self.self_attention = SS2D(half, d_state)
        self.conv = nn.ModuleDict({
            "0": BatchNorm(half), "1": nn.Conv2d(half, half, 3), "2": BatchNorm(half),
            "4": nn.Conv2d(half, half, 3), "5": BatchNorm(half), "7": nn.Conv2d(half, half, 1)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        left, right = x[..., :self.half], x[..., self.half:]
        r = self.self_attention(self.ln_1(right))
        c = self.conv
        y = c["0"](left)
        y = F.relu(c["2"](conv2d(y, c["1"].weight, c["1"].bias)))
        y = F.relu(c["5"](conv2d(y, c["4"].weight, c["4"].bias)))
        y = F.relu(conv1x1(y, c["7"].weight, c["7"].bias))
        return channel_shuffle(torch.cat([y, r], dim=-1), 2) + x
