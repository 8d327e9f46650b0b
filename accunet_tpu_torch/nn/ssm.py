"""State-space (Mamba) mixers, counterpart of accunet_tpu/nn/ssm.py. Ported
so far: `BiMamba`, the mamba_ssm `Mamba` block with bimamba_type="v2" that
the SegMamba baseline instantiates (d_state 16, d_conv 4, expand 2).

    xz = in_proj(x)                                # (B, L, 2*d_inner), no bias
    forward branch: x, z = split(xz); x = silu(causal depthwise conv1d(x));
                    (dt, B, C) = x_proj(x); dt = dt @ dt_proj.weight.T;
                    y = selective_scan(x, dt, -exp(A_log), B, C, D, z=z,
                                       delta_bias=dt_proj.bias, softplus)
    backward branch: the same on time-flipped xz with the *_b parameter set
                    (conv1d_b, x_proj_b, dt_proj_b, A_b_log, D_b), flipped back
    out = out_proj(y_fwd + y_bwd)                  # / 2 with if_devide_out

dt_proj is applied without its bias, which enters once as delta_bias (the
fused CUDA path of mamba_ssm). Parameter names are the mamba_ssm fork's
(tests/test_bimamba_parity.py), so the JAX tree maps onto them with
`state_dict_from_jax`.

Spatial-Mamba (`StateFusion`, `StructureAwareSSM`, `SpatialMambaMLP`,
`SpatialMambaBlock`, `KANFFN`) on NHWC maps:

    StructureAwareSSM: xs, z = split(in_proj(x)); xs = silu(dw conv 3x3(xs))
        (dt, B, C) = x_proj_weight @ xs; dt = dt_projs_weight @ dt
        h = selective_scan_rh(xs, dt, -exp(A_logs), B, dt_projs_bias, softplus)
        h as the NHWC map of D*N channels -> StateFusion -> mean over N
        y = out_norm(hmean * C + xs * Ds) * silu(z) -> out_proj
    StateFusion: alpha-weighted sum of three depthwise 3x3 convs at
        dilations 1, 3, 5 with replicate (edge) padding
    SpatialMambaBlock: x += cpe1(x); x += SSM(ln_1(x)); x += cpe2(x);
        x += mlp(ln_2(x)) (an exact-GELU MLP, or KANFFN)

The return-hidden scan writes h as (B, L, D, N), which is the NHWC map
itself, so the fusion takes it without a copy. The depthwise convs are
cuDNN's grouped convs, as JAX's are XLA's (`nn.Conv`).

`MambaVisionMixer`, the hybrid TransformerMambaBlock's mixer, on tokens
(B, L, C), with dh = expand * C / 2:

    xs, z = split(in_proj(x))                     # (B, L, dh) each, no bias
    xs = silu(conv1d_x(xs)); z = silu(conv1d_z(z)) # 'same' depthwise, no bias
    (dt, B, C) = x_proj(xs); dt = dt @ dt_proj.weight.T + dt_proj.bias
    y = selective_scan(xs, dt, -exp(A_log), B, C, D, z=None,
                       delta_bias=dt_proj.bias, softplus)   # d_state 8
    [y = SpatialStateFusion(y as the (B, H, W, dh) map)]
    out = out_proj(concat(y, z))

dt_proj's bias enters twice, in the product and as delta_bias, as the
reference (and JAX) do. `SpatialStateFusion` pads with zeros, unlike
StateFusion's replicate padding.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from accunet_tpu_torch.nn.kan import KAN
from accunet_tpu_torch.ops.conv import conv2d, depthwise_conv1d
from accunet_tpu_torch.ops.selective_scan import selective_scan, selective_scan_rh


class BiMamba(nn.Module):
    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4, expand: int = 2,
                 if_devide_out: bool = False):
        super().__init__()
        d_inner = expand * d_model
        self.d_inner, self.d_state, self.d_conv = d_inner, d_state, d_conv
        self.dt_rank = math.ceil(d_model / 16)
        self.if_devide_out = if_devide_out
        self.in_proj = nn.Linear(d_model, 2 * d_inner, bias=False)
        for sfx in ("", "_b"):
            setattr(self, f"conv1d{sfx}", nn.Conv1d(d_inner, d_inner, d_conv, groups=d_inner,
                                                    padding=d_conv - 1, bias=True))
            setattr(self, f"x_proj{sfx}",
                    nn.Linear(d_inner, self.dt_rank + 2 * d_state, bias=False))
            setattr(self, f"dt_proj{sfx}", nn.Linear(self.dt_rank, d_inner, bias=True))
        self.A_log = nn.Parameter(torch.empty(d_inner, d_state))
        self.A_b_log = nn.Parameter(torch.empty(d_inner, d_state))
        self.D = nn.Parameter(torch.empty(d_inner))
        self.D_b = nn.Parameter(torch.empty(d_inner))
        self.out_proj = nn.Linear(d_inner, d_model, bias=False)
        self.reset_ssm_parameters()

    @torch.no_grad()
    def reset_ssm_parameters(self) -> None:
        """A_log = log(1..d_state) on every row, D = 1 (the JAX initialisers)."""
        a = torch.log(torch.arange(1, self.d_state + 1, dtype=torch.float32))
        for name in ("A_log", "A_b_log"):
            getattr(self, name).copy_(a.expand(self.d_inner, -1))
        self.D.fill_(1.0)
        self.D_b.fill_(1.0)

    def _branch(self, xz: torch.Tensor, sfx: str) -> torch.Tensor:
        """xz (B, L, 2*d_inner) -> y (B, d_inner, L)."""
        l = xz.shape[1]
        xs, z = xz[..., :self.d_inner], xz[..., self.d_inner:]
        # Conv1d(padding=d_conv-1) cut to the first L outputs: causal
        xs = F.silu(getattr(self, f"conv1d{sfx}")(xs.transpose(1, 2))[..., :l])  # (B, d_inner, L)
        x_dbl = getattr(self, f"x_proj{sfx}")(xs.transpose(1, 2))
        dt, bmat, cmat = torch.split(x_dbl, [self.dt_rank, self.d_state, self.d_state], dim=-1)
        dt_proj = getattr(self, f"dt_proj{sfx}")
        dt = F.linear(dt, dt_proj.weight)  # without its bias
        a_log = self.A_log if not sfx else self.A_b_log
        return selective_scan(
            xs, dt.transpose(1, 2), -torch.exp(a_log.float()), bmat.transpose(1, 2),
            cmat.transpose(1, 2), getattr(self, f"D{sfx}"), z=z.transpose(1, 2),
            delta_bias=dt_proj.bias, delta_softplus=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, L, d_model) -> (B, L, d_model)."""
        xz = self.in_proj(x)
        y_f = self._branch(xz, "")
        y_b = self._branch(xz.flip(1), "_b").flip(-1)
        y = (y_f + y_b).transpose(1, 2)
        if self.if_devide_out:
            y = y / 2
        return self.out_proj(y)


def ssm_init(module: nn.Module, d_state: int, a_name: str, d_name: str) -> None:
    """A_log = log(1..d_state) on every row, D = 1, for parameters of any
    leading shape (the JAX initialisers)."""
    a = torch.log(torch.arange(1, d_state + 1, dtype=torch.float32))
    getattr(module, a_name).copy_(a.expand_as(getattr(module, a_name)))
    getattr(module, d_name).fill_(1.0)


class SpatialStateFusion(nn.Module):
    """y (B, H, W, D) -> the alpha-weighted sum of depthwise 3x3 convs (with
    bias) at dilations 1, 3 and 5, each zero-padded to keep the map."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.dw1 = nn.Conv2d(dim, dim, 3, groups=dim)
        self.dw3 = nn.Conv2d(dim, dim, 3, groups=dim)
        self.dw5 = nn.Conv2d(dim, dim, 3, groups=dim)
        self.alpha = nn.Parameter(torch.ones(3))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        x = y.permute(0, 3, 1, 2)
        a = self.alpha.to(y.dtype)
        out = 0
        for i, (conv, dil) in enumerate(((self.dw1, 1), (self.dw3, 3), (self.dw5, 5))):
            out = out + a[i] * F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                                        padding=dil, dilation=dil, groups=self.dim)
        return out.permute(0, 2, 3, 1)


class MambaVisionMixer(nn.Module):
    def __init__(self, d_model: int, d_state: int = 8, d_conv: int = 3, expand: int = 1,
                 dt_rank: int | None = None, spatial_fusion: bool = False):
        super().__init__()
        d_inner = expand * d_model
        dh = d_inner // 2
        self.dh, self.d_state = dh, d_state
        self.dt_rank = dt_rank or math.ceil(d_model / 16)
        self.in_proj = nn.Linear(d_model, d_inner, bias=False)
        self.A_log = nn.Parameter(torch.empty(dh, d_state))
        self.D = nn.Parameter(torch.empty(dh))
        # the reference's conv1d bias is off (its conv_bias // 2 quirk)
        self.conv1d_x = nn.Conv1d(dh, dh, d_conv, groups=dh, bias=False)
        self.conv1d_z = nn.Conv1d(dh, dh, d_conv, groups=dh, bias=False)
        self.x_proj = nn.Linear(dh, self.dt_rank + 2 * d_state, bias=False)
        self.dt_proj = nn.Linear(self.dt_rank, dh)
        self.spatial_fusion_mod = SpatialStateFusion(dh) if spatial_fusion else None
        self.out_proj = nn.Linear(d_inner, d_model, bias=False)
        self.reset_ssm_parameters()

    @torch.no_grad()
    def reset_ssm_parameters(self) -> None:
        ssm_init(self, self.d_state, "A_log", "D")

    def forward(self, x: torch.Tensor, spatial_hw: tuple[int, int] | None = None) -> torch.Tensor:
        """x (B, L, C) -> (B, L, C); spatial_hw (H, W) with H * W = L shapes
        the scan output's map for the fusion (default square)."""
        b, l, _ = x.shape
        dh, n = self.dh, self.d_state
        xs, z = self.in_proj(x).split(dh, dim=-1)
        xs = F.silu(depthwise_conv1d(xs.transpose(1, 2), self.conv1d_x.weight))  # (B, dh, L)
        z = F.silu(depthwise_conv1d(z.transpose(1, 2), self.conv1d_z.weight))
        dt, bmat, cmat = self.x_proj(xs.transpose(1, 2)).split([self.dt_rank, n, n], dim=-1)
        dt = F.linear(dt, self.dt_proj.weight.to(dt.dtype), self.dt_proj.bias.to(dt.dtype))
        y = selective_scan(xs, dt.transpose(1, 2), -torch.exp(self.A_log.float()),
                           bmat.transpose(1, 2), cmat.transpose(1, 2), self.D,
                           delta_bias=self.dt_proj.bias, delta_softplus=True)
        if self.spatial_fusion_mod is not None:
            hh, ww = spatial_hw or (round(l ** 0.5),) * 2
            ymap = self.spatial_fusion_mod(y.transpose(1, 2).reshape(b, hh, ww, dh))
            y = ymap.reshape(b, l, dh).transpose(1, 2)
        return self.out_proj(torch.cat([y, z], dim=1).transpose(1, 2))


class StateFusion(nn.Module):
    """h (B, H, W, D) -> the alpha-weighted sum of depthwise 3x3 convs at
    dilations 1, 3 and 5, each on the map padded by replication."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.kernel_3 = nn.Parameter(torch.ones(dim, 1, 3, 3))
        self.kernel_3_1 = nn.Parameter(torch.ones(dim, 1, 3, 3))
        self.kernel_3_2 = nn.Parameter(torch.ones(dim, 1, 3, 3))
        self.alpha = nn.Parameter(torch.ones(3))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        x = h.permute(0, 3, 1, 2)  # the channels_last NCHW view

        def dconv(kernel, dil):
            xp = F.pad(x, (dil,) * 4, mode="replicate")
            return F.conv2d(xp, kernel.to(x.dtype), dilation=dil, groups=self.dim)

        a = self.alpha.to(h.dtype)
        y = (a[0] * dconv(self.kernel_3, 1) + a[1] * dconv(self.kernel_3_1, 3)
             + a[2] * dconv(self.kernel_3_2, 5))
        return y.permute(0, 2, 3, 1)


class StructureAwareSSM(nn.Module):
    """Spatial-Mamba's SSM on x (B, H, W, C) -> (B, H, W, C)."""

    def __init__(self, d_model: int, d_state: int = 16):
        super().__init__()
        # JAX's defaults: expand 2, a 3x3 depthwise conv, dt_rank ceil(C / 16)
        d_inner = 2 * d_model
        self.d_inner, self.d_state = d_inner, d_state
        self.dt_rank = math.ceil(d_model / 16)
        self.in_proj = nn.Linear(d_model, 2 * d_inner, bias=False)
        self.conv2d = nn.Conv2d(d_inner, d_inner, 3, groups=d_inner, bias=True)
        self.x_proj_weight = nn.Parameter(torch.empty(self.dt_rank + d_state + d_inner, d_inner))
        self.dt_projs_weight = nn.Parameter(torch.empty(d_inner, self.dt_rank))
        self.dt_projs_bias = nn.Parameter(torch.empty(d_inner))
        self.A_logs = nn.Parameter(torch.empty(d_inner, d_state))
        self.Ds = nn.Parameter(torch.empty(d_inner))
        self.state_fusion = StateFusion(d_inner * d_state)
        self.out_norm = nn.LayerNorm(d_inner, eps=1e-5)
        self.out_proj = nn.Linear(d_inner, d_model, bias=False)
        self.reset_ssm_parameters()

    @torch.no_grad()
    def reset_ssm_parameters(self) -> None:
        """A_logs = log(1..d_state) on every row, Ds = 1, dt_projs_bias =
        log(expm1(0.01)) (the JAX initialisers of the deterministic ones)."""
        a = torch.log(torch.arange(1, self.d_state + 1, dtype=torch.float32))
        self.A_logs.copy_(a.expand(self.d_inner, -1))
        self.Ds.fill_(1.0)
        self.dt_projs_bias.copy_(torch.log(torch.expm1(torch.full((self.d_inner,), 0.01))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, _ = x.shape
        d, n, l = self.d_inner, self.d_state, hh * ww
        xs, z = self.in_proj(x).split(d, dim=-1)
        xs = F.silu(conv2d(xs, self.conv2d.weight, self.conv2d.bias, groups=d))
        xs_bdl = xs.permute(0, 3, 1, 2).reshape(b, d, l)  # (B, D, L)
        x_dbl = torch.matmul(self.x_proj_weight.to(xs.dtype), xs_bdl)
        dts, bs, cs = x_dbl.split([self.dt_rank, n, d], dim=1)
        dts = torch.matmul(self.dt_projs_weight.to(dts.dtype), dts)
        h = selective_scan_rh(xs_bdl, dts, -torch.exp(self.A_logs.float()), bs,
                              delta_bias=self.dt_projs_bias, delta_softplus=True)  # (B, D, N, L)
        hm = h.reshape(b, d * n, l).transpose(1, 2).reshape(b, hh, ww, d * n)
        hm = self.state_fusion(hm.to(x.dtype))
        hmean = hm.reshape(b, l, d, n).mean(dim=-1).transpose(1, 2)  # (B, D, L)
        y = hmean * cs + xs_bdl * self.Ds.to(xs.dtype)[:, None]
        y = self.out_norm(y.transpose(1, 2).reshape(b, hh, ww, d))
        return self.out_proj(y * F.silu(z))


class SpatialMambaMLP(nn.Module):
    """fc1 -> exact GELU -> fc2."""

    def __init__(self, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(out, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class KANFFN(nn.Module):
    """LayerNorm + KAN([c, 4c, c]) over the tokens of (B, H, W, C)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.kan = KAN((dim, 4 * dim, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        return self.kan(self.norm(x).reshape(b * h * w, c)).reshape(b, h, w, c)


class SpatialMambaBlock(nn.Module):
    """x (B, H, W, C): conv position encodings, the SSM and the MLP of 4C
    hidden features (or, with mlp_type="kan", KANFFN after ln_2: a double
    norm, as in JAX), each with a residual."""

    def __init__(self, hidden_dim: int, d_state: int = 16, mlp_type: str = "mlp"):
        super().__init__()
        c = hidden_dim
        self.cpe1 = nn.Conv2d(c, c, 3, groups=c)
        self.ln_1 = nn.LayerNorm(c, eps=1e-6)
        self.self_attention = StructureAwareSSM(c, d_state=d_state)
        self.cpe2 = nn.Conv2d(c, c, 3, groups=c)
        self.ln_2 = nn.LayerNorm(c, eps=1e-6)
        if mlp_type == "kan":
            self.mlp = KANFFN(c)
        elif mlp_type == "mlp":
            self.mlp = SpatialMambaMLP(4 * c, c)
        else:
            raise ValueError(f"mlp_type {mlp_type!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        x = x + conv2d(x, self.cpe1.weight, self.cpe1.bias, groups=c)
        x = x + self.self_attention(self.ln_1(x))
        x = x + conv2d(x, self.cpe2.weight, self.cpe2.bias, groups=c)
        return x + self.mlp(self.ln_2(x))
