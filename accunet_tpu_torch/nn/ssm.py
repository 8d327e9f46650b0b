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
`state_dict_from_jax`. Not ported yet: MambaVisionMixer, StructureAwareSSM,
StateFusion, SpatialMambaBlock, KANFFN.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from accunet_tpu_torch.ops.selective_scan import selective_scan


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
