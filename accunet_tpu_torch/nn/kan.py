"""KAN (Kolmogorov-Arnold Network) layers, counterpart of accunet_tpu/nn/kan.py
(`jacobi_polynomial`, `FractionalJacobiNeuralBlock`, `b_splines`,
`KANLinear`, `KAN`, `FKANMLP`): the ones the Spatial-Mamba family uses, a
B-spline KANLinear whose base path runs the fractional Jacobi neural block
(degree 3) instead of SiLU.

    KANLinear(x) = act(x) @ base_weight.T
                   + bsplines(x).reshape(batch, in*(G+K)) @ (spline_weight * spline_scaler).T
    act(x) = P_3^(elu(alpha), elu(beta)) of sigmoid(x)^sigmoid(gamma)

with a fixed uniform grid of G = 5 intervals over (-1, 1) extended by K = 3
knots on each side (Cox-de-Boor recursion). Parameter names are the JAX
package's (`base_weight`, `spline_weight`, `spline_scaler`, the block's
`alpha`, `beta`, `gamma`; `layers_0` is `layers.0`), so its tree loads with
`state_dict_from_jax`. `base_activation='silu'` (KNUnet's and U-KAN's
KANLinears) takes silu(x) as the base path, with no parameter. Not ported:
the rational bases (`'rkan'`: `JacobiRKAN`, `'pade'`: `PadeRKAN`), which
only the UNext_CMRF rKAN variants use.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def jacobi_polynomial(x, n: int, alpha, beta, gamma, a: float, b: float):
    """Closed-form Jacobi polynomial P_n^(alpha, beta) of (2x^gamma - a - b) /
    (b - a), degrees 0-3 (the zoo uses degree 3)."""
    t = (2 * x ** gamma - a - b) / (b - a)
    if n == 0:
        return x / (x + 1e-7)
    if n == 1:
        return (alpha - beta + (alpha + beta + 2) * t) / 2
    u = t - 1
    if n == 2:
        return ((alpha + 1) * (alpha + 2) / 2
                + (alpha + 2) * (3 + alpha + beta) * u / 2
                + (3 + alpha + beta) * (4 + alpha + beta) * u ** 2 / 8)
    if n == 3:
        return ((alpha + 1) * (alpha + 2) * (3 + alpha) / 6
                + (alpha + 2) * (3 + alpha) * (4 + alpha + beta) * u / 4
                + (3 + alpha) * (4 + alpha + beta) * (5 + alpha + beta) * u ** 2 / 8
                + (4 + alpha + beta) * (5 + alpha + beta) * (6 + alpha + beta) * u ** 3 / 48)
    raise NotImplementedError(f"jacobi degree {n}")


class FractionalJacobiNeuralBlock(nn.Module):
    """P_degree^(elu(alpha), elu(beta)) of sigmoid(x)^sigmoid(gamma) on [0, 1]."""

    def __init__(self, degree: int = 3):
        super().__init__()
        self.degree = degree
        self.alpha = nn.Parameter(torch.ones(1))
        self.beta = nn.Parameter(torch.ones(1))
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return jacobi_polynomial(torch.sigmoid(x), self.degree, F.elu(self.alpha),
                                 F.elu(self.beta), torch.sigmoid(self.gamma), 0.0, 1.0)


def b_splines(x: torch.Tensor, grid: torch.Tensor, spline_order: int) -> torch.Tensor:
    """Cox-de-Boor B-spline bases. x (batch, in), grid (in, G+2K+1) ->
    (batch, in, G+K)."""
    x = x[..., None]
    bases = ((x >= grid[:, :-1]) & (x < grid[:, 1:])).to(x.dtype)
    for k in range(1, spline_order + 1):
        left = (x - grid[:, :-(k + 1)]) / (grid[:, k:-1] - grid[:, :-(k + 1)])
        right = (grid[:, k + 1:] - x) / (grid[:, k + 1:] - grid[:, 1:-k])
        bases = left * bases[:, :, :-1] + right * bases[:, :, 1:]
    return bases


class KANLinear(nn.Module):
    """x (batch, in) -> (batch, out): the base path (the FJNB block, or SiLU)
    plus the B-spline path."""

    def __init__(self, in_features: int, out_features: int, grid_size: int = 5,
                 spline_order: int = 3, base_activation: str = "fjnb"):
        super().__init__()
        if base_activation in ("rkan", "pade"):
            raise NotImplementedError(f"KANLinear base_activation={base_activation!r}: not "
                                      "ported yet (ROADMAP Queue 1 item 7)")
        if base_activation not in ("fjnb", "silu"):
            raise ValueError(f"KANLinear base_activation={base_activation!r}")
        self.in_features, self.out_features = in_features, out_features
        self.grid_size, self.spline_order = grid_size, spline_order
        h = 2.0 / grid_size  # the grid spans (-1, 1)
        knots = torch.arange(-spline_order, grid_size + spline_order + 1, dtype=torch.float32)
        grid = knots * h - 1
        self.register_buffer("grid", grid.expand(in_features, -1).contiguous(), persistent=False)
        self.base_weight = nn.Parameter(torch.empty(out_features, in_features))
        self.spline_weight = nn.Parameter(
            torch.empty(out_features, in_features, grid_size + spline_order))
        self.spline_scaler = nn.Parameter(torch.empty(out_features, in_features))
        self.base_activation = FractionalJacobiNeuralBlock(3) if base_activation == "fjnb" \
            else F.silu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        base = self.base_activation(xf) @ self.base_weight.T
        bases = b_splines(xf, self.grid, self.spline_order)
        scaled = self.spline_weight * self.spline_scaler[..., None]
        spline = bases.reshape(x.shape[0], -1) @ scaled.reshape(self.out_features, -1).T
        return (base + spline).to(x.dtype)


class KAN(nn.Module):
    """KANLinear layers in sequence over flattened feature vectors."""

    def __init__(self, layers_hidden: Sequence[int]):
        super().__init__()
        dims = list(layers_hidden)
        self.layers = nn.ModuleList(KANLinear(i, o) for i, o in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class FKANMLP(nn.Module):
    """LayerNorm -> KAN([dim, mlp_dim, dim]) over tokens (B, N, C)."""

    def __init__(self, dim: int, mlp_dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.kan = KAN((dim, mlp_dim, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        return self.kan(self.norm(x).reshape(b * n, c)).reshape(b, n, c)
