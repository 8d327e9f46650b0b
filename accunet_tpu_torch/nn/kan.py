"""KAN (Kolmogorov-Arnold Network) layers, counterpart of accunet_tpu/nn/kan.py
(`jacobi_polynomial`, `rational_jacobi_polynomial`, `JacobiRKAN`,
`PadeRKAN`, `FractionalJacobiNeuralBlock`, `b_splines`, `KANLinear`, `KAN`,
`FKANMLP`): a B-spline KANLinear whose base path runs the fractional Jacobi
neural block (degree 3; the Spatial-Mamba family's) instead of SiLU.

    KANLinear(x) = act(x) @ base_weight.T
                   + bsplines(x).reshape(batch, in*(G+K)) @ (spline_weight * spline_scaler).T
    act(x) = P_3^(elu(alpha), elu(beta)) of sigmoid(x)^sigmoid(gamma)

with a fixed uniform grid of G = 5 intervals over (-1, 1) extended by K = 3
knots on each side (Cox-de-Boor recursion). Parameter names are the JAX
package's (`base_weight`, `spline_weight`, `spline_scaler`, the block's
`alpha`, `beta`, `gamma`; `layers_0` is `layers.0`), so its tree loads with
`state_dict_from_jax`. `base_activation='silu'` (KNUnet's and U-KAN's
KANLinears) takes silu(x) as the base path, with no parameter; the rational
bases `'rkan'` (`JacobiRKAN`: P_3^(elu(alpha), elu(beta)) of x / sqrt(x^2 +
softplus(iota)^2) - 1; UNext_CMRF_GS_Wavelet_rKAN's token blocks) and
`'pade'` (`PadeRKAN`: a [2/6] ratio of shifted Jacobi polynomials of
sigmoid(x)) keep their parameters under `base_activation`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

JACOBI_DEGREE = 3  # JacobiRKAN's degree
PADE_DEGREES = (2, 6)  # PadeRKAN's [p/q]: the numerator's and denominator's weight counts


def jacobi_polynomial(x, n: int, alpha, beta, gamma, a: float, b: float):
    """Closed-form Jacobi polynomial P_n^(alpha, beta) of (2x^gamma - a - b) /
    (b - a), degrees 0-5 (the fJNB uses degree 3, PadeRKAN's denominator
    2-5)."""
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
    ab = alpha + beta
    if n == 4:
        return ((alpha + 1) * (alpha + 2) * (3 + alpha) * (4 + alpha) / 24
                + (alpha + 2) * (3 + alpha) * (4 + alpha) * (5 + ab) * u / 12
                + (3 + alpha) * (4 + alpha) * (5 + ab) * (6 + ab) * u ** 2 / 16
                + (4 + alpha) * (5 + ab) * (6 + ab) * (7 + ab) * u ** 3 / 48
                + (5 + ab) * (6 + ab) * (7 + ab) * (8 + ab) * u ** 4 / 384)
    if n == 5:
        return ((alpha + 1) * (alpha + 2) * (alpha + 3) * (alpha + 4) * (alpha + 5) / 120
                + (alpha + 2) * (alpha + 3) * (alpha + 4) * (alpha + 5) * (6 + ab) * u / 48
                + (alpha + 3) * (alpha + 4) * (alpha + 5) * (6 + ab) * (7 + ab) * u ** 2 / 48
                + (alpha + 4) * (alpha + 5) * (6 + ab) * (7 + ab) * (8 + ab) * u ** 3 / 96
                + (alpha + 5) * (6 + ab) * (7 + ab) * (8 + ab) * (9 + ab) * u ** 4 / 384
                + (6 + ab) * (7 + ab) * (8 + ab) * (9 + ab) * (10 + ab) * u ** 5 / 3840)
    raise NotImplementedError(f"jacobi degree {n}")


def rational_jacobi_polynomial(x, n: int, alpha, beta, zeta, iota):
    """Rational Jacobi polynomial P_n^(alpha, beta) of x^zeta / sqrt(x^(2 zeta)
    + iota^2) - 1, degrees 1-3."""
    u = x ** zeta / torch.sqrt(x ** (2 * zeta) + iota ** 2) - 1
    if n == 1:
        return (alpha - beta + (alpha + beta + 2) * u) / 2
    if n == 2:
        return ((alpha + 1) * (alpha + 2) / 2
                + (alpha + 2) * (3 + alpha + beta) * u / 2
                + (3 + alpha + beta) * (4 + alpha + beta) * u ** 2 / 8)
    if n == 3:
        return ((alpha + 1) * (alpha + 2) * (3 + alpha) / 6
                + (alpha + 2) * (3 + alpha) * (4 + alpha + beta) * u / 4
                + (3 + alpha) * (4 + alpha + beta) * (5 + alpha + beta) * u ** 2 / 8
                + (4 + alpha + beta) * (5 + alpha + beta) * (6 + alpha + beta) * u ** 3 / 48)
    raise NotImplementedError(f"rational jacobi degree {n}")


class JacobiRKAN(nn.Module):
    """The rational Jacobi activation: P_3^(elu(alpha), elu(beta)) with
    zeta 1 and iota softplus(iota)."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1))
        self.beta = nn.Parameter(torch.ones(1))
        self.iota = nn.Parameter(torch.ones(1))

    @torch.no_grad()
    def reset_parameters(self) -> None:
        for p in (self.alpha, self.beta, self.iota):
            p.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rational_jacobi_polynomial(x, JACOBI_DEGREE, F.elu(self.alpha), F.elu(self.beta),
                                          1.0, F.softplus(self.iota))


class PadeRKAN(nn.Module):
    """The Pade [2/6] rational of shifted Jacobi polynomials of sigmoid(x):
    each side w[0] + w[1] s + sum_{d >= 2} w[d] P_d^(elu(a), elu(b)) of
    s^sigmoid(zeta) on [0, 1]."""

    def __init__(self):
        super().__init__()
        for side, degree in zip("pq", PADE_DEGREES):
            setattr(self, f"alpha_{side}", nn.Parameter(torch.ones(1)))
            setattr(self, f"beta_{side}", nn.Parameter(torch.ones(1)))
            setattr(self, f"zeta_{side}", nn.Parameter(torch.zeros(1)))
            setattr(self, f"w_{side}", nn.Parameter(torch.ones(degree)))

    @torch.no_grad()
    def reset_parameters(self) -> None:
        for name, p in self.named_parameters():
            p.fill_(0.0 if name.startswith("zeta") else 1.0)

    def _poly(self, s: torch.Tensor, side: str) -> torch.Tensor:
        w = getattr(self, f"w_{side}")
        a, b = F.elu(getattr(self, f"alpha_{side}")), F.elu(getattr(self, f"beta_{side}"))
        z = torch.sigmoid(getattr(self, f"zeta_{side}"))
        out = w[0] + w[1] * s
        for deg in range(2, w.numel()):
            out = out + w[deg] * jacobi_polynomial(s, deg, a, b, z, 0.0, 1.0)
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.sigmoid(x)
        return self._poly(s, "p") / self._poly(s, "q")


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
    """x (batch, in) -> (batch, out): the base path (the FJNB block, SiLU or a
    rational base) plus the B-spline path."""

    def __init__(self, in_features: int, out_features: int, grid_size: int = 5,
                 spline_order: int = 3, base_activation: str = "fjnb"):
        super().__init__()
        activations = {"fjnb": lambda: FractionalJacobiNeuralBlock(3), "silu": lambda: F.silu,
                       "rkan": JacobiRKAN, "pade": PadeRKAN}
        if base_activation not in activations:
            raise ValueError(f"KANLinear base_activation={base_activation!r}")
        self.in_features, self.out_features = in_features, out_features
        self.grid_size, self.spline_order = grid_size, spline_order
        self.register_buffer("grid", self._grid(), persistent=False)
        self.base_weight = nn.Parameter(torch.empty(out_features, in_features))
        self.spline_weight = nn.Parameter(
            torch.empty(out_features, in_features, grid_size + spline_order))
        self.spline_scaler = nn.Parameter(torch.empty(out_features, in_features))
        self.base_activation = activations[base_activation]()

    def _grid(self, device=None) -> torch.Tensor:
        """The fp32 knots (in, G + 2K + 1): G intervals over (-1, 1), K more
        on each side."""
        k, g = self.spline_order, self.grid_size
        knots = torch.arange(-k, g + k + 1, dtype=torch.float32, device=device) * (2.0 / g) - 1
        return knots.expand(self.in_features, -1).contiguous()

    def _apply(self, fn, recurse=True):
        # the knots stay fp32 whatever the module is cast to (a bf16 cast
        # would round them); they move with the module's device
        super()._apply(fn, recurse)
        self.grid = self._grid(self.base_weight.device)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x rounded to fp32 whatever its type, as JAX's, then computed in
        # fp32 (float64 with float64 parameters, as JAX promotes)
        ct = torch.promote_types(self.base_weight.dtype, torch.float32)
        xf = x.float().to(ct)
        grid = self.grid.to(ct)
        base = self.base_activation(xf) @ self.base_weight.to(ct).T
        bases = b_splines(xf, grid, self.spline_order)
        scaled = self.spline_weight.to(ct) * self.spline_scaler.to(ct)[..., None]
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
