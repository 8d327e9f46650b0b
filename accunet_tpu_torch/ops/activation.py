"""Activations shared by the blocks and the kernels' plain versions."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def lrelu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.01). Value-identical to the max(x, 0.01x) form that the
    JAX package and the CUDA kernels compute."""
    return F.leaky_relu(x, 0.01)
