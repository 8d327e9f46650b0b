"""accunet_tpu_torch — the PyTorch + CUDA port of accunet_tpu.

The JAX package `accunet_tpu` stays the reference; this package mirrors its
module names and its public NHWC layout so every counterpart can be held
against it. It imports torch, numpy and scipy only.

The hand-written Hopper kernels (`csrc/*.cu`) are compiled with nvcc at their
first launch (`ops/kernels/_build.py`); importing the package builds and loads
nothing.
"""

__version__ = "0.1.0"
