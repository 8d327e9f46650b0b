"""ctypes bindings of the native data ops (data/native/dataops.cpp),
counterpart of accunet_tpu/data/native_loader.py.

`library()` builds the source with g++ at its first call into the
git-ignored build directory of the CUDA kernels (`build/accunet_tpu_torch/`,
ops/kernels/_build.py), under a name carrying a hash of the source and the
flags, and loads it; it returns None when the build fails, after logging
the compiler's message once at WARNING, and the dataset then runs its numpy
path. The ops take and return numpy arrays.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "dataops.cpp"
# no -march=native: the library may be built on one host and loaded on another
FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"]

logger = logging.getLogger("accunet_tpu_torch")

_F = ctypes.POINTER(ctypes.c_float)
_D = ctypes.POINTER(ctypes.c_double)
_I, _L = ctypes.c_int, ctypes.c_long
SIGNATURES = {
    "accunet_resize_bilinear": [_F, _I, _I, _D, _I, _I],
    "accunet_resize_nearest": [_F, _I, _I, _F, _I, _I],
    "accunet_standardize": [_D, _L],
    "accunet_binarize": [_F, _L],
}


def build_dir() -> Path:
    """The kernels' build directory (ops/kernels/_build.py `build_dir`)."""
    return SOURCE.parents[3] / "build" / "accunet_tpu_torch"


@functools.cache
def library() -> ctypes.CDLL | None:
    """The loaded library, built first if missing; None if g++ fails."""
    digest = hashlib.sha256(" ".join(FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    out_dir = build_dir()
    path = out_dir / f"libaccunet_dataops_{digest}.so"
    if not path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            tmp_path = Path(tmp) / path.name
            try:
                res = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(tmp_path)],
                                     capture_output=True, text=True)
            except OSError as e:  # no g++ on this host
                logger.warning("native data ops unavailable (%s); using numpy", e)
                return None
            if res.returncode:
                logger.warning("native data ops failed to build; using numpy:\n%s",
                               (res.stdout + res.stderr)[-4000:])
                return None
            os.replace(tmp_path, path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    return lib


def available() -> bool:
    return library() is not None


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def resize2d(img: np.ndarray, size: int, nearest: bool) -> np.ndarray:
    """(H, W) -> (size, size): nearest in float32, bilinear in float64."""
    if img.ndim != 2:
        raise ValueError(f"resize2d takes a 2D array, got shape {img.shape}")
    src = np.ascontiguousarray(img, np.float32)
    h, w = src.shape
    if nearest:
        dst = np.empty((size, size), np.float32)
        library().accunet_resize_nearest(_ptr(src, _F), h, w, _ptr(dst, _F), size, size)
    else:
        dst = np.empty((size, size), np.float64)
        library().accunet_resize_bilinear(_ptr(src, _F), h, w, _ptr(dst, _D), size, size)
    return dst


def standardize(img: np.ndarray) -> np.ndarray:
    """(x - mean) / (std + 1e-8) over the whole array, std unbiased; float64."""
    out = np.array(img, np.float64, order="C")  # a copy: the op works in place
    library().accunet_standardize(_ptr(out, _D), out.size)
    return out


def binarize(mask: np.ndarray) -> np.ndarray:
    """1.0 where mask > 0, else 0.0; float32."""
    out = np.array(mask, np.float32, order="C")
    library().accunet_binarize(_ptr(out, _F), out.size)
    return out
