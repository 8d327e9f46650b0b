"""Build and load the hand-written CUDA kernels (`accunet_tpu_torch/csrc`).

All `csrc/*.cu` files compile with nvcc for `sm_90a` into ONE shared library
with a plain C interface, loaded with ctypes. The library goes to
`build/accunet_tpu_torch/` beside the package under a name that carries a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads at once. Nothing is fetched or prebuilt.

The build runs at the first kernel launch, never at import: the CPU-only
tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

MAX_SMEM = 232448  # bytes of shared memory a CTA may use on sm_90

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (pointers, then ints, then the stream)
SIGNATURES = {
    "accunet_hanc_mix": [_P, _P, _P, _P] + [_I] * 8 + [_P],
    "accunet_respath_level": [_P] * 11 + [_I] * 7 + [_P],
    "accunet_hanc_block": [_P] * 14 + [_I] * 10 + [_P],
    "accunet_dwconv2d_wgrad": [_P] * 6 + [_I] * 11 + [_P],
    "accunet_linear_scan": [_P] * 3 + [_I] * 3 + [_P],
    "accunet_linear_scan_reverse": [_P] * 5 + [_I] * 3 + [_P],
    "accunet_linear_scan_staged": [_P] * 3 + [_I] * 5 + [_P],
    "accunet_expand_dw": [_P] * 5 + [_I] * 7 + [_P],
    "accunet_selective_scan_fwd": [_P] * 11 + [_I] * 5 + [_P],
    "accunet_selective_scan_bwd": [_P] * 22 + [_I] * 5 + [_P],
    "accunet_selective_scan_rh_fwd": [_P] * 7 + [_I] * 5 + [_P],
    "accunet_selective_scan_rh_bwd": [_P] * 14 + [_I] * 6 + [_P],
}


def build_dir() -> Path:
    return CSRC.parents[1] / "build" / "accunet_tpu_torch"


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> tuple[list[Path], str]:
    cu = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return cu, h.hexdigest()[:16]


@functools.cache
def load_library() -> ctypes.CDLL:
    """Compile (if the hashed library is missing) and load the kernels."""
    sources, digest = _sources()
    out_dir = build_dir()
    lib_path = out_dir / f"libaccunet_kernels_{digest}.so"
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            objs = [Path(tmp) / (s.stem + ".o") for s in sources]

            def compile_one(src_obj):
                src, obj = src_obj
                return subprocess.run(
                    [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
                    capture_output=True, text=True,
                )

            with ThreadPoolExecutor(len(sources)) as pool:
                results = list(pool.map(compile_one, zip(sources, objs)))
            log = "".join(r.stdout + r.stderr for r in results)
            failed = [s.name for s, r in zip(sources, results) if r.returncode]
            if not failed:
                tmp_lib = Path(tmp) / lib_path.name
                link = subprocess.run(
                    [nvcc, "-shared", "-o", str(tmp_lib), *map(str, objs)],
                    capture_output=True, text=True,
                )
                log += link.stdout + link.stderr
                if link.returncode:
                    failed = ["link"]
                else:
                    os.replace(tmp_lib, lib_path)
            (out_dir / "build.log").write_text(log)
            if failed:
                raise RuntimeError(f"nvcc failed for {failed}:\n{log[-8000:]}")
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero return of a C entry point (a CUDA error code from
    cudaGetLastError, or a negative code for a configuration it refused)."""
    if err:
        raise RuntimeError(f"{name} failed with code {err}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t: torch.Tensor) -> int:
    """The C entry points' dtype argument: 0 float32, 1 bfloat16."""
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernels take float32 or bfloat16, not {t.dtype}")
    return int(t.dtype == torch.bfloat16)


def require(t: torch.Tensor, name: str, shape=None, dtype=None, device=None) -> None:
    """Validate one kernel operand: CUDA, contiguous, and the given shape,
    dtype and device."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
