#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (accunet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, with one CUDA device:
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the hand-written kernels from accunet_tpu_torch/csrc (timed);
  3. holds each kernel against its plain PyTorch version at the shapes of
     ACC-UNet's main path (n_filts=32, 224x224, batch 8), in fp32 (TF32 off)
     and in bf16 (the wgrad kernel's dw and db, and its second call bitwise
     equal to its first);
  4. runs ACC_UNet through the eval entry point (accunet_tpu_torch.cli.eval)
     on a synthetic ISIC-style npy folder, with seeded random weights, and
     checks that every kernel launched there;
  5. compares the whole model on the GPU (kernels) with the CPU (plain
     versions) at batch 1, fp32;
  6. checks the autograd functions of the train path on the card
     (HancMixFn, DepthwiseConv2dFn) against the autograd of their plain
     versions;
  7. runs the train entry point (accunet_tpu_torch.cli.train --synthetic,
     224x224, batch 8) for two epochs, then resumes it for a third, and
     checks, counting the train steps and the validation forwards apart,
     that every HANCBlock's depthwise backward launched dwconv2d_wgrad and
     every k >= 2 HANC layer launched hanc_mix;
  8. holds one train step of ACC_UNet (n_filts=32) on the GPU against the
     same step on the CPU in float64: the loss, each BN statistic, each
     depthwise weight gradient (against the plain wgrad of the step's own
     inputs) and, coarsely, the gradients as a whole;
  9. times ACC_UNet b8 224x224 inference in fp32 and bf16, its fp32 train
     step, and each kernel against its plain version and, for the wgrad, the
     one PyTorch call that computes the same function (CUDA events, warm-up
     excluded), beside the least time the card could take for it (for
     hanc_mix, hanc_block and respath_level also the least time of their
     own path: 3xTF32 on the tensor cores in fp32, bf16 mma in bf16), and
     for respath_level cuDNN's 3x3 conv alone on the same x (a part of the
     level, so no library call);
 10. holds the scan kernels (linear_scan forward and reverse, the staged
     dma_chunked_scan) against their plain versions at the four stage shapes
     of Segmamba b8 224x224, and the staged kernel bitwise against
     linear_scan; then the fused selective scan (selective_scan_fwd and
     selective_scan_bwd) against its plain versions at the four BiMamba
     stage shapes and an odd one (out, the last state and all eight
     gradients), and its backward bitwise on a second call;
 11. checks ChunkedLinearScanFn's and SelectiveScanFn's gradients against
     autograd of their plain versions;
 12. compares Segmamba at full width, b8 224x224, through the fused kernels
     against the same GPU model through the plain selective scan, and a b1
     64x64 forward GPU vs CPU;
 13. runs the train entry point with --model Segmamba as in phase 7 and
     checks 16 fused forwards per train step and per validation forward, 16
     fused backwards per train step and no linear_scan launch;
 14. times Segmamba inference and its train step, each scan kernel per
     stage against its plain version and its bound, and each fused kernel
     per stage against its plain version, the unfused path it replaces (the
     glue around linear_scan / its reverse) and its bound;
 15. holds the expand_dw kernel (the hybrid HANCBlock front half) against its
     plain version at cnv72 of ACC_UNet b8 224x224, (8,56,56,128) -> 4352,
     at cnv72 of ACC_UNet_W b2 512x512, (2,128,128,128) -> 4352, and at a
     ragged shape with a large BN1 shift, fp32 and bf16;
 16. runs ACC_UNet_W (3 classes, 512x512, batch 2, hybrid front half on)
     through the eval entry point on a synthetic folder with class-id masks,
     checks its metrics and (512, 512, 4) dumps and counts the launches per
     forward: one expand_dw (cnv72) beside the hanc_block, respath_level and
     hanc_mix counts of phase 4, whose ACC_UNet path launches no expand_dw;
 17. compares ACC_UNet_W mc 512x512 b2 on the GPU with the hybrid on and
     off (same weights), then a b1 128x128 forward with hybrid_e_min=96
     (the kernel at every unfused block but the stem) GPU vs CPU;
 18. times ACC_UNet_W mc 512x512 b2 inference, fp32 and bf16, hybrid on and
     off, and expand_dw at both cnv72 shapes against its plain version, the
     unfused front half it replaces (the port's conv1x1, BN, lrelu,
     depthwise, BN, lrelu), its bound and its own path's bound (the expand
     on the tensor cores, the taps on the CUDA cores);
 19. holds dwconv2d_wgrad against its plain version at the four ShiftedBlock
     shapes of UNext b8 224x224, (8,14,14,160), (8,7,7,256), (8,14,14,160),
     (8,28,28,128), fp32 and bf16, dw and db, a second call bitwise;
 20. runs UNext (full width, seeded weights) through the eval entry point at
     224x224, batch 8, and checks that no port kernel launched (its
     depthwise forward is cuDNN's grouped conv, as it is XLA's in JAX);
 21. runs the train entry point with --model UNext as in phase 7 and checks
     4 dwconv2d_wgrad launches per train step (one per ShiftedBlock) and none
     per validation forward;
 22. compares UNext on the GPU with the CPU: a b1 224x224 forward (logits
     and five module outputs), and one b8 224x224 train step against the
     same step in float64 on the CPU, held as phase 8 holds ACC_UNet's;
 23. compares the four distinct UNext_CMRF topologies (UNext_CMRF, _enc_dec,
     _enc_MLFC, _dense_skip) at b1 64x64, GPU vs CPU;
 24. times UNext b8 224x224 inference in fp32 and bf16, its fp32 train step,
     its b1024 bf16 inference (the JAX bench's headline batch) with peak
     memory, UNext_CMRF b8 fp32 inference and train step, and the wgrad
     kernel at phase 19's shapes beside its plain version, cuDNN's
     weight-only backward and its bound. Phases 19-24 print their seconds;
 25. holds the return-hidden selective scan (selective_scan_rh_fwd: h and
     the chunk states; selective_scan_rh_bwd: du, ddelta, dA, dB, dbias)
     against its plain versions at the four stage shapes of the Spatial-
     Mamba Segmamba variant b8 224x224, BASELINE config 5's block (b8 56x56,
     C 64, d_state 16), N = 1, shapes at the kernels' edges (L below a
     chunk or past one, D past a CTA's or a cluster's d, N 1 and 3) and an
     odd shape, the backward bitwise on a second call and from a (B, D, N,
     L) cotangent, and the library's geometry against its plain mirror;
 26. checks SelectiveScanRhFn's gradients against autograd of the plain
     forward;
 27. runs the train entry point with --model
     Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn_HSLCA_SpatialMamba_no_text
     --n-classes 2 as in phase 7 and checks 8 rh forwards per train step and
     per validation forward, 8 rh backwards per train step and no other
     kernel launch;
 28. compares that variant at full width, b8 224x224, through the rh
     kernels against the same GPU model through the plain rh scan; a b1
     64x64 forward GPU vs CPU (its four outputs and block taps); one b2
     64x64 train step against the same step in float64 on the CPU; the
     SpatialMamba classifier (depths 1, d_state 1 and 16) b1 GPU vs CPU;
 29. times the variant's b8 224x224 fp32 inference and train step with peak
     memory, BASELINE config 5's SpatialMambaBlock forward, and each rh
     kernel per shape against its plain version and its bound;
 30. trains in bf16 (--set train.compute_dtype=bfloat16): ACC_UNet and UNext
     through the train entry point as in phase 7, with fp32's launches
     (ACC_UNet 16 hanc_mix and 18 dwconv2d_wgrad a step, 7 hanc_block, 7
     respath_level and 9 hanc_mix a validation forward; UNext 4 wgrad a
     step); every hanc_mix and dwconv2d_wgrad launch of one bf16 ACC_UNet
     b8 224x224 step against its plain version on the same bf16 inputs; a
     b2 64x64 bf16 step on the GPU against the same step on the CPU, both
     held to the float64 step (compare_train_step); ms/step and peak memory
     of both train steps in fp32 and bf16;
 31. trains ACC_UNet_W with 3 classes at 512x512, batch 2, fp32 through the
     train entry point as in phase 7 (multiclass Dice+CE), with its launches;
 32. runs the Seg-Grad-CAM entry point (accunet_tpu_torch.cli.gradcam) on
     ACC_UNet b8 224x224 at cnv12 (files, CAMs in [0, 1], one eval
     forward's launches a batch, seconds); the CAM on the GPU against the CPU
     at b2 64x64; the fused eval kernels' autograd functions (HancBlockFn
     with the chained pre, RespathLevelFn, ExpandDwFn) against autograd of
     their plain versions at the model's shapes;
 33. runs accunet_tpu_torch.cli.profile --trace on ACC_UNet b8 224x224 and
     checks its trace report (non-empty, hanc_block among the top ops), the
     report's device ms beside the CUDA-event ms of the same window;
 34. holds the fused selective scan at the hybrid family's flags (no z, D,
     bias, softplus) against its plain versions: MambaVisionMixer's N 8 at
     the hybrid rung's four stages (b8, L 12544-196, D 24-192), one SS2D
     direction of TokenVSSM (N 8, D 96, L 12544) and of MedMamba (N 16, D
     96, L 3136); out, the last state and the gradients, the backward
     bitwise on a second call; and times both kernels there beside their
     plain versions and bounds;
 35. times, fp32 at 224x224, Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn_HSLCA
     (the ladder's text rung) and the flagship ..._HSLCA_SpatialMamba, both
     with FakeTextEncoder text, and Segmamba_hybrid_gsc_VSS: inference at b8
     and the train step at b8 or, where it does not fit, the largest of b4
     and b2 that does, with peak memory and the scans a forward and a step;
     MedMamba's b8 forward; the device time of SS2D's copies in one VSS
     forward under torch.profiler;
 36. runs the train entry point with the two text models on folders that
     hold a prompt CSV (the rung with --n-classes 2) at phase 35's batch,
     as in phase 7, and checks that every forward met the prompts'
     embeddings and the launches: the rung 8 fused forwards and backwards a
     step and 8 forwards a validation forward, the flagship the same of the
     rh kernels;
 37. compares those three models (the text ones with text) and MedMamba
     at full width, b1 64x64, GPU vs CPU, and the GPU forward's scan
     launches (8 fused, 8 rh, 32 fused, 40 fused). Phases 34-37 print their
     seconds;
 38. holds the fused selective scan (no z, D, bias, softplus) at KNUnet's
     three decoder shapes (b8 256x256: D 512 / 256 / 128 over L 256 / 1024 /
     4096, N 16) and dwconv2d_wgrad with db at U-KAN's three DWBnRelu maps
     (b8 16x16x320, 8x8x512, 32x32x256; fp32 and bf16) against their plain
     versions, the backwards bitwise on a second call;
 39. runs the train entry point with --model KNUnet and with --model UKAN at
     full width, 256x256 (their preset), batch 8, as in phase 7, and checks
     the launches: KNUnet 12 fused forwards and backwards a step and 12
     forwards a validation forward (the last block of up1-up3, four
     directions each), U-KAN 12 dwconv2d_wgrad a step and none a validation
     forward;
 40. runs both through the eval entry point on cuda (KNUnet 12 fused
     forwards a forward, U-KAN none) and compares each, b1 64x64, GPU vs
     CPU with its launches;
 41. writes Segmamba (full width, seeded) as a reference-format .pth.tar
     whose kernels are 5-D (depth 1, or depth 3 with random off-centre
     taps) under 'module.' prefixes, evaluates it through the eval entry
     point with --torch-ckpt on cuda (4 images of 64x64, b2), and holds the
     dumped outputs against the source model on the CPU (16 fused forwards
     a forward);
 42. times KNUnet and U-KAN b8 256x256 fp32 inference and train step with
     peak memory and launches, the fused kernels at phase 38's shapes and
     the wgrad at U-KAN's maps beside its plain version, cuDNN's weight-only
     backward and the bounds. Phases 38-42 print their seconds;
 43. builds the ACC-UNet paper's UNet baselines at full width (UNet_base,
     Unetpp, MultiResUnet, UCTransNet with img_size 64, TransUNet,
     TransUnet_fKAN, TransUNet_Vit_fKAN, TransUNet_fJNB; weights drawn on the
     card) and compares each, b1 64x64 fp32, GPU vs CPU (logits and three
     module outputs, rel <= 1e-3), with no port kernel launched;
 44. runs the train entry point with UNet_base (256x256), UCTransNet (224x224,
     its default img_size: its 256 preset fails, in JAX too) and TransUNet
     (224x224) at batch 8 as in phase 7, and checks that no port kernel
     launched in a train step or a validation forward; the last epoch's ms a
     step and the run's peak memory;
 45. runs the eval entry point on the five families at their sizes (two b8
     forwards each, no port kernel) and UNet_base with 3 classes (4 logits);
 46. times each family's b8 inference in fp32 and bf16 (the compute dtype)
     and its fp32 train step, with peak memory;
 47. times TransUnet_fKAN (614.86M parameters) b8 224x224 inference and its
     fp32 train step at the largest of b8, b4, b2 that fits. Phases 43-47
     print their seconds;
 48. builds SwinUnet, SMESwinUnet (224x224, their fixed grid), SegViT_fKAN
     and TinyUNet (64x64) at full width (weights drawn on the card, as the
     CLIs build them through models.build_for) and compares each, b1 fp32,
     GPU vs CPU (logits and three module outputs, rel <= 1e-3), with no
     port kernel launched, and SMESwinUnet's boundary mask GPU vs CPU, which
     must be equal;
 49. runs the train entry point with the four (SwinUnet and SMESwinUnet at
     224x224 with SGD, SegViT_fKAN at 224x224, TinyUNet at 256x256) for two
     epochs at the largest of b8, b4, b2 that fits, and checks that no port
     kernel launched; the last epoch's ms a step and the peak memory;
 50. runs the eval entry point on the four at their sizes (two b8 forwards
     each, no port kernel) and SwinUnet with 3 classes (4 logits);
 51. times each one's b8 inference in fp32 and bf16 and its fp32 train step
     at the largest of b8, b4, b2 that fits, with peak memory. Phases 48-51
     print their seconds;
 52. builds the last 16 UNext_CMRF names at full width (the OD, BS and BSRB
     encoders, the CSSE, GS and GAB skips, the Haar wavelet pool, rKAN token
     blocks; 15 distinct forwards, _GS_Wavelet_hd being _GS_Wavelet's) and
     compares each, b1 64x64 fp32, GPU vs CPU (logits and module outputs,
     rel <= 1e-3), with no port kernel launched;
 53. runs the train entry point with UNext_CMRF_GAB_wavelet_OD (fp32 and
     bf16) and UNext_CMRF_GS_Wavelet_rKAN at 224x224, batch 8, for two
     epochs and checks dwconv2d_wgrad's launches (4 a step, 12 for rKAN, 0 a
     validation forward); both through the eval entry point (no launch);
     the GAB's dilated depthwise convs in bf16 vs fp32 on the card (output
     and gradients, at the four GABs' maps and each dilation);
 54. times _enc_CSSE, _GAB_wavelet_OD, _BSRB_GS, _BS_GS_Wavelet and
     _GS_Wavelet_rKAN: b8 224x224 inference in fp32 and bf16 and the fp32
     train step with its peak memory and launches. Phases 52-54 print their
     seconds;
 55. builds UNext_InceptionNext_MLFC and _fKAN at full width (its MetaNeXt
     stages and MLFC skips; the same model under both names) and compares
     each GPU vs CPU: the b1 64x64 eval forward (logits and seven module
     outputs, rel <= 1e-3) with no port kernel launched, and a b2 64x64
     train-mode forward with every BN's running statistics, the GPU's fp32
     and the CPU's fp32 each against the CPU's float64 (within twice the
     CPU's gap, or 1e-3); holds dwconv2d_wgrad against its plain version at
     the model's four ShiftedBlock maps at b8 256x256 (4x4x160, 2x2x256,
     4x4x160, 8x8x128), fp32 and bf16, dw and db, a second call bitwise;
 56. runs the train entry point with UNext_InceptionNext_MLFC at 256x256
     (its preset), batch 8, two epochs, fp32 and bf16, and checks 4
     dwconv2d_wgrad a step and none a validation forward; both names
     through the eval entry point (no launch); times b8 256x256 inference
     in fp32 and bf16, the fp32 train step with its peak memory, and the
     wgrad at phase 55's maps beside its plain version, cuDNN's weight-only
     backward and its bound;
 57. starts two ranks on the one card (subprocesses, gloo with CUDA tensors:
     NCCL refuses two ranks on one device; parallel/ uses all-reduce,
     all-gather and one broadcast) and in them: ACC_UNet b8 224x224 one train step on
     data=2 (4 images a rank) and on model=2 (cnv72's and eleven other
     weights of >= 2^18 elements sharded with their Adam moments) with a
     validation forward each, against the one-process step on the same
     images (the loss and the running statistics within 1e-3; the fp32
     gradients reported: summation order moves them ~10% of the largest at
     random init, and the float64 CPU test holds them), with each rank's
     launches (16 hanc_mix and 18 dwconv2d_wgrad a step; 7 hanc_block, 7
     respath_level, 9 hanc_mix a validation forward);
     sequence_parallel_scan at the JAX bench's scan shape (8, 3136, 768), h
     and both gradients against one rank's linear_scan / linear_scan_reverse
     and the plain versions (rel <= 1e-4), one of each kernel a call, timed;
     Segmamba b8 224x224 under sequence_sharding (seq=2): the eval forward
     and one train step against the one-process fused path (the forward
     within atol 2e-5 / rtol 1e-4, the loss within 1e-4, the gradients
     within 1e-3 of the largest), 16 linear_scan a forward and 16 of each
     kernel a step on each rank, no fused launch, with the peak memory;
 58. runs the train entry point with --distributed (NCCL, a world of one)
     and --mesh data=1 for two epochs of ACC_UNet and checks its launches.
     Phases 55-56 and 57-58 print their seconds.
Phases print their seconds. It prints a JSON line of the kernels (the
launches of every path, the new ones too), then as its last line
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
A failed phase raises, so the run exits non-zero and prints no result; so
does a host without CUDA or a directory without the package.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

B, HW, NF = 8, 224, 32  # the main path: ACC_UNet, n_filts=32, 224x224, batch 8
# the hybrid slice: ACC_UNet_W, 3 classes, 512x512, batch 2 (BASELINE config 4)
W_B, W_HW, W_CLASSES = 2, 512, 3
FP32_TOL = 1e-4  # max |kernel - plain| / max |plain| in fp32 (sums reassociate)
# bf16: both sides compute in fp32 from the same bf16 inputs and round at the
# same points (a value on a rounding boundary may land one bf16 ulp, 2^-8
# relative, apart, and later products carry it); hanc_mix also rounds w and
# its pools to bf16 before the product, as JAX's kernel does, where the plain
# version keeps them in fp32. The measured bf16 errors are printed in phase 3
# and in the kernels line.
BF16_TOL = 1e-2
# whole model, GPU (kernels) vs CPU (plain versions), fp32: relative error of
# the logits and of the block outputs, absolute error of the probabilities
MODEL_TOL = 1e-3
# one train step, GPU vs CPU, fp32 (compare_train_step says how it is held)
TRAIN_CMP_HW, TRAIN_TOL = 64, 1e-3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# H100 SXM peak operations per second by input type: fp32 outside the tensor
# cores; bf16 and fp16 on the tensor cores (dense)
PEAK_FLOPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12, torch.float16: 989e12}
TF32_FLOPS_PER_S = 495e12  # the tensor cores in TF32 (dense)


class SmokeError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, want) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|) over fp32 copies."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise SmokeError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(got.isfinite().all()):
        raise SmokeError("non-finite kernel output")
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


class Case(NamedTuple):
    """One kernel call at a main-path shape: `run` and `plain` are closures
    over `args`; `flops` counts the operations the function needs. `own_path`
    prices the kernel's own arithmetic where it differs from the input
    type's peak, as terms (operations per multiply-add pair counted, peak
    operations per second, the operations, or None for `flops`): the
    tensor-core kernels in fp32 do each product three times (3xTF32), in
    bf16 once at the bf16 peak; expand_dw's taps run on the CUDA cores.
    `conv_alone` (respath_level) is cuDNN's 3x3 conv on the same x: only a
    part of the function, so no library call for it."""
    kernel: str
    name: str
    run: Callable
    plain: Callable
    args: tuple
    flops: float
    library: Callable | None = None
    unfused: Callable | None = None  # the separate torch ops a fused kernel replaces
    own_path: tuple | None = None
    conv_alone: Callable | None = None


def tensors(obj) -> list:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in tensors(o)]
    return []


def nbytes(obj, skip=()) -> int:
    """Bytes of the tensors in `obj`, less those that alias a tensor of
    `skip` (an output that is an input, unwritten: respath_level's x at
    level 0)."""
    seen = {t.data_ptr() for t in tensors(skip)}
    return sum(t.numel() * t.element_size() for t in tensors(obj) if t.data_ptr() not in seen)


def bound_ms(case: Case, out, own: bool = False) -> tuple[float, str]:
    """The least time the card could take: each input read once and each
    output that is not an input written once at 3.35 TB/s, or the operations at the card's peak
    for the type of the call's first input (fp32 67 TFLOP/s, bf16 989 on
    the tensor cores, whatever the kernel itself computes in), whichever is
    larger (H100 SXM data sheet). With `own` the operations are priced by
    `case.own_path`: the least time of the kernel's own path."""
    dtype = next(a.dtype for a in case.args if isinstance(a, torch.Tensor))
    t_bytes = (nbytes(case.args) + nbytes(out, skip=case.args)) / HBM_BYTES_PER_S * 1e3
    terms = case.own_path if own else ((1, PEAK_FLOPS_PER_S[dtype], None),)
    t_ops = sum(f * (case.flops if n is None else n) / peak for f, peak, n in terms) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def wgrad_library(x, g, k):
    """The one PyTorch call that computes the depthwise weight gradient:
    aten.convolution_backward with only the weight output (cuDNN)."""
    c = x.shape[-1]
    w = torch.empty(c, 1, k, k, device=x.device, dtype=x.dtype)
    return torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w, None, [1, 1], [(k - 1) // 2] * 2,
        [1, 1], False, [0, 0], c, [False, True, False])[1]


def wgrad_case(name, x, g):
    """dwconv2d_wgrad (3x3, with db) on x and g (B, H, W, C): the plain
    version and cuDNN's weight-only backward beside it."""
    from accunet_tpu_torch.ops.kernels import dwconv2d as DW

    b, h, w, c = x.shape
    return Case("dwconv2d_wgrad", name, lambda: DW.dwconv2d_wgrad(x, g, 3, 3, bias_grad=True),
                lambda: (DW.dwconv2d_wgrad_reference(x, g, 3, 3), g.float().sum(dim=(0, 1, 2))),
                (x, g), 2 * 9 * b * h * w * c + b * h * w * c, lambda: wgrad_library(x, g, 3))


def kernel_cases(dev):
    """Cases at the main path's shapes, as closures over random inputs of
    dtype dt."""
    from accunet_tpu_torch.ops.kernels import hanc_block as HB
    from accunet_tpu_torch.ops.kernels import hanc_mix as HM
    from accunet_tpu_torch.ops.kernels import respath as RP

    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device=dev) * s

    def block(cin, e, cout, k=3):
        f = lambda n: 1.0 / n ** 0.5  # noqa: E731
        bns = {n: (1 + rn(d, s=0.1), rn(d, s=0.1))
               for n, d in [("norm1", e), ("norm2", e), ("hnc", cin), ("norm", cin), ("norm3", cout)]}
        return HB.fold(rn(cin, e, s=f(cin)), rn(e, s=0.1), rn(3, 3, e, s=f(9)), rn(e, s=0.1),
                       rn(e, 2 * k - 1, cin, s=f(e)), rn(cin, s=0.1), rn(cin, cout, s=f(cin)),
                       rn(cout, s=0.1), bns)

    def mix_flops(px, c, cout, k):
        # x@w0 at full resolution, avg and max mixes at 1/4^i of the pixels
        return 2 * px * c * cout * (1 + sum(2 / 4 ** i for i in range(1, k)))

    def cases(dt):
        out = []
        # own path: 3xTF32 on the tensor cores in fp32, bf16 mma in bf16
        own = ((3, TF32_FLOPS_PER_S, None),) if dt == torch.float32 else \
            ((1, PEAK_FLOPS_PER_S[dt], None),)
        # HANCBlock bodies: cnv12, cnv22 (chained: cnv21's SE in the prologue),
        # cnv81 (the widest, cin 128), cnv91
        for name, hw, cin, e, cout, chained in [("cnv12", HW, NF, 3 * NF, NF, False),
                                                ("cnv22", HW // 2, 2 * NF, 6 * NF, 2 * NF, True),
                                                ("cnv81", HW // 2, 4 * NF, 12 * NF, 2 * NF, False),
                                                ("cnv91", HW, 2 * NF, 6 * NF, NF, False)]:
            x, p = rn(B, hw, hw, cin).to(dt), block(cin, e, cout)
            pre = torch.stack([0.5 + rn(B, cin, s=0.1), rn(B, cin, s=0.1)], 1).contiguous() \
                if chained else None
            px = B * hw * hw  # expand, depthwise 3x3, HANC mix (k=3), project
            flops = 2 * px * (cin * e + 9 * e + cin * cout) + mix_flops(px, e, cin, 3)
            out.append(Case("hanc_block", name,
                            lambda x=x, p=p, pre=pre: HB.hanc_block(x, p, 3, pre),
                            lambda x=x, p=p, pre=pre: HB.hanc_block_reference(x, p, 3, pre),
                            (x, tuple(p), pre), flops, own_path=own))
        # ResPath levels: rspth1 level 0 and a later level, rspth2 a later level
        for name, hw, c, prev in [("rspth1.level0", HW, NF, False), ("rspth1.level1", HW, NF, True),
                                  ("rspth2.level1", HW // 2, 2 * NF, True)]:
            args = [rn(B, hw, hw, c).to(dt), rn(3, 3, c, c, s=1 / (9 * c) ** 0.5),
                    1 + rn(c, s=0.1), rn(c, s=0.1)]
            if prev:
                args += [rn(B, hw, hw, c).to(dt), torch.rand(B, c, generator=g, device=dev),
                         1 + rn(c, s=0.1), rn(c, s=0.1)]
            w_oihw = args[1].permute(3, 2, 0, 1).contiguous().to(dt)
            out.append(Case("respath_level", name,
                            lambda a=args: RP.respath_level(*a),
                            lambda a=args: RP.respath_level_reference(*a),
                            tuple(args), 2 * B * hw * hw * 9 * c * c, own_path=own,
                            conv_alone=lambda x=args[0], w=w_oihw: F.conv2d(
                                x.permute(0, 3, 1, 2), w, padding=1)))
        # HANC mixes of the unfused blocks: cnv11 (E=9), cnv31, cnv61 (k=2), cnv72 (E=4352)
        for name, hw, c, cout, k in [("cnv11", HW, 9, 3, 3), ("cnv31", HW // 4, 6 * NF, 2 * NF, 3),
                                     ("cnv61", HW // 8, 48 * NF, 16 * NF, 2),
                                     ("cnv72", HW // 4, 136 * NF, 4 * NF, 3)]:
            args = [rn(B, hw, hw, c).to(dt), rn(c, 2 * k - 1, cout, s=1 / c ** 0.5),
                    rn(cout, s=0.1), k]
            out.append(Case("hanc_mix", name, lambda a=args: HM.hanc_mix(*a),
                            lambda a=args: HM.hanc_mix_reference(*a),
                            tuple(args[:3]), mix_flops(B * hw * hw, c, cout, k), own_path=own))
        # depthwise weight (and bias) gradients of the train step: cnv12
        # (E=96), cnv52 and cnv61 (E=1536), cnv72 (E=4352)
        for name, hw, c in [("cnv12", HW, 3 * NF), ("cnv52", HW // 16, 48 * NF),
                            ("cnv61", HW // 8, 48 * NF), ("cnv72", HW // 4, 136 * NF)]:
            out.append(wgrad_case(name, rn(B, hw, hw, c).to(dt), rn(B, hw, hw, c).to(dt)))
        return out

    return cases


def check_kernels(cases, worst_bf16=None):
    """Phase 3. Returns {kernel: max abs error in fp32} and adds the bf16
    ones to `worst_bf16`; raises after reporting every disagreement. The
    wgrad kernel must also give the same bits on a second call."""
    worst, bad = {}, []
    worst_bf16 = {} if worst_bf16 is None else worst_bf16
    for dt, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        for kname, cname, kern, plain, *_ in cases(dt):
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            same = True
            if kname == "dwconv2d_wgrad":
                same = all(torch.equal(p, q) for p, q in zip(got, kern()))
            errs = []
            for i, (g_, w_) in enumerate(zip(got, want)):
                if kname in ("hanc_block", "respath_level") and i == len(got) - 1:
                    g_, w_ = g_.sum(dim=1), w_.sum(dim=1)  # per-tile sums -> per image
                errs.append(rel_err(g_, w_))
            abs_err = max(e[0] for e in errs)
            rel = max(e[1] for e in errs)
            ok = rel <= tol and same
            log(f"  {'ok ' if ok else 'BAD'} {kname:13s} {cname:14s} {str(dt)[6:]:8s} "
                f"max_abs_err {abs_err:.3e}  rel {rel:.3e}  (tol {tol:g})"
                + ("" if kname != "dwconv2d_wgrad" else f"; dw, db; 2nd call bitwise {same}"))
            into = worst if dt == torch.float32 else worst_bf16
            into[kname] = max(into.get(kname, 0.0), abs_err)
            if not ok:
                bad.append(f"{kname} {cname} {dt}")
            del got, want
    if bad:
        raise SmokeError(f"kernels disagree with their plain versions: {bad}")
    return worst


# launches per eval forward of ACC_UNet and ACC_UNet_W at n_filts=32: the 7
# fused blocks (4 of them chained), the 7 levels of rspth1/rspth2, the 9 HANC
# layers with k >= 2 of the unfused blocks; with the hybrid on, cnv72's front half
EVAL_LAUNCHES = {"hanc_block": 7, "respath_level": 7, "hanc_mix": 9, "expand_dw": 0}
# every kernel wrapper's counter, by name
KERNELS = ("hanc_block", "respath_level", "hanc_mix", "expand_dw", "dwconv2d_wgrad",
           "linear_scan", "linear_scan_reverse", "linear_scan_staged", "selective_scan_fwd",
           "selective_scan_bwd", "selective_scan_rh_fwd", "selective_scan_rh_bwd")


def write_folder(root, n, hw, n_classes=1):
    """A synthetic ISIC-style npy folder of n images (4, hw, hw) and masks:
    binary or, for n_classes > 1, class ids 0..n_classes."""
    rs = np.random.default_rng(0)
    for sub in ("images", "masks"):
        os.makedirs(os.path.join(root, sub))
    for i in range(n):
        np.save(os.path.join(root, "images", f"isic{i:03d}.npy"),
                rs.random((4, hw, hw), dtype=np.float32))
        np.save(os.path.join(root, "masks", f"isic{i:03d}.npy"),
                rs.integers(0, n_classes + 1, (hw, hw)).astype(np.float32))


def run_eval_cli(counters, model="ACC_UNet", n_classes=1, hw=HW, batch=B, n=2 * B,
                 model_kwargs=None, per_forward=EVAL_LAUNCHES):
    """Phases 4 and 16: the eval entry point on a synthetic ISIC-style folder
    of n images, masks binary or, for n_classes > 1, class ids 0..n_classes.
    Checks the metrics CSV, the (hw, hw, 1 or n_classes+1) dumps and that the
    run launched `per_forward` times its forwards of each kernel."""
    from accunet_tpu_torch.cli import eval as cli

    out_ch = 1 if n_classes == 1 else n_classes + 1
    with tempfile.TemporaryDirectory() as tmp:
        write_folder(os.path.join(tmp, "data"), n, hw, n_classes)
        argv = ["--model", model, "--test-dir", os.path.join(tmp, "data"),
                "--n-classes", str(n_classes), "--img-size", str(hw), "--batch", str(batch),
                "--device", "cuda", "--csv", os.path.join(tmp, "m.csv"),
                "--result", os.path.join(tmp, "test.result"), "--dump-dir", os.path.join(tmp, "dump")]
        if model_kwargs:
            argv += ["--model-kwargs", model_kwargs]
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        if res.n_images != n:
            raise SmokeError(f"eval saw {res.n_images} images, expected {n}")
        with open(os.path.join(tmp, "m.csv")) as f:
            rows = list(csv.DictReader(f))
        if len(rows) != n or not all(0.0 <= float(r[k]) <= 1.0 for r in rows
                                     for k in ("dice", "iou", "accuracy")):
            raise SmokeError("metrics CSV incomplete or a metric out of [0, 1]")
        dumps = sorted(os.listdir(os.path.join(tmp, "dump")))
        if len(dumps) != n:
            raise SmokeError(f"{len(dumps)} dumps for {n} images")
        for name in dumps:
            out = np.load(os.path.join(tmp, "dump", name))["output"]
            if out.shape != (hw, hw, out_ch) or not np.isfinite(out).all():
                raise SmokeError(f"{name}: output {out.shape} not finite {(hw, hw, out_ch)}")
    forwards = -(-n // batch)
    want = {k: per_forward.get(k, 0) * forwards for k in launches}
    if launches != want:
        raise SmokeError(f"the eval path launched {launches}, expected {want}")
    log(f"  {model} eval ({n_classes} classes, {hw}x{hw}, b{batch}, kwargs {model_kwargs}): {n} "
        f"images in {seconds:.2f} s, dice {res.dice:.4f}, {res.seconds_per_image * 1e3:.2f} "
        f"ms/image timed forward; launches {launches} in {forwards} forwards")
    return launches


def check_autograd_fns(dev):
    """Phase 6: the train path's autograd functions on the card at main-path
    shapes, b8: DepthwiseConv2dFn (its dw from the wgrad kernel) against
    autograd through cuDNN's grouped conv, HancMixFn (forward kernel,
    recomputed plain backward) against autograd through its plain version."""
    import torch.nn.functional as F

    from accunet_tpu_torch.ops.kernels.dwconv2d import DepthwiseConv2dFn
    from accunet_tpu_torch.ops.kernels.hanc_mix import HancMixFn, hanc_mix_reference

    g = torch.Generator(device=dev).manual_seed(7)

    def rn(*shape, s=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * s).requires_grad_(True)

    checks = []
    for name, hw, c in [("cnv12", HW, 3 * NF), ("cnv72", HW // 4, 136 * NF)]:
        x, w, b = rn(B, hw, hw, c), rn(c, 1, 3, 3, s=1 / 3), rn(c, s=0.1)
        gy = torch.randn(B, hw, hw, c, generator=g, device=dev)
        got = torch.autograd.grad(DepthwiseConv2dFn.apply(x, w, b), (x, w, b), gy)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=1, groups=c).permute(0, 2, 3, 1)
        checks.append((f"DepthwiseConv2dFn {name}", got, torch.autograd.grad(y, (x, w, b), gy)))
    for name, hw, c, cout, k in [("cnv31", HW // 4, 6 * NF, 2 * NF, 3),
                                 ("cnv61", HW // 8, 48 * NF, 16 * NF, 2)]:
        x, w, b = rn(B, hw, hw, c), rn(c, 2 * k - 1, cout, s=1 / c ** 0.5), rn(cout, s=0.1)
        gy = torch.randn(B, hw, hw, cout, generator=g, device=dev)
        got = torch.autograd.grad(HancMixFn.apply(x, w, b, k), (x, w, b), gy)
        want = torch.autograd.grad(hanc_mix_reference(x, w, b, k), (x, w, b), gy)
        checks.append((f"HancMixFn {name}", got, want))
    bad = []
    for name, got, want in checks:
        rel = max(rel_err(a, b_)[1] for a, b_ in zip(got, want))
        ok = rel <= FP32_TOL
        log(f"  {'ok ' if ok else 'BAD'} {name:24s} grads rel {rel:.3e} (tol {FP32_TOL:g})")
        if not ok:
            bad.append(name)
    if bad:
        raise SmokeError(f"autograd functions disagree with their plain versions: {bad}")


def write_prompts(root):
    """A Filename,Text prompt CSV naming every image of the npy folder."""
    names = sorted(os.listdir(os.path.join(root, "images")))
    with open(os.path.join(root, "prompts.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Filename", "Text"])
        w.writerows([n, f"lesion {i}: irregular border, {'dark' if i % 2 else 'light'} centre"]
                    for i, n in enumerate(names))


@contextlib.contextmanager
def text_recorder():
    """Counts SegMamba forwards with and without text_tokens while open."""
    from accunet_tpu_torch.models.segmamba import SegMamba

    seen = {"with_text": 0, "without_text": 0}
    forward = SegMamba.forward

    def recording(self, x, text_tokens=None):
        seen["without_text" if text_tokens is None else "with_text"] += 1
        return forward(self, x, text_tokens)

    SegMamba.forward = recording
    try:
        yield seen
    finally:
        SegMamba.forward = forward


def run_train_cli(counters, model, want_fn, extra=(), hw=HW, batch=B, prompts=False,
                  timing=None, resume=True):
    """Phases 7, 13, 21, 27, 30, 31, 36, 39, 44 and 49: the train entry point
    for `model` (with the arguments `extra`) on a synthetic ISIC-style folder
    of hw x hw images in batches of `batch`: two epochs with a checkpoint
    directory, then (`resume`) --resume auto for a third. With `prompts` the train and
    validation folders (`batch` and `batch` / 2 images: a step and a
    validation batch an epoch) each hold a prompt CSV, and every forward
    must have met the prompts' embeddings. Returns the launches of the train
    steps and of the validation forwards apart: the counts are set to 0
    before each epoch's train or validation pass (engine.run_epoch, which
    fit calls) and read after it. want_fn(steps, val_batches) gives the
    expected launches. A `timing` dict gets the last epoch's train ms per
    step and the run's peak device memory (above what earlier phases hold)."""
    from accunet_tpu_torch.cli import train as cli
    from accunet_tpu_torch.train import engine

    launches = {"train_steps": dict.fromkeys(counters, 0),
                "validation": dict.fromkeys(counters, 0)}
    run_epoch = engine.run_epoch

    def counted_run_epoch(step_fn, state, loader, train, **kw):
        for fn in counters.values():
            fn.launches = 0
        out = run_epoch(step_fn, state, loader, train, **kw)
        torch.cuda.synchronize()
        for name, fn in counters.items():
            launches["train_steps" if train else "validation"][name] += fn.launches
        return out

    with tempfile.TemporaryDirectory() as tmp, text_recorder() as seen:
        ckpt = os.path.join(tmp, "ckpt")
        argv = ["--model", model, "--img-size", str(hw), "--batch", str(batch),
                "--device", "cuda", "--ckpt-dir", ckpt, "--check-numerics", *extra]
        if prompts:
            n_classes = int(extra[extra.index("--n-classes") + 1]) if "--n-classes" in extra else 1
            for split, n in (("train", batch), ("val", batch // 2)):
                write_folder(os.path.join(tmp, split), n, hw, n_classes)
                write_prompts(os.path.join(tmp, split))
            argv += ["--train-dir", os.path.join(tmp, "train"),
                     "--val-dir", os.path.join(tmp, "val")]
        else:
            argv.append("--synthetic")
        engine.run_epoch = counted_run_epoch
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # by earlier phases
        try:
            t0 = time.perf_counter()
            state, hist1 = cli.main(argv + ["--epochs", "2"])
            saved = sorted(os.listdir(ckpt))
            hist2 = []
            if resume:
                state, hist2 = cli.main(argv + ["--epochs", "3", "--resume", "auto"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            engine.run_epoch = run_epoch
        kept = sorted(os.listdir(ckpt))
    epochs = [h["epoch"] for h in hist1 + hist2]
    steps = sum(h["train"]["batches"] for h in hist1 + hist2)
    val_batches = sum(h["val"]["batches"] for h in hist1 + hist2)
    losses = [h[s]["loss"] for h in hist1 + hist2 for s in ("train", "val")]
    if epochs != [1, 2, 3][:3 if resume else 2] or "epoch_0002.pth.tar" not in saved \
            or state.step != steps:
        raise SmokeError(f"train/resume: epochs {epochs}, saved {saved}, step {state.step}")
    if not all(np.isfinite(losses)):
        raise SmokeError(f"non-finite losses {losses}")
    want = want_fn(steps, val_batches)
    if launches != want:
        raise SmokeError(f"train path launches {launches}, expected {want}")
    if prompts and seen != {"with_text": steps + val_batches, "without_text": 0}:
        raise SmokeError(f"{model}: the prompts reached {seen} forwards of {steps} steps and "
                         f"{val_batches} validation batches")
    if timing is not None:
        last = (hist1 + hist2)[-1]["train"]
        timing.update(last_epoch_ms_per_step=last["time"] * 1e3 / last["batches"],
                      peak_mem_gib=(torch.cuda.max_memory_allocated() - held) / 2 ** 30)
    log(f"  {model} {' '.join(extra)} train ({hw}x{hw}, b{batch}"
        + (", prompt CSV" if prompts else "") + f"): {steps} steps + {val_batches} "
        f"val batches in {seconds:.2f} s ("
        + (f"3 epochs, resumed after 2 from {saved[-1]}" if resume else "2 epochs")
        + f"), losses {[round(v, 4) for v in losses]}, kept "
        f"{kept}; launches {launches}" + (f"; SegMamba forwards {seen}" if prompts else ""))
    return launches


def acc_train_launches(steps, val_batches):
    """Per ACC_UNet train step: each of the 18 HANCBlocks' depthwise backward,
    each of the 16 k >= 2 HANC layers (every block unfused); per validation
    forward: 7 fused blocks, 7 ResPath levels, 9 HANC mixes."""
    return {"train_steps": {"hanc_block": 0, "respath_level": 0, "hanc_mix": 16 * steps,
                            "expand_dw": 0, "dwconv2d_wgrad": 18 * steps},
            "validation": {**{k: v * val_batches for k, v in EVAL_LAUNCHES.items()},
                           "dwconv2d_wgrad": 0}}


def bn_stat_err(got, want, init):
    """Largest error of the running statistics after one step, each BN
    tensor over its own scale: a running mean over the largest batch standard
    deviation of its layer (a mean that is 0 in exact arithmetic, as behind a
    1x1 conv of BN-normalised input, is held to the spread of its data), a
    running variance over its layer's largest batch variance. running =
    0.9 * init + 0.1 * batch, so the batch variances are read back from the
    float64 buffers."""
    worst = (0.0, "")
    for name in want:
        if not name.endswith("running_mean"):
            continue
        var_name = name[: -len("mean")] + "var"
        var = float(((want[var_name] - 0.9 * init[var_name]) / 0.1).max())
        worst = max(worst,
                    (float((got[name] - want[name]).abs().max()) / (0.1 * var ** 0.5), name),
                    (float((got[var_name] - want[var_name]).abs().max()) / (0.1 * var), var_name))
    return worst


class DepthwiseTaps:
    """Forward hooks that keep, for every depthwise conv of a step, its input
    x and the gradient g of its output, so that each depthwise weight (and
    bias) gradient can be held against the plain wgrad of the same x and g:
    a HANCBlock's conv2 (x is lrelu of norm1's output, g norm2's input's
    gradient) and a UNeXt DWConv (its own input and output). The bias
    gradient is held for the DWConvs only: a HANCBlock's conv2 feeds a
    train-mode BN, which takes the mean out of g, so its db is rounding
    noise around 0."""

    def __init__(self, model):
        from accunet_tpu_torch.nn.acc_blocks import HANCBlock, lrelu
        from accunet_tpu_torch.nn.unext_blocks import DWConv

        self.x, self.g, self.convs, self.with_db = {}, {}, {}, set()

        def keep_g(name):
            def hook(t):  # returns None: a pre-hook's input stays as it is
                t.register_hook(lambda g: self.g.__setitem__(name, g.detach()))
            return hook

        def keep_x(name):
            return lambda mod, inp, out: self.x.__setitem__(name, lrelu(out).detach())

        def keep_both(name):
            def hook(mod, inp, out):
                self.x[name] = inp[0].detach()
                keep_g(name)(out)
            return hook

        self.handles = []
        for name, mod in model.named_modules():
            if isinstance(mod, HANCBlock):
                self.convs[name] = mod.conv2
                self.handles += [mod.norm1.register_forward_hook(keep_x(name)),
                                 mod.norm2.register_forward_pre_hook(
                                     lambda m, inp, name=name: keep_g(name)(inp[0]))]
            elif isinstance(mod, DWConv):
                self.convs[name] = mod.dwconv
                self.with_db.add(name)
                self.handles.append(mod.register_forward_hook(keep_both(name)))

    def worst(self):
        """(largest max |dw - plain| / max |plain| over the convs, the conv's
        block), and the number of convs; a DWConv's db against g summed
        likewise."""
        from accunet_tpu_torch.ops.kernels.dwconv2d import dwconv2d_wgrad_reference

        for h in self.handles:
            h.remove()
        errs = []
        for name, conv in self.convs.items():
            kh, kw = conv.weight.shape[2:]
            g = self.g[name].contiguous()
            want = dwconv2d_wgrad_reference(self.x[name], g, kh, kw)
            errs.append((rel_err(conv.weight.grad, want.permute(2, 0, 1).unsqueeze(1))[1], name))
            if name in self.with_db:
                errs.append((rel_err(conv.bias.grad, g.sum(dim=(0, 1, 2)))[1], name))
        return max(errs), len(self.convs)


def acc_unet():
    from accunet_tpu_torch.models import ACC_UNet, init_parameters

    return init_parameters(ACC_UNet(3, 1, NF), torch.Generator().manual_seed(0))


def compare_train_step(make_model=acc_unet, b=2, hw=TRAIN_CMP_HW, tol=TRAIN_TOL,
                       dev: str = "cuda", dtype=torch.float32):
    """Phases 8, 22 and 30: one train step (make_train_fns: train-mode BN,
    weighted Dice+BCE, backward, Adam) of a seeded model (ACC_UNet
    n_filts=32 at b2 64x64; UNext at b8 224x224) on the GPU in fp32
    (kernels), held against the same step on the CPU in float64 (plain
    versions), with the CPU's fp32 step beside it as the control:
      * the loss to `tol`, relative;
      * every BN running statistic to `tol` of its own scale (bn_stat_err);
      * every depthwise weight (and bias) gradient of the GPU step, per
        parameter, to FP32_TOL of the plain wgrad of that step's own x and g
        (DepthwiseTaps):
        the wgrad kernel feeds no activation, so this holds it in the step
        exactly, however the step's rounding went;
      * the gradients as a whole only coarsely (within twice the control's
        gap of the largest gradient, or `tol`): at random init ACC_UNet's
        train-mode BN amplifies the gradients toward the input, and a
        LeakyReLU input within rounding of 0 takes the other slope, so one
        step's fp32 and float64 gradients differ by about a tenth of the
        largest gradient on either device (PERF.md section 6).
    `tol` is TRAIN_TOL (1e-3) for ACC_UNet and UNEXT_TRAIN_TOL (1e-4) for
    UNext, whose step is far better conditioned: on the H100 its loss,
    BN statistics and gradients came within 0, 3.8e-6 and 1.6e-5 of the
    float64 step (the CPU's fp32 control: 1.3e-5, 3.1e-5).
    With `dtype` bfloat16 (phase 30) the GPU and CPU steps compute in bf16
    (fp32 parameters cast at use) and the CPU's bf16 step is the control of
    the loss and the BN statistics too: a bf16 train step is far from the
    float64 one (on the CPU, ACC_UNet b2 64x64: a BN variance 0.48 of its
    layer's scale, the gradients 0.84 of the largest; JAX's bf16 model's BN
    variances are 0.54 from the same float64 statistics), so each measure is
    held within twice the control's, or `tol`."""
    from accunet_tpu_torch.train.engine import make_train_fns

    base = make_model()
    init = {n: t.double() for n, t in base.named_buffers() if "running" in n}
    rs = np.random.default_rng(4)
    x = torch.from_numpy(rs.random((b, hw, hw, 3), dtype=np.float32))
    mask = torch.from_numpy((rs.random((b, hw, hw, 1)) > 0.5).astype(np.float32))
    res = {}
    for tag, d, dt in (("gpu", dev, torch.float32), ("cpu", "cpu", torch.float32),
                       ("cpu64", "cpu", torch.float64)):
        t0 = time.perf_counter()
        model = copy.deepcopy(base).to(device=d, dtype=dt)
        if dt == torch.float32:
            model.dtype = dtype
        taps = DepthwiseTaps(model) if tag == "gpu" else None
        fns = make_train_fns(model)
        _, stats = fns.train_step(fns.state, {"image": x.to(d, dt), "mask": mask.to(d, dt)})
        res[tag] = (float(stats["loss"]),
                    {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()},
                    {n: b.double().cpu() for n, b in model.named_buffers() if "running" in n})
        if taps is not None:
            dw_err, n_dw = taps.worst()
        log(f"  {tag:5s} loss {res[tag][0]:.8f} ({time.perf_counter() - t0:.1f} s)")

    def gap(tag):
        """The largest gradient error over the largest float64 gradient."""
        want = res["cpu64"][1]
        scale = max(float(t.abs().max()) for t in want.values())
        return max(float((res[tag][1][n] - t).abs().max()) for n, t in want.items()) / scale

    out = {"dtype": str(dtype)[6:], "dw_vs_plain": dw_err[0], "dw_worst": dw_err[1],
           "dw_params": n_dw}
    for tag in ("gpu", "cpu"):
        out["loss_rel" + ("" if tag == "gpu" else "_cpu")] = (
            abs(res[tag][0] - res["cpu64"][0]) / abs(res["cpu64"][0]))
        out[f"bn_stats_{tag}"], out[f"bn_worst_{tag}"] = bn_stat_err(res[tag][2],
                                                                     res["cpu64"][2], init)
        out[f"grad_gap_{tag}"] = gap(tag)
    log(f"  {out['dtype']} vs the float64 CPU step, GPU (CPU {out['dtype']} control): loss rel "
        f"{out['loss_rel']:.3e} ({out['loss_rel_cpu']:.3e}); "
        f"BN statistics {out['bn_stats_gpu']:.3e} at {out['bn_worst_gpu']} "
        f"({out['bn_stats_cpu']:.3e} at {out['bn_worst_cpu']}); gradients over the largest "
        f"{out['grad_gap_gpu']:.3e} ({out['grad_gap_cpu']:.3e}). {n_dw} depthwise weight "
        f"gradients (and DWConv bias gradients) vs plain wgrad of the step's x, g: rel "
        f"{dw_err[0]:.3e} at {dw_err[1]}")
    # bf16: the loss and the BN statistics too against twice the control
    lim = {k: max(2 * out[c], tol) if dtype != torch.float32 or k == "grad_gap_gpu" else tol
           for k, c in (("loss_rel", "loss_rel_cpu"), ("bn_stats_gpu", "bn_stats_cpu"),
                        ("grad_gap_gpu", "grad_gap_cpu"))}
    log(f"  limits (tol {tol:g}): " + ", ".join(f"{k} {v:.3e}" for k, v in lim.items())
        + f", depthwise gradients {FP32_TOL:g}")
    if out["dw_vs_plain"] > FP32_TOL or any(out[k] > v for k, v in lim.items()):
        raise SmokeError("the train step on the GPU disagrees with the float64 CPU step")
    return out


def time_train_step(model, label="ACC_UNet", counters=None, dtype=torch.float32, hw=HW):
    """Phases 9b, 24 and 30: the b8 224x224 train step (forward, weighted
    Dice+BCE, backward, Adam) of a copy of `model` on the card computing in
    `dtype` (bf16: fp32 parameters cast at use), 10 steps after 3 warm-up,
    its peak memory and the launches per step of each kernel in
    `counters`."""
    from accunet_tpu_torch.train.engine import make_train_fns

    counters = counters or {}
    m = copy.deepcopy(model).cuda()
    m.dtype = dtype
    fns = make_train_fns(m)
    g = torch.Generator("cuda").manual_seed(6)
    batch = {"image": torch.rand(B, hw, hw, 3, generator=g, device="cuda"),
             "mask": (torch.rand(B, hw, hw, 1, generator=g, device="cuda") > 0.5).float()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = {k: fn.launches for k, fn in counters.items()}
    ms = time_ms(lambda: fns.train_step(fns.state, batch), iters=10, warmup=3)
    per_step = {k: (fn.launches - counts[k]) / 13 for k, fn in counters.items()}
    _, stats = fns.train_step(fns.state, batch)
    if not bool(torch.isfinite(stats["loss"])):
        raise SmokeError(f"non-finite loss in the timed {label} train step")
    out = {"ms_per_step": ms, "img_per_s": B * 1e3 / ms,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f"  {label} b{B} {hw}x{hw} {str(dtype)[6:]} train step: {ms:.3f} ms/step, "
        f"{out['img_per_s']:.1f} "
        f"img/s, peak {out['peak_mem_gib']:.2f} GiB; per step "
        + ", ".join(f"{k} {n:g}" for k, n in per_step.items()))
    del fns
    torch.cuda.empty_cache()
    return out


def seeded_model(name="ACC_UNet", n_classes=1, **kw):
    """An ACC-UNet model (n_filts=32, logits) with seeded weights and BN
    statistics moved off their init values, so every folded affine is
    non-trivial; `kw` go to the model (e.g. the hybrid switch)."""
    from accunet_tpu_torch.models import build, init_parameters

    model = init_parameters(build(name, n_channels=3, n_classes=n_classes, n_filts=NF,
                                  final_sigmoid=False, **kw),
                            torch.Generator().manual_seed(0))
    return seeded_bns(model, 3).eval()


def seeded_bns(module, seed):
    """Move every BatchNorm of `module` off its init values (seeded)."""
    from accunet_tpu_torch.nn.acc_blocks import BatchNorm

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, BatchNorm):
                c = mod.num_features
                mod.weight.copy_(1 + 0.1 * torch.randn(c, generator=g))
                mod.bias.copy_(0.1 * torch.randn(c, generator=g))
                mod.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                mod.running_var.copy_(1 + 0.1 * torch.rand(c, generator=g))
    return module


# block outputs compared besides the logits (the logits of a random model are
# small, the features are O(0.1-1))
TAPS = ("cnv12", "cnv22", "rspth1", "rspth2", "cnv72", "cnv82", "cnv92")


def forward_with_taps(model, x, taps=TAPS):
    feats = {}
    hooks = [model.get_submodule(n).register_forward_hook(
        lambda mod, inp, out, n=n: feats.__setitem__(n, out.float().cpu())) for n in taps]
    try:
        out = model(x).cpu()
    finally:
        for h in hooks:
            h.remove()
    return out, feats


def compare_on_cpu(model, label, hw, taps, seed):
    """Phases 5, 22 and 23: `model` b1 hw x hw fp32 on the GPU (kernels) vs
    the CPU (plain versions): the logits and the `taps` module outputs rel
    <= MODEL_TOL (the logits of a random model are small, the features
    O(0.1-1)), the sigmoid probabilities abs <= MODEL_TOL."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((1, hw, hw, 3),
                                                                     dtype=np.float32))
    with torch.inference_mode():
        t0 = time.perf_counter()
        want, want_f = forward_with_taps(model, x, taps)
        cpu_s = time.perf_counter() - t0
        got, got_f = forward_with_taps(copy.deepcopy(model).cuda(), x.cuda(), taps)
    errs = {n: rel_err(got_f[n], want_f[n])[1] for n in taps}
    abs_err, errs["logits"] = rel_err(got, want)
    errs["probabilities (abs)"] = float((torch.sigmoid(got) - torch.sigmoid(want)).abs().max())
    worst = max(errs.values())
    log(f"  {label} b1 {hw}x{hw}, GPU vs CPU: logits max_abs_err {abs_err:.3e} (|logit| <= "
        f"{float(want.abs().max()):.3g}); rel " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (tol {MODEL_TOL:g}); CPU forward {cpu_s:.1f} s")
    if worst > MODEL_TOL:
        raise SmokeError(f"{label} on the GPU disagrees with the CPU")
    return worst


def compare_model():
    """Phase 5: ACC_UNet fp32, GPU (kernels) vs CPU (plain versions), b1."""
    model = seeded_model()
    compare_on_cpu(model, "ACC_UNet", HW, TAPS, 1)
    return model


def time_model(model, label="ACC_UNet", batch=B, dtypes=(torch.float32, torch.bfloat16), hw=HW):
    """Phases 9a and 24: inference of `model` at hw x hw (ACC_UNet and
    UNext b8 fp32 and bf16, UNext b1024 bf16, UNext_CMRF b8 fp32)."""
    x = torch.randn(batch, hw, hw, 3, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(2))
    rates = {}
    for dt in dtypes:
        m = copy.deepcopy(model).to(device="cuda", dtype=dt)
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            out = m(x)
            if not bool(out.isfinite().all()):
                raise SmokeError(f"non-finite model output in {dt}")
            ms = time_ms(lambda: m(x), iters=10, warmup=3)
        name = str(dt)[6:]
        rates[name] = {"ms_per_batch": ms, "img_per_s": batch * 1e3 / ms,
                       "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        log(f"  {label} b{batch} {hw}x{hw} {name}: {ms:.3f} ms/batch, {batch * 1e3 / ms:.1f} "
            f"img/s, peak {rates[name]['peak_mem_gib']:.2f} GiB")
        del m, out
        torch.cuda.empty_cache()
    return rates


def time_kernels(cases):
    """Phase 9c: each kernel vs its plain version and, where one exists, the
    one PyTorch call that computes the same function, per case, fp32 and
    bf16; beside the least time the card could take for the call."""
    times = {}
    for dt in (torch.float32, torch.bfloat16):
        for case in cases(dt):
            with torch.inference_mode():
                out = case.run()
                bound, bound_by = bound_ms(case, out)
                own = bound_ms(case, out, own=True) if case.own_path else None
                del out
                k_ms, p_ms = time_ms(case.run), time_ms(case.plain)
                lib_ms = time_ms(case.library) if case.library is not None else None
                unf_ms = time_ms(case.unfused) if case.unfused is not None else None
                conv_ms = time_ms(case.conv_alone) if case.conv_alone is not None else None
            times[(case.kernel, case.name, str(dt)[6:])] = {
                "ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms, "bound_ms": bound,
                "bound_by": bound_by, **({"unfused_ms": unf_ms} if unf_ms is not None else {}),
                **({"conv_alone_ms": conv_ms} if conv_ms is not None else {}),
                **({"own_bound_ms": own[0], "own_bound_by": own[1]} if own else {})}
            lib = f"   library {lib_ms:8.3f} ms" if lib_ms is not None else ""
            lib += f"   unfused ops {unf_ms:8.3f} ms" if unf_ms is not None else ""
            lib += f"   conv alone {conv_ms:8.3f} ms" if conv_ms is not None else ""
            lib += f"   own path's bound {own[0]:7.3f} ms ({own[1]})" if own else ""
            log(f"  {case.kernel:14s} {case.name:14s} {str(dt)[6:]:8s} kernel {k_ms:8.3f} ms   "
                f"plain {p_ms:8.3f} ms   bound {bound:7.3f} ms ({bound_by}){lib}")
    return times


# ------------------------------------------------------------- SegMamba slice
# Segmamba (the SegMamba baseline) at full width, b8 224x224: feat 48/96/192/384,
# d_state 16, expand 2; the stage-i BiMambas scan L = (112 / 2^i)^2 steps over
# D = 2 * feat_i * 16 columns, two layers x two branches per stage
SM_FEAT = (48, 96, 192, 384)
SCAN_STAGES = tuple((f"stage{i}", B, (HW // 2 >> i) ** 2, 2 * f * 16)
                    for i, f in enumerate(SM_FEAT))
SCANS_PER_FORWARD = 16
SM_CMP_HW = 64  # GPU vs CPU forward: full width, b1, 64x64
# the BiMamba selective scans: (name, B, L, d_inner), N = 16, and an odd shape
# (L 300: a partial chunk; D 13: partial CTAs of 4 and 8 d)
FUSED_STAGES = tuple((name, b, l, dn // 16) for name, b, l, dn in SCAN_STAGES)
FUSED_ODD = ("odd", 3, 300, 13)
N_STATES = 16


def scan_inputs(g, b, l, d):
    """a = exp(delta * A) as a BiMamba branch makes it (delta the softplus of
    N(0, 1) per channel, A = -(1..16) along each state row), b ~ N(0, 0.3^2)."""
    delta = torch.nn.functional.softplus(torch.randn(b, l, d // 16, 1, generator=g, device="cuda"))
    a = torch.exp(delta * -torch.arange(1, 17, device="cuda", dtype=torch.float32))
    return a.reshape(b, l, d), 0.3 * torch.randn(b, l, d, generator=g, device="cuda")


def check_scan_kernels():
    """Phase 10: linear_scan (forward and reverse) vs linear_scan_plain /
    linear_scan_grads_plain at Segmamba's four stage shapes and at one odd
    shape (B 3, L 300: a partial last chunk, D 48: a partial 32-column tile),
    fp32 rel <= FP32_TOL; linear_scan_staged (dma_chunked_scan) bitwise equal
    to linear_scan at nbuf 2 and 4 (and chunk 64 on the odd shape). Returns
    {kernel: max abs error vs plain}."""
    from accunet_tpu_torch.ops.kernels import scan as S

    g = torch.Generator("cuda").manual_seed(10)
    worst, bad = {"linear_scan": 0.0, "linear_scan_staged": 0.0}, []
    for name, b, l, d in SCAN_STAGES + (("odd", 3, 300, 48),):
        a, x = scan_inputs(g, b, l, d)
        gy = torch.randn(b, l, d, generator=g, device="cuda")
        h = S.linear_scan(a, x)
        da, db = S.linear_scan_reverse(a, h, gy)
        staged = {f"nbuf{nb}": S.dma_chunked_scan(a, x, nbuf=nb) for nb in (2, 4)}
        if name == "odd":
            staged["chunk64"] = S.dma_chunked_scan(a, x, chunk=64, nbuf=3)
        torch.cuda.synchronize()
        hp = S.linear_scan_plain(a, x)
        dap, dbp = S.linear_scan_grads_plain(a, h, gy)
        errs = [rel_err(h, hp), rel_err(da, dap), rel_err(db, dbp)]
        equal = {k: bool(torch.equal(v, h)) for k, v in staged.items()}
        rel = max(e[1] for e in errs)
        ok = rel <= FP32_TOL and all(equal.values())
        worst["linear_scan"] = max(worst["linear_scan"], max(e[0] for e in errs))
        worst["linear_scan_staged"] = max(worst["linear_scan_staged"],
                                          max(rel_err(v, hp)[0] for v in staged.values()))
        log(f"  {'ok ' if ok else 'BAD'} linear_scan {name:6s} B{b} L{l} D{d}: forward rel "
            f"{errs[0][1]:.3e}, reverse da {errs[1][1]:.3e} db {errs[2][1]:.3e} (tol "
            f"{FP32_TOL:g}); staged == linear_scan {equal}")
        if not ok:
            bad.append(name)
        del a, x, gy, h, da, db, staged, hp, dap, dbp
    torch.cuda.empty_cache()
    if bad:
        raise SmokeError(f"scan kernels disagree with their plain versions: {bad}")
    return worst


def fused_inputs(g, b, l, d, n=N_STATES):
    """The fused kernels' operands as BiMamba hands them (after the wrapper's
    copies): u = silu(N(0, 1)), delta N(0, 0.5^2) before its softplus, A =
    -(1..16) per row (the init), B, C, z ~ N(0, 1), D ~ 1 + N(0, 0.1^2),
    bias ~ N(0, 0.1^2); and a cotangent g ~ N(0, 1)."""
    def rn(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * s

    ops = (F.silu(rn(b, d, l)), rn(b, d, l, s=0.5),
           -torch.arange(1, n + 1, device="cuda", dtype=torch.float32).expand(d, n).contiguous(),
           rn(b, n, l), rn(b, n, l), 1 + rn(d, s=0.1), rn(b, d, l), rn(d, s=0.1))
    return ops, rn(b, d, l)


def check_fused_scan():
    """Phase 10b: selective_scan_fwd (with its chunk states) and
    selective_scan_bwd against selective_scan_fwd_plain / _bwd_plain at the
    four BiMamba stage shapes of Segmamba b8 224x224 and FUSED_ODD, with
    BiMamba's flags (D, z, bias, softplus) and a cotangent on the last state
    too: out, the last state and the eight gradients rel <= FP32_TOL, and
    the backward's outputs bitwise equal on a second call. Returns {kernel:
    max abs error vs plain}."""
    from accunet_tpu_torch.ops.kernels import selective_scan as SS

    g = torch.Generator("cuda").manual_seed(16)
    worst, bad = {"selective_scan_fwd": 0.0, "selective_scan_bwd": 0.0}, []
    for name, b, l, d in FUSED_STAGES + (FUSED_ODD,):
        ops, gy = fused_inputs(g, b, l, d)
        g_last = torch.randn(b, d, N_STATES, generator=g, device="cuda")
        out, last, states = SS.selective_scan_fwd(*ops, True, save_states=True)
        grads = SS.selective_scan_bwd(*ops, True, states, gy, g_last)
        again = SS.selective_scan_bwd(*ops, True, states, gy, g_last)
        torch.cuda.synchronize()
        same = all(torch.equal(p, q) for p, q in zip(grads, again))
        del again
        want = SS.selective_scan_fwd_plain(*ops, True)
        f_errs = [rel_err(out, want[0]), rel_err(last, want[1])]
        del want
        want = SS.selective_scan_bwd_plain(*ops, True, gy, g_last)
        b_errs = {k: rel_err(p, q) for k, p, q in zip(
            ("du", "ddelta", "dA", "dB", "dC", "dD", "dz", "dbias"), grads, want)}
        rel = max([e[1] for e in f_errs] + [e[1] for e in b_errs.values()])
        ok = rel <= FP32_TOL and same
        worst["selective_scan_fwd"] = max(worst["selective_scan_fwd"], max(e[0] for e in f_errs))
        worst["selective_scan_bwd"] = max(worst["selective_scan_bwd"],
                                          max(e[0] for e in b_errs.values()))
        log(f"  {'ok ' if ok else 'BAD'} selective_scan {name:6s} B{b} L{l} D{d} N{N_STATES}: out "
            f"rel {f_errs[0][1]:.3e}, last state {f_errs[1][1]:.3e}; "
            + ", ".join(f"{k} {v[1]:.3e}" for k, v in b_errs.items())
            + f" (tol {FP32_TOL:g}); backward bitwise on a second call {same}")
        if not ok:
            bad.append(name)
        del ops, gy, g_last, out, last, states, grads, want
        torch.cuda.empty_cache()
    if bad:
        raise SmokeError(f"the fused selective scan disagrees with its plain versions: {bad}")
    return worst


def check_scan_autograd():
    """Phase 11: ChunkedLinearScanFn's gradients (reverse kernel) vs autograd
    through linear_scan_plain, and SelectiveScanFn's (both fused kernels) vs
    autograd through selective_scan_fwd_plain, at stage 2's shape and the odd
    one."""
    from accunet_tpu_torch.ops.kernels.scan import ChunkedLinearScanFn, linear_scan_plain

    g = torch.Generator("cuda").manual_seed(11)
    bad = []
    for name, b, l, d in (SCAN_STAGES[2], ("odd", 3, 300, 48)):
        a, x = (t.requires_grad_(True) for t in scan_inputs(g, b, l, d))
        w = torch.randn(b, l, d, generator=g, device="cuda")
        got = torch.autograd.grad(ChunkedLinearScanFn.apply(a, x), (a, x), w)
        want = torch.autograd.grad(linear_scan_plain(a, x), (a, x), w)
        rel = max(rel_err(p, q)[1] for p, q in zip(got, want))
        ok = rel <= FP32_TOL
        log(f"  {'ok ' if ok else 'BAD'} ChunkedLinearScanFn {name} B{b} L{l} D{d}: grads rel "
            f"{rel:.3e} (tol {FP32_TOL:g})")
        if not ok:
            bad.append(name)
    from accunet_tpu_torch.ops.kernels.selective_scan import (SelectiveScanFn,
                                                              selective_scan_fwd_plain)

    for name, b, l, d in (FUSED_STAGES[2], FUSED_ODD):
        ops, gy = fused_inputs(g, b, l, d)
        ops = [t.requires_grad_(True) for t in ops]
        got = torch.autograd.grad(SelectiveScanFn.apply(*ops, True)[0], ops, gy)
        want = torch.autograd.grad(selective_scan_fwd_plain(*ops, True)[0], ops, gy)
        rel = max(rel_err(p, q)[1] for p, q in zip(got, want))
        ok = rel <= FP32_TOL
        log(f"  {'ok ' if ok else 'BAD'} SelectiveScanFn {name} B{b} L{l} D{d}: grads rel "
            f"{rel:.3e} (tol {FP32_TOL:g})")
        if not ok:
            bad.append(f"SelectiveScanFn {name}")
    if bad:
        raise SmokeError(f"the scans' autograd functions disagree with autograd of their plain "
                         f"versions: {bad}")


def segmamba_model():
    """Segmamba at full width and depth (3 channels in, 1 logit out), seeded
    with the JAX package's initialisers, eval mode, on the CPU."""
    from accunet_tpu_torch.models import build, init_parameters

    return init_parameters(build("Segmamba", in_chans=3, out_chans=1),
                           torch.Generator().manual_seed(0)).eval()


class PlainSelectiveScan:
    """SelectiveScanFn's stand-in through the plain forward."""

    @staticmethod
    def apply(*args):
        from accunet_tpu_torch.ops.kernels.selective_scan import selective_scan_fwd_plain

        return selective_scan_fwd_plain(*args)


@contextlib.contextmanager
def plain_scan():
    """Route selective_scan through selective_scan_fwd_plain (the glue
    around linear_scan_plain) instead of the fused kernels."""
    from accunet_tpu_torch.ops import selective_scan as SS

    kernel = SS.SelectiveScanFn
    SS.SelectiveScanFn = PlainSelectiveScan
    try:
        yield
    finally:
        SS.SelectiveScanFn = kernel


def unfused_selective_scan(u, delta, A, B, C, D, z, delta_bias, delta_softplus=True):
    """The unfused path the fused kernels replace (the port's selective_scan
    before them): the (B, L, D, N) glue around ChunkedLinearScanFn, whose
    forward is the linear_scan kernel and backward linear_scan_reverse."""
    from accunet_tpu_torch.ops.kernels.scan import chunked_linear_scan

    u_t = u.transpose(1, 2).contiguous()
    dl = delta.transpose(1, 2) + delta_bias
    dl = (F.softplus(dl) if delta_softplus else dl).contiguous()
    a = torch.exp(dl[..., None] * A)
    bu = (dl * u_t)[..., None] * B.transpose(1, 2)[:, :, None, :]
    bsz, l, d, n = a.shape
    h = chunked_linear_scan(a.reshape(bsz, l, d * n).contiguous(),
                            bu.reshape(bsz, l, d * n).contiguous()).reshape(bsz, l, d, n)
    y = torch.einsum("bldn,bln->bld", h, C.transpose(1, 2)) + u_t * D
    return (y * F.silu(z.transpose(1, 2))).transpose(1, 2), h[:, -1]


def compare_segmamba(model):
    """Phase 12: Segmamba b8 224x224 fp32 on the GPU through the fused
    selective scan vs the same GPU model through selective_scan_fwd_plain
    (logits and the four encoder stages, rel <= FP32_TOL); then full width,
    b1 64x64, GPU vs CPU (plain versions), rel <= MODEL_TOL."""
    from accunet_tpu_torch.ops.kernels.scan import linear_scan
    from accunet_tpu_torch.ops.kernels.selective_scan import selective_scan_fwd

    gpu = copy.deepcopy(model).cuda()
    x = torch.randn(B, HW, HW, 3, device="cuda", generator=torch.Generator("cuda").manual_seed(12))
    feats = {}
    hook = gpu.vit.register_forward_hook(lambda mod, inp, out: feats.__setitem__(len(feats), out))
    with torch.inference_mode():
        before = (selective_scan_fwd.launches, linear_scan.launches)
        got = gpu(x)
        torch.cuda.synchronize()
        n_kernel = (selective_scan_fwd.launches - before[0], linear_scan.launches - before[1])
        with plain_scan():
            want = gpu(x)
        torch.cuda.synchronize()
        n_plain = (selective_scan_fwd.launches - before[0] - n_kernel[0],
                   linear_scan.launches - before[1] - n_kernel[1])
    hook.remove()
    if (n_kernel, n_plain) != ((SCANS_PER_FORWARD, 0), (0, 0)):
        raise SmokeError(f"(selective_scan_fwd, linear_scan) launches: the kernel forward "
                         f"{n_kernel}, the plain one {n_plain}")
    errs = {f"stage{i}": rel_err(p, q) for i, (p, q) in enumerate(zip(feats[0], feats[1]))}
    errs["logits"] = rel_err(got, want)
    worst = max(e[1] for e in errs.values())
    log(f"  b{B} {HW}x{HW}, fused selective scan vs its plain version on the GPU "
        f"({n_kernel[0]} selective_scan_fwd launches): "
        + ", ".join(f"{k} rel {v[1]:.3e}" for k, v in errs.items())
        + f" (|logit| <= {float(want.abs().max()):.3g}, tol {FP32_TOL:g})")
    del gpu, feats, got, want
    torch.cuda.empty_cache()
    if worst > FP32_TOL:
        raise SmokeError("Segmamba through the fused kernels disagrees with the plain scan")
    xs = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (1, SM_CMP_HW, SM_CMP_HW, 3), dtype=np.float32))
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = model(xs)
        cpu_s = time.perf_counter() - t0
        got = copy.deepcopy(model).cuda()(xs.cuda()).cpu()
    abs_err, rel = rel_err(got, want)
    log(f"  b1 {SM_CMP_HW}x{SM_CMP_HW}, GPU vs CPU: logits max_abs_err {abs_err:.3e} (rel "
        f"{rel:.3e}, tol {MODEL_TOL:g}); CPU forward {cpu_s:.1f} s")
    if rel > MODEL_TOL:
        raise SmokeError("Segmamba on the GPU disagrees with the CPU")
    return {"kernel_vs_plain_rel": worst, "gpu_vs_cpu_rel": rel}


def segmamba_train_launches(steps, val_batches):
    """Per Segmamba train step: 16 fused selective-scan forwards (2 layers x
    2 branches x 4 stages) and their 16 fused backwards; per validation
    forward: 16 fused forwards; nothing else of the port's kernels (the
    standalone scans, linear_scan and its reverse, are on no path)."""
    zero = dict.fromkeys(KERNELS, 0)
    return {"train_steps": {**zero, "selective_scan_fwd": SCANS_PER_FORWARD * steps,
                            "selective_scan_bwd": SCANS_PER_FORWARD * steps},
            "validation": {**zero, "selective_scan_fwd": SCANS_PER_FORWARD * val_batches,
                           "selective_scan_bwd": 0}}


def time_segmamba(model):
    """Phase 14a/b: Segmamba b8 224x224 fp32 inference and train step
    (binary Dice+BCE, its configured loss; backward; Adam), CUDA events,
    10 iterations after 3 warm-up, with peak memory."""
    from accunet_tpu_torch.ops.kernels.selective_scan import (selective_scan_bwd,
                                                              selective_scan_fwd)
    from accunet_tpu_torch.train import losses as L
    from accunet_tpu_torch.train.engine import make_train_fns

    g = torch.Generator("cuda").manual_seed(14)
    x = torch.rand(B, HW, HW, 3, generator=g, device="cuda")
    m = copy.deepcopy(model).cuda()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        ms = time_ms(lambda: m(x), iters=10, warmup=3)
    out = {"inference_fp32": {"ms_per_batch": ms, "img_per_s": B * 1e3 / ms,
                              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}}
    fns = make_train_fns(m.train(), loss_fn=L.binary_dice_bce)
    batch = {"image": x, "mask": (torch.rand(B, HW, HW, 1, generator=g, device="cuda") > 0.5)
             .float()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = (selective_scan_fwd.launches, selective_scan_bwd.launches)
    ms = time_ms(lambda: fns.train_step(fns.state, batch), iters=10, warmup=3)
    per_step = ((selective_scan_fwd.launches - counts[0]) / 13,
                (selective_scan_bwd.launches - counts[1]) / 13)
    _, stats = fns.train_step(fns.state, batch)
    if not bool(torch.isfinite(stats["loss"])):
        raise SmokeError("non-finite loss in the timed Segmamba train step")
    out["train_step_fp32"] = {"ms_per_step": ms, "img_per_s": B * 1e3 / ms,
                              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    i, t = out["inference_fp32"], out["train_step_fp32"]
    log(f"  Segmamba b{B} {HW}x{HW} fp32 inference: {i['ms_per_batch']:.3f} ms/batch, "
        f"{i['img_per_s']:.1f} img/s, peak {i['peak_mem_gib']:.2f} GiB; train step "
        f"{t['ms_per_step']:.3f} ms/step, {t['img_per_s']:.1f} img/s, peak "
        f"{t['peak_mem_gib']:.2f} GiB; per step selective_scan_fwd {per_step[0]:g}, "
        f"selective_scan_bwd {per_step[1]:g}")
    del m, fns
    torch.cuda.empty_cache()
    return out


def time_scan_kernels():
    """Phase 14c: at each stage shape, the forward kernel, the reverse kernel
    and the staged kernel (nbuf 4 and 2) against their plain versions and the
    least time the card could take (bytes: a, b read and h written, or a, h,
    g read and da, db written, at 3.35 TB/s; 2 flops a step are far below
    the FMA peak). No single PyTorch call computes the recurrence."""
    from accunet_tpu_torch.ops.kernels import scan as S

    g = torch.Generator("cuda").manual_seed(15)
    times = {}
    for name, b, l, d in SCAN_STAGES:
        a, x = scan_inputs(g, b, l, d)
        gy = torch.randn(b, l, d, generator=g, device="cuda")
        h = S.linear_scan(a, x)
        tensor_ms = a.numel() * 4 / HBM_BYTES_PER_S * 1e3
        with torch.inference_mode():
            rows = {
                "linear_scan": (lambda: S.linear_scan(a, x), lambda: S.linear_scan_plain(a, x), 3),
                "linear_scan_reverse": (lambda: S.linear_scan_reverse(a, h, gy),
                                        lambda: S.linear_scan_grads_plain(a, h, gy), 5),
                "linear_scan_staged": (lambda: S.dma_chunked_scan(a, x, nbuf=4),
                                       lambda: S.linear_scan_plain(a, x), 3),
                "linear_scan_staged_nbuf2": (lambda: S.dma_chunked_scan(a, x, nbuf=2),
                                             lambda: S.linear_scan_plain(a, x), 3),
            }
            for kname, (run, plain, n_tensors) in rows.items():
                k_ms, p_ms = time_ms(run), time_ms(plain, iters=3, warmup=1)
                bound = n_tensors * tensor_ms
                times[(kname, name)] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": None,
                                        "bound_ms": bound, "bound_by": "bytes"}
                log(f"  {kname:24s} {name} B{b} L{l:5d} D{d:5d}: kernel {k_ms:8.3f} ms   plain "
                    f"{p_ms:8.3f} ms   bound {bound:7.3f} ms (bytes, {n_tensors} x "
                    f"{a.numel() * 4 / 1e6:.0f} MB), {100 * bound / k_ms:.1f}% of it")
        del a, x, gy, h
    torch.cuda.empty_cache()
    return times


def time_fused_scan():
    """Phase 14d: at each BiMamba stage shape, selective_scan_fwd (as
    inference runs it: no chunk states) and selective_scan_bwd (from the
    forward's chunk states, as the train step runs it) against their plain
    versions, the unfused path each replaces (unfused_selective_scan's
    forward: the glue and linear_scan; its backward through autograd: the
    glue's and linear_scan_reverse) and the least time the card could take:
    each input read once and each output written once at 3.35 TB/s, or the
    fp32 operations (7 a (t, n) forward, 20 backward) at 67 TFLOP/s. No
    single PyTorch call computes the selective scan."""
    from accunet_tpu_torch.ops.kernels import selective_scan as SS

    g = torch.Generator("cuda").manual_seed(17)
    times = {}
    for name, b, l, d in FUSED_STAGES:
        ops, gy = fused_inputs(g, b, l, d)
        pairs = b * l * d * N_STATES
        with torch.inference_mode():
            _, _, states = SS.selective_scan_fwd(*ops, True, save_states=True)
        leaves = [t.clone().requires_grad_(True) for t in ops]
        y_unf = unfused_selective_scan(*leaves)[0]
        cases = {
            "selective_scan_fwd": Case(
                "selective_scan_fwd", name, lambda: SS.selective_scan_fwd(*ops, True),
                lambda: SS.selective_scan_fwd_plain(*ops, True), (*ops,), 7 * pairs,
                unfused=lambda: unfused_selective_scan(*ops)),
            "selective_scan_bwd": Case(
                "selective_scan_bwd", name,
                lambda: SS.selective_scan_bwd(*ops, True, states, gy),
                lambda: SS.selective_scan_bwd_plain(*ops, True, gy), (*ops, states, gy),
                20 * pairs,
                unfused=lambda: torch.autograd.grad(y_unf, leaves, gy, retain_graph=True)),
        }
        for kname, case in cases.items():
            with torch.inference_mode(kname == "selective_scan_fwd"):
                out = case.run()
                bound, bound_by = bound_ms(case, out)
                del out
                k_ms = time_ms(case.run)
                p_ms = time_ms(case.plain, iters=3, warmup=1)
            unf_ms = time_ms(case.unfused, iters=5)
            times[(kname, name)] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": None,
                                    "bound_ms": bound, "bound_by": bound_by, "unfused_ms": unf_ms}
            log(f"  {kname:24s} {name} B{b} L{l:5d} D{d:4d} N{N_STATES}: kernel {k_ms:8.3f} ms   "
                f"plain {p_ms:8.3f} ms   unfused path {unf_ms:8.3f} ms   bound {bound:7.3f} ms "
                f"({bound_by}), {100 * bound / k_ms:.1f}% of it")
        del ops, gy, states, leaves, y_unf, cases
        torch.cuda.empty_cache()
    return times


# -------------------------------------------------------- hybrid front half
# cnv72 (cin 128, inv_fctr 34, E 4352) at ACC_UNet b8 224x224 and at
# ACC_UNet_W b2 512x512: the two maps the expand_dw kernel meets
CNV72_SHAPES = (("cnv72.b8_224", (B, HW // 4, HW // 4, 4 * NF)),
                ("cnv72.w_b2_512", (W_B, W_HW // 4, W_HW // 4, 4 * NF)))


def expand_dw_cases(dev):
    """Phase 15 and 18 cases: expand_dw at the two cnv72 shapes, with the
    weights of a seeded cnv72-shaped HANCBlock (whose unfused front half is
    the `unfused` yardstick), and at a ragged shape (13x17 map, cin 37, E
    200) whose BN1 shift of ~2 makes the activated padding ring non-zero."""
    from accunet_tpu_torch.models import init_parameters
    from accunet_tpu_torch.nn.acc_blocks import HANCBlock
    from accunet_tpu_torch.ops.kernels import expand_dw as ED

    block = seeded_bns(init_parameters(HANCBlock(4 * NF, 4 * NF, 3, 34, hybrid=True),
                                       torch.Generator().manual_seed(15)), 15).eval().to(dev)
    g = torch.Generator(device=dev).manual_seed(15)

    def rn(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device=dev) * s

    cin, e = 37, 200
    ragged = (rn(cin, e, s=cin ** -0.5), rn(e, s=0.1), rn(3, 3, e, s=1 / 3), rn(e, s=0.1),
              (1 + rn(e, s=0.1), 2 + rn(e, s=0.1)), (1 + rn(e, s=0.1), rn(e, s=0.1)))

    def own(dt, px, cin, e):
        # the expand on the tensor cores (3xTF32 in fp32, bf16 mma in bf16),
        # the taps on the CUDA cores in fp32
        mma = (3, TF32_FLOPS_PER_S) if dt == torch.float32 else (1, PEAK_FLOPS_PER_S[dt])
        return ((*mma, 2 * px * e * cin), (1, PEAK_FLOPS_PER_S[torch.float32], 2 * px * e * 9))

    def cases(dt):
        out = []
        blk = copy.deepcopy(block).to(dt).requires_grad_(False)
        args = blk.expand_dw_args()
        c72, e72 = args[0].shape
        for name, shape in CNV72_SHAPES:
            x = rn(*shape).to(dt)
            px = x[..., 0].numel()
            out.append(Case("expand_dw", name, lambda x=x: ED.expand_dw(x, *args),
                            lambda x=x: ED.expand_dw_plain(x, *args), (x, *args),
                            2 * px * e72 * (c72 + 9),
                            unfused=lambda x=x: blk.front_unfused(x),
                            own_path=own(dt, px, c72, e72)))
        x = rn(2, 13, 17, cin).to(dt)
        out.append(Case("expand_dw", "ragged", lambda: ED.expand_dw(x, *ragged),
                        lambda: ED.expand_dw_plain(x, *ragged), (x, *ragged),
                        2 * 2 * 13 * 17 * e * (cin + 9), own_path=own(dt, 2 * 13 * 17, cin, e)))
        return out

    return cases


def check_unfused_front(cases):
    """Phase 15b: at the cnv72 shapes in fp32, the kernel against the
    unfused front half it replaces (cuBLAS GEMM, cuDNN BN and depthwise):
    the same function by other sums, rel <= FP32_TOL."""
    bad = []
    for case in cases(torch.float32):
        if case.unfused is None:
            continue
        with torch.inference_mode():
            _, rel = rel_err(case.run(), case.unfused())
        log(f"  {'ok ' if rel <= FP32_TOL else 'BAD'} expand_dw {case.name:14s} vs the unfused "
            f"front half: rel {rel:.3e} (tol {FP32_TOL:g})")
        if rel > FP32_TOL:
            bad.append(case.name)
    if bad:
        raise SmokeError(f"expand_dw disagrees with the unfused front half: {bad}")


def compare_w_hybrid():
    """Phase 17: ACC_UNet_W (3 classes) with seeded weights, fp32. (a) 512x512
    b2 on the GPU with the hybrid on (expand_dw at cnv72) against off, same
    weights, logits and cnv72's output rel <= FP32_TOL; (b) b1 128x128 with
    hybrid_e_min=96 (expand_dw at the 10 unfused blocks cnv31-cnv72) on the
    GPU against the CPU (plain versions), rel <= MODEL_TOL. Returns the
    hybrid-off model (CPU) for phase 18."""
    from accunet_tpu_torch.ops.kernels.expand_dw import expand_dw

    off = seeded_model("ACC_UNet_W", W_CLASSES)
    on = seeded_model("ACC_UNet_W", W_CLASSES, hybrid_expand_dw=True)
    on.load_state_dict(off.state_dict())
    x = torch.randn(W_B, W_HW, W_HW, 3, device="cuda", generator=torch.Generator("cuda").manual_seed(17))
    res, outs = {}, {}
    for tag, m in (("off", off), ("on", on)):
        gpu = copy.deepcopy(m).cuda()
        before = expand_dw.launches
        with torch.inference_mode():
            outs[tag] = forward_with_taps(gpu, x)
        res[f"expand_dw_{tag}"] = expand_dw.launches - before
        del gpu
    if (res["expand_dw_off"], res["expand_dw_on"]) != (0, 1):
        raise SmokeError(f"expand_dw launches per forward off/on: {res}")
    _, res["logits_rel"] = rel_err(outs["on"][0], outs["off"][0])
    _, res["cnv72_rel"] = rel_err(outs["on"][1]["cnv72"], outs["off"][1]["cnv72"])
    log(f"  W b{W_B} {W_HW}x{W_HW}, hybrid on vs off on the GPU: logits rel {res['logits_rel']:.3e}, "
        f"cnv72 rel {res['cnv72_rel']:.3e} (tol {FP32_TOL:g}); expand_dw launches per forward "
        f"{res['expand_dw_on']} on, {res['expand_dw_off']} off")
    del outs
    torch.cuda.empty_cache()
    if max(res["logits_rel"], res["cnv72_rel"]) > FP32_TOL:
        raise SmokeError("ACC_UNet_W with the hybrid front half disagrees with the unfused one")

    all_e = seeded_model("ACC_UNet_W", W_CLASSES, hybrid_expand_dw=True, hybrid_e_min=96)
    xs = torch.from_numpy(np.random.default_rng(17).standard_normal((1, 128, 128, 3),
                                                                    dtype=np.float32))
    with torch.inference_mode():
        want, want_f = forward_with_taps(all_e, xs)
        before = expand_dw.launches
        got, got_f = forward_with_taps(copy.deepcopy(all_e).cuda(), xs.cuda())
        res["expand_dw_e_min_96"] = expand_dw.launches - before
    worst = max([rel_err(got, want)[1]] + [rel_err(got_f[n], want_f[n])[1] for n in TAPS])
    res["e_min_96_gpu_vs_cpu_rel"] = worst
    log(f"  W b1 128x128, hybrid_e_min=96 ({res['expand_dw_e_min_96']} expand_dw launches), GPU vs "
        f"CPU: logits and block outputs rel <= {worst:.3e} (tol {MODEL_TOL:g})")
    if res["expand_dw_e_min_96"] != 10 or worst > MODEL_TOL:
        raise SmokeError("ACC_UNet_W with hybrid_e_min=96 on the GPU disagrees with the CPU")
    return off, res


def time_w_model(model):
    """Phase 18a: ACC_UNet_W mc 512x512 b2 inference, fp32 and bf16, hybrid
    off and on (the same weights), in turns off, on, on, off; peak memory."""
    from accunet_tpu_torch.nn.acc_blocks import HANCBlock

    x = torch.randn(W_B, W_HW, W_HW, 3, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(18))
    rates = {}
    for dt in (torch.float32, torch.bfloat16):
        m = copy.deepcopy(model).to(device="cuda", dtype=dt)
        name = str(dt)[6:]
        for tag in ("off", "on", "on", "off"):
            for blk in m.modules():
                if isinstance(blk, HANCBlock):
                    blk.hybrid = tag == "on"
            torch.cuda.reset_peak_memory_stats()
            with torch.inference_mode():
                if not bool(m(x).isfinite().all()):
                    raise SmokeError(f"non-finite W output in {dt}, hybrid {tag}")
                ms = time_ms(lambda: m(x), iters=10, warmup=3)
            r = rates.setdefault(f"{name}_hybrid_{tag}", {"ms_per_batch": [], "img_per_s": []})
            r["ms_per_batch"].append(ms)
            r["img_per_s"].append(W_B * 1e3 / ms)
            r["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f"  ACC_UNet_W mc b{W_B} {W_HW}x{W_HW} {name} hybrid {tag:3s}: {ms:.3f} ms/batch, "
                f"{W_B * 1e3 / ms:.2f} img/s, peak {r['peak_mem_gib']:.2f} GiB")
        del m
        torch.cuda.empty_cache()
    return rates


# ------------------------------------------------------------------ UNeXt slice
# UNext at full width (stem 16/32/128, tokens 128/160/256), b8 224x224: the
# depthwise convs of its four ShiftedBlocks (3x3, C = the block's width) take
# their weight gradient from dwconv2d_wgrad, the only port kernel on its path
UNEXT_DW_SHAPES = (("block1_0", HW // 16, 160), ("block2_0", HW // 32, 256),
                   ("dblock1_0", HW // 16, 160), ("dblock2_0", HW // 8, 128))
UNEXT_TAPS = ("ebn3", "norm3", "norm4", "dnorm3", "dnorm4")
# the four distinct forwards of the seven ported UNext_CMRF names (_PP and
# _hd are UNext_CMRF's, _enc_dec_MLFC joins _enc_dec's decoder to the MLFC)
CMRF_TOPOLOGIES = ("UNext_CMRF", "UNext_CMRF_enc_dec", "UNext_CMRF_enc_MLFC",
                   "UNext_CMRF_dense_skip")
CMRF_TAPS = ("encoder3", "norm3", "norm4", "dnorm4")
CMRF_CMP_HW = 64
UNEXT_TRAIN_TOL = 1e-4  # compare_train_step says how it was found
HEADLINE_B = 1024  # the JAX bench's headline batch (bench.py:7-14)


def unext_wgrad_cases(dev):
    """Phase 19 and 24 cases: dwconv2d_wgrad at UNext b8 224x224's four
    ShiftedBlock shapes (x and g ~ N(0, 1))."""
    g = torch.Generator(device=dev).manual_seed(19)

    def cases(dt):
        return [wgrad_case(f"unext.{name}",
                           *(torch.randn(B, hw, hw, c, generator=g, device=dev).to(dt)
                             for _ in range(2)))
                for name, hw, c in UNEXT_DW_SHAPES]

    return cases


def unext_train_launches(steps, val_batches):
    """Per UNext train step: one dwconv2d_wgrad in each ShiftedBlock's
    depthwise backward (4); per validation forward nothing (the depthwise
    forward is cuDNN's grouped conv, as it is XLA's in JAX)."""
    zero = dict.fromkeys(KERNELS, 0)
    return {"train_steps": {**zero, "dwconv2d_wgrad": 4 * steps}, "validation": zero}


def seeded_unext(name="UNext", **kw):
    """A UNeXt-family model (3 channels, 1 class, logits) with the JAX
    initialisers and its BNs moved off their init values, eval mode, CPU."""
    from accunet_tpu_torch.models import build, init_parameters

    model = init_parameters(build(name, n_channels=3, n_classes=1, final_sigmoid=False, **kw),
                            torch.Generator().manual_seed(0))
    return seeded_bns(model, 20).eval()


# ------------------------------------------------------------ Spatial-Mamba slice
# The Spatial-Mamba Segmamba variant (no text) at full width, b8 224x224: feat
# 48/96/192/384, d_state 16, expand 2, depths 2; each stage-i SpatialMambaBlock
# runs one return-hidden scan over L = (112 / 2^i)^2 steps and D = 2 * feat_i
# (h: B x L x D x 16 floats, 616.6 MB at stage 0). Trained with 2 classes: the
# binary loss takes no deep-supervision tuple, in JAX as here.
SPM_VARIANT = "Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn_HSLCA_SpatialMamba_no_text"
SPM_CLASSES = 2
RH_PER_FORWARD = 8
# (name, B, L, D, N): the variant's four stages; BASELINE config 5's block
# (bench.py:118-148: SpatialMambaBlock b8, 56x56, C 64, d_state 16); the
# classifier's default d_state 1 at its first stage (224x224: 56x56, C 64);
# the kernels' edges: L below one 128-step chunk with D 20 (a partial
# cluster of 8 d), N 1 with L 1000 (a partial chunk) and D 40 (5 CTAs of 8
# d, no cluster), N 3 (lanes padded to 4) with L 129 (one step past a
# chunk) and D 9 (a partial CTA); last, an odd shape (L 300: a partial
# chunk; D 13: a partial CTA and cluster)
RH_SHAPES = tuple((f"stage{i}", B, (HW // 2 >> i) ** 2, 2 * f, N_STATES)
                  for i, f in enumerate(SM_FEAT)) + (
    ("config5", B, 56 * 56, 128, N_STATES), ("n1", B, 56 * 56, 128, 1),
    ("short", 2, 100, 20, N_STATES), ("n1_edge", 2, 1000, 40, 1), ("n3_edge", 2, 129, 9, 3),
    ("odd", 3, 300, 13, 16))
SPM_CMP_HW = 64
SPM_TAPS = ("vit.gscs.0", "vit.stages.0.1", "vit.stages.3.1", "encoder5", "decoder1",
            "final_refine_kan_mlp")
# compare_spm_train_step says how they are held: the loss, and the gradients
# as a whole, whose fp32 spread in this model is set by the library's convs,
# not by the scans: 2.8e-3 of the largest gradient on the CPU at b2 32x32
# (decoder4's and the GSC's conv weights, the stem), 1.87e-3 on the H100 at
# b2 64x64 (the GSC's proj2 weight, where the CPU's fp32 step is at 4e-7;
# cuDNN took FFT algorithms for some of those convs there)
SPM_TRAIN_LOSS_TOL, SPM_TRAIN_TOL = 1e-4, 5e-3


def rh_inputs(g, b, l, d, n):
    """The rh kernels' operands as StructureAwareSSM hands them: u =
    silu(N(0, 1)), delta N(0, 0.5^2) before its softplus, A = -(1..N) per
    row (the init), B ~ N(0, 1), bias ~ N(0, 0.1^2); and a cotangent gh ~
    N(0, 1) of h (B, L, D, N)."""
    def rn(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * s

    ops = (F.silu(rn(b, d, l)), rn(b, d, l, s=0.5),
           -torch.arange(1, n + 1, device="cuda", dtype=torch.float32).expand(d, n).contiguous(),
           rn(b, n, l), rn(d, s=0.1))
    return ops, rn(b, l, d, n)


def check_rh_scan():
    """Phase 25: selective_scan_rh_fwd (h, and the chunk states against
    selective_scan_rh_states_plain) and selective_scan_rh_bwd (du, ddelta,
    dA, dB, dbias) against their plain versions at RH_SHAPES, softplus and
    bias on as StructureAwareSSM runs them, rel <= FP32_TOL; the backward's
    outputs bitwise equal on a second call and with the cotangent laid out
    as (B, D, N, L); the library's geometry (which sized the buffers) equal
    to its plain mirror. Returns {kernel: max abs error vs plain}."""
    from accunet_tpu_torch.ops.kernels import selective_scan as SS

    g = torch.Generator("cuda").manual_seed(25)
    worst, bad = {"selective_scan_rh_fwd": 0.0, "selective_scan_rh_bwd": 0.0}, []
    for name, b, l, d, n in RH_SHAPES:
        ops, gh = rh_inputs(g, b, l, d, n)
        h, states = SS.selective_scan_rh_fwd(*ops, True, save_states=True)
        grads = SS.selective_scan_rh_bwd(*ops, True, states, gh)
        again = SS.selective_scan_rh_bwd(*ops, True, states, gh)
        dnl = SS.selective_scan_rh_bwd(*ops, True, states,
                                       gh.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2))
        torch.cuda.synchronize()
        same = all(torch.equal(p, q) and torch.equal(p, r) for p, q, r in zip(grads, again, dnl))
        del again, dnl
        want = SS.selective_scan_rh_fwd_plain(*ops, True)
        f_errs = [rel_err(h, want)]
        del want
        # the state entering each chunk; the geometry the wrappers sized it by
        f_errs.append(rel_err(states, SS.selective_scan_rh_states_plain(*ops, True)))
        geo = SS.rh_geometry(d, l, n)
        if geo != SS.rh_geometry_plain(d, l, n) or states.shape[2] != geo.n_chunks:
            raise SmokeError(f"rh geometry of {name}: the library's {geo}, the plain mirror's "
                             f"{SS.rh_geometry_plain(d, l, n)}, states {tuple(states.shape)}")
        del h
        torch.cuda.empty_cache()
        want = SS.selective_scan_rh_bwd_plain(*ops, True, gh)
        b_errs = {k: rel_err(p, q) for k, p, q in zip(("du", "ddelta", "dA", "dB", "dbias"),
                                                     grads, want)}
        rel = max([e[1] for e in f_errs] + [e[1] for e in b_errs.values()])
        ok = rel <= FP32_TOL and same
        worst["selective_scan_rh_fwd"] = max(worst["selective_scan_rh_fwd"],
                                             max(e[0] for e in f_errs))
        worst["selective_scan_rh_bwd"] = max(worst["selective_scan_rh_bwd"],
                                             max(e[0] for e in b_errs.values()))
        log(f"  {'ok ' if ok else 'BAD'} selective_scan_rh {name:7s} B{b} L{l:5d} D{d:3d} N{n:2d}: "
            f"h rel {f_errs[0][1]:.3e}, chunk states "
            f"{f_errs[1][1] if len(f_errs) > 1 else 0.0:.3e}; "
            + ", ".join(f"{k} {v[1]:.3e}" for k, v in b_errs.items())
            + f" (tol {FP32_TOL:g}); backward bitwise on a second call and from a (B, D, N, "
            f"L) cotangent {same}")
        if not ok:
            bad.append(name)
        del ops, gh, states, grads, want
        torch.cuda.empty_cache()
    if bad:
        raise SmokeError(f"the return-hidden scan disagrees with its plain versions: {bad}")
    return worst


def check_rh_autograd():
    """Phase 26: SelectiveScanRhFn's gradients (both rh kernels) against
    autograd through selective_scan_rh_fwd_plain, at stage 2's shape and the
    odd one, with the cotangent in h's own strides, in the (B, D, N, L)
    order of JAX's h (both read as they lie) and in (B, N, L, D) order
    (copied once, counted in gh_copies)."""
    from accunet_tpu_torch.ops.kernels.selective_scan import (SelectiveScanRhFn,
                                                              selective_scan_rh_fwd_plain)

    g = torch.Generator("cuda").manual_seed(26)
    bad = []
    for name, b, l, d, n in (RH_SHAPES[2], RH_SHAPES[-1]):
        ops, gh = rh_inputs(g, b, l, d, n)
        ops = [t.requires_grad_(True) for t in ops]
        want = torch.autograd.grad(selective_scan_rh_fwd_plain(*ops, True), ops, gh)
        for order, copied in (((0, 1, 2, 3), 0), ((0, 2, 3, 1), 0), ((0, 3, 1, 2), 1)):
            copies = SelectiveScanRhFn.gh_copies
            h = SelectiveScanRhFn.apply(*ops, True)
            got = torch.autograd.grad(h.permute(*order).contiguous(), ops,
                                      gh.permute(*order).contiguous())
            rel = max(rel_err(p, q)[1] for p, q in zip(got, want))
            ok = rel <= FP32_TOL and SelectiveScanRhFn.gh_copies == copies + copied
            log(f"  {'ok ' if ok else 'BAD'} SelectiveScanRhFn {name} B{b} L{l} D{d} N{n}, "
                f"cotangent in dims order {order}: grads rel {rel:.3e} (tol {FP32_TOL:g}), gh "
                f"copies {SelectiveScanRhFn.gh_copies - copies}")
            if not ok:
                bad.append(f"{name} order={order}")
    if bad:
        raise SmokeError(f"SelectiveScanRhFn disagrees with autograd of the plain forward: {bad}")


def spm_model(n_classes=SPM_CLASSES):
    """The Spatial-Mamba variant at full width and depth (3 channels in,
    n_classes out), seeded with the JAX package's initialisers, eval mode,
    on the CPU."""
    from accunet_tpu_torch.models import build, init_parameters

    return init_parameters(build(SPM_VARIANT, in_chans=3, out_chans=n_classes),
                           torch.Generator().manual_seed(0)).eval()


class PlainRhScan:
    """SelectiveScanRhFn's stand-in through the plain forward."""

    @staticmethod
    def apply(*args):
        from accunet_tpu_torch.ops.kernels.selective_scan import selective_scan_rh_fwd_plain

        return selective_scan_rh_fwd_plain(*args)


@contextlib.contextmanager
def plain_rh_scan():
    """Route selective_scan_rh through selective_scan_rh_fwd_plain instead
    of the rh kernels."""
    from accunet_tpu_torch.ops import selective_scan as SS

    kernel = SS.SelectiveScanRhFn
    SS.SelectiveScanRhFn = PlainRhScan
    try:
        yield
    finally:
        SS.SelectiveScanRhFn = kernel


def forward_tuple_taps(model, x, taps):
    """(outputs as a tuple on the CPU, {tap: module output on the CPU})."""
    feats = {}
    hooks = [model.get_submodule(n).register_forward_hook(
        lambda mod, inp, out, n=n: feats.__setitem__(n, out.float().cpu())) for n in taps]
    try:
        out = model(x)
    finally:
        for h in hooks:
            h.remove()
    out = out if isinstance(out, tuple) else (out,)
    return tuple(o.float().cpu() for o in out), feats


def compare_spm(model):
    """Phase 28a/b: the variant b8 224x224 fp32 on the GPU through the rh
    kernels vs the same GPU model through selective_scan_rh_fwd_plain (its
    four outputs and the taps, rel <= FP32_TOL); then full width, b1 64x64,
    GPU vs CPU (plain versions), rel <= MODEL_TOL."""
    from accunet_tpu_torch.ops.kernels.selective_scan import selective_scan_rh_fwd

    gpu = copy.deepcopy(model).cuda()
    x = torch.randn(B, HW, HW, 3, device="cuda", generator=torch.Generator("cuda").manual_seed(28))
    with torch.inference_mode():
        before = selective_scan_rh_fwd.launches
        got, got_f = forward_tuple_taps(gpu, x, SPM_TAPS)
        n_kernel = selective_scan_rh_fwd.launches - before
        with plain_rh_scan():
            want, want_f = forward_tuple_taps(gpu, x, SPM_TAPS)
        n_plain = selective_scan_rh_fwd.launches - before - n_kernel
    if (n_kernel, n_plain) != (RH_PER_FORWARD, 0):
        raise SmokeError(f"selective_scan_rh_fwd launches: the kernel forward {n_kernel}, the "
                         f"plain one {n_plain}")
    errs = {n: rel_err(got_f[n], want_f[n])[1] for n in SPM_TAPS}
    errs.update({f"out{i}": rel_err(p, q)[1] for i, (p, q) in enumerate(zip(got, want))})
    worst = max(errs.values())
    log(f"  b{B} {HW}x{HW}, rh kernels vs the plain rh scan on the GPU ({n_kernel} "
        f"selective_scan_rh_fwd launches): "
        + ", ".join(f"{k} rel {v:.3e}" for k, v in errs.items())
        + f" (|logit| <= {float(want[0].abs().max()):.3g}, tol {FP32_TOL:g})")
    del gpu, got, want, got_f, want_f
    torch.cuda.empty_cache()
    if worst > FP32_TOL:
        raise SmokeError("the variant through the rh kernels disagrees with the plain scan")
    xs = torch.from_numpy(np.random.default_rng(29).standard_normal(
        (1, SPM_CMP_HW, SPM_CMP_HW, 3), dtype=np.float32))
    with torch.inference_mode():
        t0 = time.perf_counter()
        want, want_f = forward_tuple_taps(model, xs, SPM_TAPS)
        cpu_s = time.perf_counter() - t0
        got, got_f = forward_tuple_taps(copy.deepcopy(model).cuda(), xs.cuda(), SPM_TAPS)
    errs = {n: rel_err(got_f[n], want_f[n])[1] for n in SPM_TAPS}
    errs.update({f"out{i}": rel_err(p, q)[1] for i, (p, q) in enumerate(zip(got, want))})
    rel = max(errs.values())
    log(f"  b1 {SPM_CMP_HW}x{SPM_CMP_HW}, GPU vs CPU: " + ", ".join(
        f"{k} rel {v:.3e}" for k, v in errs.items()) + f" (tol {MODEL_TOL:g}); CPU forward "
        f"{cpu_s:.1f} s")
    if rel > MODEL_TOL:
        raise SmokeError("the variant on the GPU disagrees with the CPU")
    return {"kernel_vs_plain_rel": worst, "gpu_vs_cpu_rel": rel}


def spm_loss_fns():
    from accunet_tpu_torch.train import losses as L
    from accunet_tpu_torch.train import metrics as M

    return dict(loss_fn=L.multiclass_dice_ce, dice_show=L.multiclass_dice_show,
                iou_fn=M.multiclass_batch_iou)


class RhTaps:
    """Routes selective_scan_rh through a tap that keeps, for every
    return-hidden scan of a step, its operands and the cotangent of its h,
    so that the rh kernels' gradients in the step can be held against the
    plain backward of the same operands (as DepthwiseTaps holds the wgrad)."""

    def __init__(self):
        from accunet_tpu_torch.ops import selective_scan as OSS

        self.module, self.fn, self.calls = OSS, OSS.SelectiveScanRhFn, []
        taps = self

        class Tap:
            @staticmethod
            def apply(*args):
                h = taps.fn.apply(*args)
                rec = {"ops": [a.detach().contiguous() if isinstance(a, torch.Tensor) else a
                               for a in args[:-1]], "softplus": args[-1]}
                h.register_hook(lambda g: rec.__setitem__("gh", g.detach().contiguous()))
                taps.calls.append(rec)
                return h

        OSS.SelectiveScanRhFn = Tap

    def worst(self):
        """(largest rel error of the rh kernels' five gradients vs the plain
        backward over the step's scans, the number of scans)."""
        from accunet_tpu_torch.ops.kernels import selective_scan as SS

        self.module.SelectiveScanRhFn = self.fn
        errs = []
        for i, rec in enumerate(self.calls):
            ops, sp = rec["ops"], rec["softplus"]
            _, states = SS.selective_scan_rh_fwd(*ops, sp, save_states=True)
            got = SS.selective_scan_rh_bwd(*ops, sp, states, rec["gh"])
            want = SS.selective_scan_rh_bwd_plain(*ops, sp, rec["gh"])
            errs += [(rel_err(p, q)[1], f"scan {i} {k}") for k, p, q in
                     zip(("du", "ddelta", "dA", "dB", "dbias"), got, want) if q is not None]
        return max(errs), len(self.calls)


def compare_spm_train_step(b=2, hw=SPM_CMP_HW):
    """Phase 28c: one train step of the variant at full width, b2 64x64
    (multiclass_dice_ce over its four heads, backward, Adam), on the GPU in
    fp32 (rh kernels), held against the same step on the CPU in float64
    (plain versions), with the CPU's fp32 step as the control:
      * the loss to SPM_TRAIN_LOSS_TOL relative;
      * every rh scan's five gradients in the GPU step to FP32_TOL of the
        plain backward of that scan's own operands and cotangent (RhTaps):
        this holds the kernels in the step whatever the step's rounding;
      * the gradients as a whole (the largest error over the largest
        float64 gradient) within twice the control's gap or SPM_TRAIN_TOL:
        the library's conv weight gradients carry most of the fp32 spread
        (SPM_TRAIN_TOL's note); the largest parameters are printed.
    The model has no BatchNorm (instance norms only)."""
    from accunet_tpu_torch.train.engine import make_train_fns

    base = spm_model()
    rs = np.random.default_rng(30)
    x = torch.from_numpy(rs.random((b, hw, hw, 3), dtype=np.float32))
    mask = torch.from_numpy(rs.integers(0, SPM_CLASSES + 1, (b, hw, hw, 1)).astype(np.float32))
    res = {}
    for tag, d, dt in (("gpu", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                       ("cpu64", "cpu", torch.float64)):
        t0 = time.perf_counter()
        model = copy.deepcopy(base).to(device=d, dtype=dt)
        taps = RhTaps() if tag == "gpu" else None
        fns = make_train_fns(model, **spm_loss_fns())
        _, stats = fns.train_step(fns.state, {"image": x.to(d, dt), "mask": mask.to(d, dt)})
        res[tag] = (float(stats["loss"]),
                    {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()
                     if p.grad is not None})
        if taps is not None:
            rh_err, n_rh = taps.worst()
        log(f"  {tag:5s} loss {res[tag][0]:.8f} ({time.perf_counter() - t0:.1f} s)")

    want = res["cpu64"][1]
    scale = max(float(t.abs().max()) for t in want.values())

    def per_param(tag):
        return {n: float((res[tag][1][n] - t).abs().max()) / scale for n, t in want.items()}

    gpu_p, cpu_p = per_param("gpu"), per_param("cpu")
    out = {"loss_rel": abs(res["gpu"][0] - res["cpu64"][0]) / abs(res["cpu64"][0]),
           "grad_gap_gpu": max(gpu_p.values()), "grad_gap_cpu": max(cpu_p.values()),
           "loss_rel_cpu": abs(res["cpu"][0] - res["cpu64"][0]) / abs(res["cpu64"][0]),
           "rh_vs_plain": rh_err[0], "rh_worst": rh_err[1], "rh_scans": n_rh}
    top = sorted(gpu_p, key=gpu_p.get, reverse=True)[:6]
    log(f"  vs the float64 CPU step, GPU (CPU fp32 control): loss rel {out['loss_rel']:.3e} "
        f"({out['loss_rel_cpu']:.3e}); gradients over the largest ({scale:.3e}) "
        f"{out['grad_gap_gpu']:.3e} ({out['grad_gap_cpu']:.3e}); tol {SPM_TRAIN_LOSS_TOL:g} / "
        f"{SPM_TRAIN_TOL:g}. "
        f"{n_rh} rh scans' gradients vs the plain backward of the step's operands: rel "
        f"{rh_err[0]:.3e} at {rh_err[1]}")
    log("  largest per parameter, GPU (CPU fp32): " + ", ".join(
        f"{n} {gpu_p[n]:.2e} ({cpu_p[n]:.2e})" for n in top))
    if (out["loss_rel"] > SPM_TRAIN_LOSS_TOL or out["rh_vs_plain"] > FP32_TOL
            or out["grad_gap_gpu"] > max(2 * out["grad_gap_cpu"], SPM_TRAIN_TOL)):
        raise SmokeError("the variant's train step on the GPU disagrees with the float64 CPU step")
    return out


def compare_classifier():
    """Phase 28d: the SpatialMamba classifier (depths 1, 1, 1, 1, its
    published widths 64-512, 10 classes) with seeded BN statistics, b1
    224x224, GPU vs CPU, at d_state 1 (its default) and 16: the logits and
    each stage's output (Backbone_SpatialMamba's return_features), rel <=
    MODEL_TOL."""
    from accunet_tpu_torch.models import build, init_parameters

    out = {}
    x = torch.from_numpy(np.random.default_rng(31).standard_normal((1, HW, HW, 3),
                                                                   dtype=np.float32))
    for name, d_state in (("SpatialMamba", 1), ("Backbone_SpatialMamba", 16)):
        model = seeded_bns(init_parameters(
            build(name, n_channels=3, num_classes=10, depths=(1, 1, 1, 1), d_state=d_state),
            torch.Generator().manual_seed(0)), 31).eval()
        gpu = copy.deepcopy(model).cuda()
        with torch.inference_mode():
            want = (model(x), *model(x, return_features=True))
            got = (gpu(x.cuda()), *gpu(x.cuda(), return_features=True))
        errs = [rel_err(p.cpu(), q)[1] for p, q in zip(got, want)]
        out[f"{name}_n{d_state}"] = max(errs)
        log(f"  {name} d_state {d_state} b1 {HW}x{HW}, GPU vs CPU: logits rel {errs[0]:.3e}, "
            f"stages rel " + ", ".join(f"{e:.3e}" for e in errs[1:]) + f" (tol {MODEL_TOL:g})")
        if max(errs) > MODEL_TOL:
            raise SmokeError(f"{name} (d_state {d_state}) on the GPU disagrees with the CPU")
    return out


def spm_train_launches(steps, val_batches):
    """Per train step of the variant: 8 rh forwards (2 blocks x 4 stages) and
    their 8 rh backwards; per validation forward 8 rh forwards; nothing else
    of the port's kernels (its depthwise convs are cuDNN's, as JAX's are
    XLA's, so no dwconv2d_wgrad)."""
    zero = dict.fromkeys(KERNELS, 0)
    return {"train_steps": {**zero, "selective_scan_rh_fwd": RH_PER_FORWARD * steps,
                            "selective_scan_rh_bwd": RH_PER_FORWARD * steps},
            "validation": {**zero, "selective_scan_rh_fwd": RH_PER_FORWARD * val_batches}}


def time_spm(model):
    """Phase 29a/b: the variant b8 224x224 fp32 inference and train step
    (multiclass_dice_ce over its four heads, backward, Adam), CUDA events,
    10 iterations after 3 warm-up, with peak memory, the rh launches per
    step and the copies SelectiveScanRhFn makes of a cotangent that reaches
    it in other strides than h's; then BASELINE config 5's SpatialMambaBlock (b8 56x56, C 64,
    d_state 16) forward in img/s."""
    from accunet_tpu_torch.nn.ssm import SpatialMambaBlock
    from accunet_tpu_torch.models import init_parameters
    from accunet_tpu_torch.ops.kernels.selective_scan import (SelectiveScanRhFn,
                                                              selective_scan_rh_bwd,
                                                              selective_scan_rh_fwd)
    from accunet_tpu_torch.train.engine import make_train_fns

    g = torch.Generator("cuda").manual_seed(32)
    x = torch.rand(B, HW, HW, 3, generator=g, device="cuda")
    m = copy.deepcopy(model).cuda()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        ms = time_ms(lambda: m(x), iters=10, warmup=3)
    out = {"inference_fp32": {"ms_per_batch": ms, "img_per_s": B * 1e3 / ms,
                              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}}
    fns = make_train_fns(m.train(), **spm_loss_fns())
    batch = {"image": x, "mask": torch.randint(0, SPM_CLASSES + 1, (B, HW, HW, 1), generator=g,
                                               device="cuda").float()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = (selective_scan_rh_fwd.launches, selective_scan_rh_bwd.launches,
              SelectiveScanRhFn.gh_copies)
    ms = time_ms(lambda: fns.train_step(fns.state, batch), iters=10, warmup=3)
    per_step = ((selective_scan_rh_fwd.launches - counts[0]) / 13,
                (selective_scan_rh_bwd.launches - counts[1]) / 13,
                (SelectiveScanRhFn.gh_copies - counts[2]) / 13)
    _, stats = fns.train_step(fns.state, batch)
    if not bool(torch.isfinite(stats["loss"])):
        raise SmokeError("non-finite loss in the timed train step of the variant")
    out["train_step_fp32"] = {"ms_per_step": ms, "img_per_s": B * 1e3 / ms,
                              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del m, fns, batch
    torch.cuda.empty_cache()
    blk = init_parameters(SpatialMambaBlock(64, d_state=N_STATES),
                          torch.Generator().manual_seed(1)).cuda().eval()
    xb = torch.randn(B, 56, 56, 64, generator=g, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        ms = time_ms(lambda: blk(xb), iters=20, warmup=3)
    out["config5_block_fp32"] = {"ms_per_batch": ms, "img_per_s": B * 1e3 / ms,
                                 "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    i, t, c = out["inference_fp32"], out["train_step_fp32"], out["config5_block_fp32"]
    log(f"  {SPM_VARIANT} b{B} {HW}x{HW} fp32 inference: {i['ms_per_batch']:.3f} ms/batch, "
        f"{i['img_per_s']:.1f} img/s, peak {i['peak_mem_gib']:.2f} GiB; train step "
        f"{t['ms_per_step']:.3f} ms/step, {t['img_per_s']:.1f} img/s, peak "
        f"{t['peak_mem_gib']:.2f} GiB; per step selective_scan_rh_fwd {per_step[0]:g}, "
        f"selective_scan_rh_bwd {per_step[1]:g}, copies of a strided cotangent of h "
        f"{per_step[2]:g}")
    log(f"  SpatialMambaBlock (BASELINE config 5: b{B} 56x56 C64 d_state 16) fp32 forward: "
        f"{c['ms_per_batch']:.3f} ms/batch, {c['img_per_s']:.1f} img/s, peak "
        f"{c['peak_mem_gib']:.2f} GiB")
    del blk, xb
    torch.cuda.empty_cache()
    return out


def time_rh_scan():
    """Phase 29c: at each of RH_SHAPES but the odd one, selective_scan_rh_fwd
    (as inference runs it: no chunk states) and selective_scan_rh_bwd (as
    the train step runs it: from the forward's chunk states, with the
    cotangent laid out as (B, D, N, L), the order StateFusion's conv
    backward hands it over; the kernel's own (B, L, D, N) layout beside it)
    against their plain versions and the least time the card could take:
    each input read once and each output written once at 3.35 TB/s (h or
    gh, B x L x D x N floats, is most of it), or the fp32 operations (5 a
    (t, n) forward, 18 backward) at 67 TFLOP/s. No single PyTorch call
    computes the scan."""
    from accunet_tpu_torch.ops.kernels import selective_scan as SS

    g = torch.Generator("cuda").manual_seed(33)
    times = {}
    for name, b, l, d, n in RH_SHAPES[:-1]:
        ops, gh = rh_inputs(g, b, l, d, n)
        pairs = b * l * d * n
        with torch.inference_mode():
            _, states = SS.selective_scan_rh_fwd(*ops, True, save_states=True)
        gh_dnl = gh.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
        cases = {
            "selective_scan_rh_fwd": Case(
                "selective_scan_rh_fwd", name, lambda: SS.selective_scan_rh_fwd(*ops, True),
                lambda: SS.selective_scan_rh_fwd_plain(*ops, True), (*ops,), 5 * pairs),
            "selective_scan_rh_bwd": Case(
                "selective_scan_rh_bwd", name,
                lambda: SS.selective_scan_rh_bwd(*ops, True, states, gh_dnl),
                lambda: SS.selective_scan_rh_bwd_plain(*ops, True, gh_dnl),
                (*ops, states, gh_dnl), 18 * pairs),
            "selective_scan_rh_bwd.bldn": Case(
                "selective_scan_rh_bwd", name,
                lambda: SS.selective_scan_rh_bwd(*ops, True, states, gh),
                lambda: SS.selective_scan_rh_bwd_plain(*ops, True, gh), (*ops, states, gh),
                18 * pairs),
        }
        with torch.inference_mode():
            for kname, case in cases.items():
                out = case.run()
                bound, bound_by = bound_ms(case, out)
                del out
                k_ms = time_ms(case.run)
                p_ms = time_ms(case.plain, iters=3, warmup=1)
                times[(kname, name)] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": None,
                                        "bound_ms": bound, "bound_by": bound_by}
                log(f"  {kname:24s} {name:7s} B{b} L{l:5d} D{d:3d} N{n:2d}: kernel {k_ms:8.3f} ms"
                    f"   plain {p_ms:8.3f} ms   bound {bound:7.3f} ms ({bound_by}), "
                    f"{100 * bound / k_ms:.1f}% of it")
        del ops, gh, gh_dnl, states, cases
        torch.cuda.empty_cache()
    return times


# ------------------------------------------------- the train and eval harness
# bf16 training: `--set train.compute_dtype=bfloat16` builds ACC-UNet and
# UNeXt models with dtype=torch.bfloat16 (fp32 parameters and Adam state cast
# at use, BatchNorm statistics in fp32): hanc_mix, the depthwise backward's
# dwconv2d_wgrad and, in the validation forwards, hanc_block and
# respath_level run their bf16 paths
BF16_SET = ("--set", "train.compute_dtype=bfloat16")
# a bf16 train step, GPU vs CPU, each against the float64 step: twice the
# CPU bf16 step's distance or this (compare_train_step says why)
BF16_TRAIN_TOL = 3e-2
# Seg-Grad-CAM at cnv12, whose gradient passes back through every fused and
# unfused kernel's autograd function: rspth1's and rspth2's fused levels, the
# fused cnv21 -> cnv22 pair (chained pre), the unfused blocks' HANC mixes and
# the fused decoder pairs; GPU vs CPU at b2 64x64, max abs error of the [0, 1]
# maps (with the seeded weights a CAM at cnv22 or cnv81 is 0 everywhere, at
# cnv12 it spans 0..0.97 on the CPU)
CAM_LAYER, CAM_HW, CAM_TOL = "cnv12", 64, 1e-3


def with_zeros(want_fn):
    """`want_fn` with every other kernel of KERNELS at 0 in both counts."""
    def want(steps, val_batches):
        return {split: {**dict.fromkeys(KERNELS, 0), **c}
                for split, c in want_fn(steps, val_batches).items()}
    return want


def check_bf16_train_kernels():
    """Phase 30c: one bf16 train step of ACC_UNet (n_filts 32, b8 224x224)
    with every hanc_mix and dwconv2d_wgrad launch recorded: each launch's
    output against its plain version on the same bf16 inputs (BF16_TOL).
    Returns {kernel: max abs error}."""
    from accunet_tpu_torch.ops.kernels import dwconv2d as DW
    from accunet_tpu_torch.ops.kernels import hanc_mix as HM
    from accunet_tpu_torch.train.engine import make_train_fns

    calls = []
    mix, wgrad = HM.hanc_mix, DW.dwconv2d_wgrad

    def rec_mix(x, w, bias, k, tile=0):
        y = mix(x, w, bias, k, tile)
        calls.append(("hanc_mix", (x, w, bias, k), y))
        return y

    def rec_wgrad(x, g, kh, kw, bias_grad=False, plan=None):
        out = wgrad(x, g, kh, kw, bias_grad, plan)
        calls.append(("dwconv2d_wgrad", (x, g, kh, kw, bias_grad), out))
        return out

    # the kernel wrappers count their launches on the module-level name
    rec_mix.launches = rec_wgrad.launches = 0
    model = acc_unet().cuda()
    model.dtype = torch.bfloat16
    fns = make_train_fns(model)
    g = torch.Generator("cuda").manual_seed(30)
    batch = {"image": torch.rand(B, HW, HW, 3, generator=g, device="cuda"),
             "mask": (torch.rand(B, HW, HW, 1, generator=g, device="cuda") > 0.5).float()}
    HM.hanc_mix, DW.dwconv2d_wgrad = rec_mix, rec_wgrad
    try:
        _, stats = fns.train_step(fns.state, batch)
        torch.cuda.synchronize()
    finally:
        HM.hanc_mix, DW.dwconv2d_wgrad = mix, wgrad
    if not bool(torch.isfinite(stats["loss"])):
        raise SmokeError("non-finite loss in the bf16 train step")
    worst, shapes, bad = {}, {}, []
    with torch.no_grad():
        for kname, args, got in calls:
            if args[0].dtype != torch.bfloat16:
                raise SmokeError(f"{kname} ran on {args[0].dtype} in the bf16 train step")
            if kname == "hanc_mix":
                want = HM.hanc_mix_reference(*args)
            else:
                x, gy, kh, kw, with_db = args
                want = DW.dwconv2d_wgrad_reference(x, gy, kh, kw)
                want = (want, gy.float().sum(dim=(0, 1, 2))) if with_db else want
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            errs = [rel_err(a, b) for a, b in zip(got, want)]
            abs_err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
            worst[kname] = max(worst.get(kname, 0.0), abs_err)
            shapes.setdefault(kname, []).append(f"{tuple(args[0].shape)} rel {rel:.2e}")
            if rel > BF16_TOL:
                bad.append(f"{kname} {tuple(args[0].shape)} rel {rel:.3e}")
    counts = {k: len(v) for k, v in shapes.items()}
    for kname, lines in shapes.items():
        log(f"  bf16 step: {kname} x{len(lines)}: " + "; ".join(lines))
    if counts != {"hanc_mix": 16, "dwconv2d_wgrad": 18} or bad:
        raise SmokeError(f"bf16 train step kernels: {counts} launches (16 / 18 expected), "
                         f"disagreeing with their plain versions: {bad}")
    log(f"  every launch within {BF16_TOL:g} of its plain version; max abs errors {worst}")
    return worst


def run_gradcam_cli(counters, layer=CAM_LAYER, n=2 * B):
    """Phase 32a: the gradcam entry point on a synthetic ISIC-style folder of
    n 224x224 images, ACC_UNet full width with seeded weights, batch 8, the
    CAM at `layer`: a .npz per image (and a .png where PIL imports) with a
    finite CAM in [0, 1], and per batch the one eval forward's launches.
    Returns (launches, seconds)."""
    from accunet_tpu_torch.cli import gradcam as cli

    with tempfile.TemporaryDirectory() as tmp:
        write_folder(os.path.join(tmp, "data"), n, HW)
        out = os.path.join(tmp, "cam")
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        done = cli.main(["--model", "ACC_UNet", "--test-dir", os.path.join(tmp, "data"),
                         "--img-size", str(HW), "--batch", str(B), "--layer", layer,
                         "--out-dir", out, "--device", "cuda"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        files = sorted(os.listdir(out))
        npz = [f for f in files if f.endswith(".npz")]
        if done != n or len(npz) != n or len(files) not in (n, 2 * n):
            raise SmokeError(f"gradcam wrote {files} for {n} images ({done} reported)")
        for f in npz:
            cam = np.load(os.path.join(out, f))["cam"]
            if cam.shape != (HW, HW) or not np.isfinite(cam).all() or cam.min() < 0 \
                    or cam.max() > 1:
                raise SmokeError(f"{f}: CAM {cam.shape} not finite in [0, 1]")
    batches = -(-n // B)
    want = {k: EVAL_LAUNCHES.get(k, 0) * batches for k in launches}
    if launches != want:
        raise SmokeError(f"the gradcam path launched {launches}, expected {want}")
    log(f"  gradcam CLI, ACC_UNet b{B} {HW}x{HW}, layer {layer}: {n} CAMs ({len(files)} files) "
        f"in {seconds:.2f} s ({seconds / batches:.2f} s a batch); launches {launches} in "
        f"{batches} batches")
    return launches, seconds


def compare_cam(layer=CAM_LAYER):
    """Phase 32b: Seg-Grad-CAM of the seeded ACC_UNet (logits, fp32) at b2
    CAM_HW x CAM_HW on the GPU (fused kernels forward, their plain versions'
    VJPs backward) against the same CAM on the CPU (plain versions): max abs
    error of the [0, 1] maps <= CAM_TOL."""
    from accunet_tpu_torch.eval.gradcam import seg_grad_cam

    model = seeded_model()
    x = torch.from_numpy(np.random.default_rng(32).standard_normal((2, CAM_HW, CAM_HW, 3),
                                                                  dtype=np.float32))
    want = seg_grad_cam(model, x, layer)
    got = seg_grad_cam(copy.deepcopy(model).cuda(), x.cuda(), layer).cpu()
    err = float((got - want).abs().max())
    log(f"  CAM at {layer}, b2 {CAM_HW}x{CAM_HW}, GPU vs CPU: max abs err {err:.3e} (limit "
        f"{CAM_TOL:g}; maps in [0, 1], CPU range {float(want.min()):.3f}..{float(want.max()):.3f})")
    if not bool(got.isfinite().all()) or err > CAM_TOL:
        raise SmokeError("the CAM on the GPU disagrees with the CPU")
    return err


def check_eval_fns(dev, ed_cases):
    """Phase 32c: the fused eval kernels' autograd functions on the card at
    the model's own shapes (phase 3's and 15's cases, fp32): HancBlockFn
    (cnv12, cnv22 with cnv21's chained pre, cnv81, cnv91), RespathLevelFn
    (rspth1 levels 0 and 1, rspth2 level 1) and ExpandDwFn (cnv72 of b8
    224x224 and of W b2 512x512): the gradient of every tensor input (x, the
    pre, the weights, the SE inputs) for random cotangents of every output,
    against autograd through the plain version, FP32_TOL of each gradient's
    scale."""
    from accunet_tpu_torch.ops.kernels import expand_dw as ED
    from accunet_tpu_torch.ops.kernels import hanc_block as HB
    from accunet_tpu_torch.ops.kernels import respath as RP

    g = torch.Generator(device=dev).manual_seed(32)

    def leaves(args):
        return [a.detach().clone().requires_grad_(True) if isinstance(a, torch.Tensor) else a
                for a in args]

    def cot(outs):
        return [torch.randn(o.shape, generator=g, device=dev).to(o.dtype) for o in outs]

    checks = []
    for case in kernel_cases(dev)(torch.float32):
        if case.kernel == "hanc_block":
            x, p, pre = case.args
            args = leaves([x, pre, *p])
            outs = HB.HancBlockFn.apply(args[0], args[1], 3, *args[2:])
            y, sums = HB.hanc_block_reference(args[0], HB.HANCBlockWeights(*args[2:]), 3, args[1])
            plain = (y, sums[:, 0])
        elif case.kernel == "respath_level":
            args = leaves(case.args)
            outs = RP.RespathLevelFn.apply(*args)
            y, x_new, sums = RP.respath_level_reference(*args)
            plain = (y, x_new, sums[:, 0])
        else:
            continue
        checks.append((f"{case.kernel} {case.name}", args, outs, plain))
    for case in ed_cases(torch.float32)[:2]:
        x, w1, b1, wd, bd, bn1, bn2 = case.args
        args = leaves([x, w1, b1, wd, bd, *bn1, *bn2])
        outs = (ED.ExpandDwFn.apply(*args),)
        plain = (ED.expand_dw_plain(args[0], *args[1:5], tuple(args[5:7]), tuple(args[7:9])),)
        checks.append((f"expand_dw {case.name}", args, outs, plain))
    bad = []
    for name, args, outs, plain in checks:
        inputs = [a for a in args if isinstance(a, torch.Tensor)]
        gys = cot(outs)
        got = torch.autograd.grad(outs, inputs, gys)
        want = torch.autograd.grad(plain, inputs, gys)
        rel = max(rel_err(a, b)[1] for a, b in zip(got, want))
        ok = rel <= FP32_TOL
        log(f"  {'ok ' if ok else 'BAD'} {name:26s} {len(inputs):2d} input gradients rel "
            f"{rel:.3e} (tol {FP32_TOL:g})")
        if not ok:
            bad.append(name)
    if bad:
        raise SmokeError(f"eval autograd functions disagree with their plain versions: {bad}")


def run_profile_trace():
    """Phase 33: accunet_tpu_torch.cli.profile --trace on ACC_UNet b8
    224x224 fp32: 5 forwards under torch.profiler with the module ranges; the
    trace's report (utils/trace_report.py) is non-empty and names hanc_block
    among its top ops; the report's device ms per forward beside the
    CUDA-event ms per forward of the same profiled window."""
    from accunet_tpu_torch.cli import profile as cli

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = cli.main(["--model", "ACC_UNet", "--img", str(HW), "--batch", str(B),
                        "--steps", "5", "--trace", tmp])
        seconds = time.perf_counter() - t0
        mib = os.path.getsize(os.path.join(tmp, "trace.json")) / 2 ** 20
    modules, ops = out["trace_modules"], out["trace_top_ops"]
    named = [m for m, _ in modules if m not in ("total", "(other)")]
    if not ops or not named or out["trace_ms"] <= 0:
        raise SmokeError(f"empty trace report: modules {modules}, ops {ops}")
    if not any("hanc_block" in name for name, *_ in ops):
        raise SmokeError(f"hanc_block is not among the trace's top ops: {[o[0] for o in ops]}")
    res = {"trace_device_ms_per_forward": out["trace_ms"],
           "cuda_event_ms_per_forward": out["window_ms"],
           "profiler_off_ms_per_forward": out["ms_per_batch"], "trace_mib": mib,
           "modules": len(named), "seconds": seconds}
    log(f"  trace report: {out['trace_ms']:.3f} device ms per forward (kernels and copies summed) "
        f"beside {out['window_ms']:.3f} ms per forward by CUDA events over the same window "
        f"({out['ms_per_batch']:.3f} without the profiler); {len(named)} modules, trace "
        f"{mib:.1f} MiB, {seconds:.1f} s")
    return res


# ------------------------------------- the hybrid SegMamba family and text
# the ladder's text rung (TransformerMambaBlocks: one MambaVisionMixer, so one
# fused selective scan without z at d_state 8, a block) and the flagship
# (SpatialMambaBlocks: one return-hidden scan a block), both HSLCA-fused; the
# rung returns the deep-supervision tuple, so it trains with 2 classes
# (multiclass_dice_ce; ROADMAP Queue 3), the flagship one binary head
TEXT_TMB, TEXT_FLAGSHIP = ("Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn_HSLCA",
                           "Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn_HSLCA_SpatialMamba")
VSS_VARIANT = "Segmamba_hybrid_gsc_VSS"  # the mixer is TokenVSSM's SS2D: 4 scans a block
# (name, out channels, text): the three SegMamba models of phases 34-37
HYBRID_MODELS = ((TEXT_TMB, 2, True), (TEXT_FLAGSHIP, 1, True), (VSS_VARIANT, 1, False))
MVM_PER_FORWARD = 8  # 2 blocks x 4 stages, one scan each
SS2D_PER_FORWARD = 4 * MVM_PER_FORWARD
HYB_CMP_HW = 64
MVM_N = 8  # TransformerMambaBlock's d_state
# the fused scan at the hybrid family's flags (D, bias, softplus, no z):
# MambaVisionMixer at the rung's four stages (D = C / 2), one SS2D direction
# of TokenVSSM at stage 0 (D = 2C, N 8) and of MedMamba's first stage (b8
# 224x224: 56x56, D 96, N 16): (name, B, L, D, N)
MVM_SHAPES = tuple((f"mvm.stage{i}", B, (HW // 2 >> i) ** 2, f // 2, MVM_N)
                   for i, f in enumerate(SM_FEAT))
HYB_SCAN_SHAPES = MVM_SHAPES + (("vss.stage0", B, (HW // 2) ** 2, 2 * SM_FEAT[0], MVM_N),
                                ("medmamba.stage0", B, (HW // 4) ** 2, 96, N_STATES))
HYB_TAPS = ("vit.stages.0.1", "vit.stages.3.1", "encoder1", "encoder5", "decoder1")


def hyb_scan_ops(g, b, l, d, n):
    """fused_inputs without z, A = -(1..n) per row (MambaVisionMixer's and
    SS2D's init)."""
    ops, gy = fused_inputs(g, b, l, d, n)
    return (*ops[:6], None, ops[7]), gy


def check_hybrid_scan(shapes=HYB_SCAN_SHAPES):
    """Phases 34 and 38: selective_scan_fwd (with its chunk states) and
    selective_scan_bwd against their plain versions at `shapes` with
    the hybrid family's flags (no z, D, bias, softplus; no cotangent on the
    last state, which the models do not use): out, the last state and the
    seven gradients rel <= FP32_TOL, the backward bitwise on a second call.
    Returns {kernel: max abs error vs plain}."""
    from accunet_tpu_torch.ops.kernels import selective_scan as SS

    g = torch.Generator("cuda").manual_seed(34)
    worst, bad = {"selective_scan_fwd": 0.0, "selective_scan_bwd": 0.0}, []
    for name, b, l, d, n in shapes:
        ops, gy = hyb_scan_ops(g, b, l, d, n)
        out, last, states = SS.selective_scan_fwd(*ops, True, save_states=True)
        grads = SS.selective_scan_bwd(*ops, True, states, gy)
        again = SS.selective_scan_bwd(*ops, True, states, gy)
        torch.cuda.synchronize()
        same = all(p is None and q is None or torch.equal(p, q) for p, q in zip(grads, again))
        del again
        want = SS.selective_scan_fwd_plain(*ops, True)
        f_errs = [rel_err(out, want[0]), rel_err(last, want[1])]
        want = SS.selective_scan_bwd_plain(*ops, True, gy)
        if grads[6] is not None or want[6] is not None:
            raise SmokeError(f"{name}: a z gradient without z")
        b_errs = {k: rel_err(p, q) for k, p, q in zip(
            ("du", "ddelta", "dA", "dB", "dC", "dD", "dz", "dbias"), grads, want) if k != "dz"}
        rel = max([e[1] for e in f_errs] + [e[1] for e in b_errs.values()])
        ok = rel <= FP32_TOL and same
        worst["selective_scan_fwd"] = max(worst["selective_scan_fwd"], max(e[0] for e in f_errs))
        worst["selective_scan_bwd"] = max(worst["selective_scan_bwd"],
                                          max(e[0] for e in b_errs.values()))
        log(f"  {'ok ' if ok else 'BAD'} selective_scan {name:15s} B{b} L{l:5d} D{d:3d} N{n:2d}, "
            f"no z: out rel {f_errs[0][1]:.3e}, last state {f_errs[1][1]:.3e}; "
            + ", ".join(f"{k} {v[1]:.3e}" for k, v in b_errs.items())
            + f" (tol {FP32_TOL:g}); backward bitwise on a second call {same}")
        if not ok:
            bad.append(name)
        del ops, gy, out, last, states, grads, want
        torch.cuda.empty_cache()
    if bad:
        raise SmokeError(f"the fused selective scan without z disagrees with its plain versions: "
                         f"{bad}")
    return worst


def time_hybrid_scan(shapes=HYB_SCAN_SHAPES):
    """Phases 34b and 42: at each of `shapes`, selective_scan_fwd (no chunk
    states, as inference runs it) and selective_scan_bwd (from the chunk
    states) against their plain versions and the least time the card could
    take (bound_ms: bytes, or 7 / 20 fp32 operations a (t, n) at 67
    TFLOP/s)."""
    from accunet_tpu_torch.ops.kernels import selective_scan as SS

    g = torch.Generator("cuda").manual_seed(35)
    times = {}
    for name, b, l, d, n in shapes:
        ops, gy = hyb_scan_ops(g, b, l, d, n)
        pairs = b * l * d * n
        with torch.inference_mode():
            _, _, states = SS.selective_scan_fwd(*ops, True, save_states=True)
            cases = {
                "selective_scan_fwd": Case(
                    "selective_scan_fwd", name, lambda: SS.selective_scan_fwd(*ops, True),
                    lambda: SS.selective_scan_fwd_plain(*ops, True), ops, 7 * pairs),
                "selective_scan_bwd": Case(
                    "selective_scan_bwd", name,
                    lambda: SS.selective_scan_bwd(*ops, True, states, gy),
                    lambda: SS.selective_scan_bwd_plain(*ops, True, gy), (*ops, states, gy),
                    20 * pairs)}
            for kname, case in cases.items():
                out = case.run()
                bound, bound_by = bound_ms(case, out)
                del out
                k_ms = time_ms(case.run)
                p_ms = time_ms(case.plain, iters=2, warmup=1)
                times[(kname, name)] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": None,
                                        "bound_ms": bound, "bound_by": bound_by}
                log(f"  {kname:18s} {name:15s} B{b} L{l:5d} D{d:3d} N{n:2d}: kernel {k_ms:7.3f} ms"
                    f"   plain {p_ms:8.3f} ms   bound {bound:6.3f} ms ({bound_by}), "
                    f"{100 * bound / k_ms:.1f}% of it")
        del ops, gy, states, cases
        torch.cuda.empty_cache()
    return times


def hybrid_model(name, n_classes):
    """A SegMamba registry model at full width and depth (3 channels in),
    seeded with the JAX package's initialisers, eval mode, on the CPU."""
    from accunet_tpu_torch.models import build, init_parameters

    return init_parameters(build(name, in_chans=3, out_chans=n_classes),
                           torch.Generator().manual_seed(0)).eval()


def fake_text(b):
    """(b, 16, 768) FakeTextEncoder embeddings of b prompts (the stub that
    ClinicalTextEncoder falls back to without ClinicalBERT's weights)."""
    from accunet_tpu_torch.nn.text import FakeTextEncoder

    return torch.from_numpy(FakeTextEncoder()([f"lesion {i}, irregular border"
                                               for i in range(b)]))


def scan_counts():
    from accunet_tpu_torch.ops.kernels import selective_scan as SS

    return {k: getattr(SS, k).launches for k in ("selective_scan_fwd", "selective_scan_bwd",
                                                  "selective_scan_rh_fwd",
                                                  "selective_scan_rh_bwd")}


def time_hybrid(name, n_classes, text):
    """Phase 35: `name` at full width, 224x224, fp32 (TF32 off): inference
    at b8 and the train step (its configured loss on one head, or
    multiclass_dice_ce on the deep-supervision tuple; backward; Adam) at b8
    or, where b8 does not fit in the card's memory, the largest of 4 and 2
    that does: ms, img/s, peak memory and the scan launches a forward and a
    step; CUDA events, 3 iterations after one warm-up (and the counted
    call). Returns (the train batch, the numbers)."""
    from accunet_tpu_torch.train import losses as L
    from accunet_tpu_torch.train import metrics as M
    from accunet_tpu_torch.train.engine import make_train_fns

    model = hybrid_model(name, n_classes)
    g = torch.Generator("cuda").manual_seed(35)
    m = copy.deepcopy(model).cuda()
    x = torch.rand(B, HW, HW, 3, generator=g, device="cuda")
    t = fake_text(B).cuda() if text else None
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        c0 = scan_counts()
        m(x, t)
        per_fwd = {k: v - c0[k] for k, v in scan_counts().items() if v != c0[k]}
        ms = time_ms(lambda: m(x, t), iters=3, warmup=1)
    out = {"inference_fp32": {"batch": B, "ms_per_batch": ms, "img_per_s": B * 1e3 / ms,
                              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                              "scans_per_forward": per_fwd}}
    del m
    if n_classes > 1:
        loss = dict(loss_fn=L.multiclass_dice_ce, dice_show=L.multiclass_dice_show,
                    iou_fn=M.multiclass_batch_iou)
    else:
        loss = dict(loss_fn=L.binary_dice_bce)
    tried = []
    for b in (B, B // 2, B // 4):
        gc_cuda()
        torch.cuda.reset_peak_memory_stats()
        try:
            m = copy.deepcopy(model).cuda().train()
            fns = make_train_fns(m, **loss)
            batch = {"image": x[:b], "mask": torch.randint(
                0, n_classes + 1, (b, HW, HW, 1), generator=g, device="cuda").float()}
            if text:
                batch["text_emb"] = t[:b]
            c0 = scan_counts()
            fns.train_step(fns.state, batch)
            torch.cuda.synchronize()
            per_step = {k: v - c0[k] for k, v in scan_counts().items() if v != c0[k]}
            ms = time_ms(lambda: fns.train_step(fns.state, batch), iters=3, warmup=1)
            _, stats = fns.train_step(fns.state, batch)
            if not bool(torch.isfinite(stats["loss"])):
                raise SmokeError(f"non-finite loss in the timed {name} train step")
        except torch.cuda.OutOfMemoryError:
            tried.append(b)
            m = fns = batch = None
            continue
        out["train_step_fp32"] = {
            "batch": b, "ms_per_step": ms, "img_per_s": b * 1e3 / ms,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "scans_per_step": per_step, "out_of_memory_at": tried}
        break
    else:
        raise SmokeError(f"{name}: no train step of batch {B}, {B // 2} or {B // 4} fits")
    del m, fns, batch
    gc_cuda()
    i, s = out["inference_fp32"], out["train_step_fp32"]
    log(f"  {name} {HW}x{HW} fp32: inference b{B} {i['ms_per_batch']:.3f} ms/batch, "
        f"{i['img_per_s']:.1f} img/s, peak {i['peak_mem_gib']:.2f} GiB, scans a forward "
        f"{per_fwd}; train step b{s['batch']} {s['ms_per_step']:.3f} ms/step, "
        f"{s['img_per_s']:.1f} img/s, peak {s['peak_mem_gib']:.2f} GiB, scans a step "
        f"{s['scans_per_step']}" + (f" (out of memory at b{tried})" if tried else ""))
    return s["batch"], out


def gc_cuda():
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def time_medmamba():
    """Phase 35: MedMamba (VSSM at its published widths, 2 classes) b8
    224x224 fp32 forward, with seeded BN statistics: ms, img/s, peak memory
    and the fused scans a forward (4 directions x 10 blocks)."""
    from accunet_tpu_torch.models import build, init_parameters

    m = seeded_bns(init_parameters(build("MedMamba", n_channels=3, num_classes=2),
                                   torch.Generator().manual_seed(0)), 35).cuda().eval()
    x = torch.rand(B, HW, HW, 3, generator=torch.Generator("cuda").manual_seed(36), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        c0 = scan_counts()
        y = m(x)
        per_fwd = {k: v - c0[k] for k, v in scan_counts().items() if v != c0[k]}
        ms = time_ms(lambda: m(x), iters=5, warmup=2)
    if y.shape != (B, 2) or not bool(y.isfinite().all()):
        raise SmokeError(f"MedMamba: logits {tuple(y.shape)}, finite {bool(y.isfinite().all())}")
    out = {"batch": B, "ms_per_batch": ms, "img_per_s": B * 1e3 / ms,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "scans_per_forward": per_fwd}
    log(f"  MedMamba b{B} {HW}x{HW} fp32 forward: {ms:.3f} ms/batch, {out['img_per_s']:.1f} "
        f"img/s, peak {out['peak_mem_gib']:.2f} GiB, scans a forward {per_fwd}")
    del m, x
    gc_cuda()
    return out


def ss2d_copy_share():
    """Phase 35: one VSS-variant forward (b8 224x224, fp32) under
    torch.profiler: the device time of the copies made inside the SS2D
    modules (the column-major and flipped sequences, the contiguous B / C
    operands, the outputs flipped and transposed back: aten::copy_ and
    aten::flip under an SS2D forward) against the forward's device time."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    from accunet_tpu_torch.nn.ss2d import SS2D

    m = hybrid_model(VSS_VARIANT, 1).cuda()
    x = torch.rand(B, HW, HW, 3, generator=torch.Generator("cuda").manual_seed(37), device="cuda")
    ranges, hooks = [], []
    for mod in m.modules():
        if isinstance(mod, SS2D):
            def pre(_m, _i):
                ranges.append(record_function("ss2d"))
                ranges[-1].__enter__()

            def post(_m, _i, _o):
                ranges.pop().__exit__(None, None, None)

            hooks += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    with torch.inference_mode():
        m(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            m(x)
            torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    total = ss2d = copies = 0.0
    for ev in prof.events():
        if ev.device_type != DeviceType.CPU:  # a device kernel or copy
            total += ev.device_time_total
            continue
        dev = ev.self_device_time_total  # the kernels this op launched itself
        anc, names = ev.cpu_parent, set()
        while anc is not None:
            names.add(anc.name)
            anc = anc.cpu_parent
        if dev and "ss2d" in names:
            ss2d += dev
            if ev.name in ("aten::copy_", "aten::flip"):
                copies += dev
    del m, x, prof
    gc_cuda()
    out = {"forward_device_ms": total / 1e3, "ss2d_device_ms": ss2d / 1e3,
           "ss2d_copies_device_ms": copies / 1e3,
           "ss2d_copies_share": copies / total if total else None}
    log(f"  {VSS_VARIANT} b{B} forward under the profiler: device {total / 1e3:.3f} ms, of it "
        f"SS2D {ss2d / 1e3:.3f} ms and SS2D's copies {copies / 1e3:.3f} ms "
        f"({100 * copies / max(total, 1e-9):.1f}%)")
    return out


def hybrid_train_launches(name):
    """Per train step of the rung: 8 fused forwards (one MambaVisionMixer a
    block) and 8 fused backwards, per validation forward 8 fused forwards;
    of the flagship: 8 rh forwards and backwards, 8 rh forwards; nothing
    else of the port's kernels."""
    fwd, bwd = (("selective_scan_fwd", "selective_scan_bwd") if name == TEXT_TMB
                else ("selective_scan_rh_fwd", "selective_scan_rh_bwd"))

    def want(steps, val_batches):
        zero = dict.fromkeys(KERNELS, 0)
        return {"train_steps": {**zero, fwd: MVM_PER_FORWARD * steps,
                                bwd: MVM_PER_FORWARD * steps},
                "validation": {**zero, fwd: MVM_PER_FORWARD * val_batches}}
    return want


def compare_hybrid_cpu():
    """Phase 37: the three SegMamba models (the text ones with FakeTextEncoder
    text) and MedMamba, full width, b1 64x64 fp32: GPU (kernels) vs CPU
    (plain versions), their outputs and taps rel <= MODEL_TOL, the GPU
    forward's scan launches as the model's path says."""
    from accunet_tpu_torch.models import build, init_parameters

    out = {}
    x = torch.from_numpy(np.random.default_rng(37).standard_normal(
        (1, HYB_CMP_HW, HYB_CMP_HW, 3), dtype=np.float32))
    want_scans = {TEXT_TMB: {"selective_scan_fwd": MVM_PER_FORWARD},
                  TEXT_FLAGSHIP: {"selective_scan_rh_fwd": MVM_PER_FORWARD},
                  VSS_VARIANT: {"selective_scan_fwd": SS2D_PER_FORWARD},
                  "MedMamba": {"selective_scan_fwd": 4 * 10}}
    medmamba = seeded_bns(init_parameters(build("MedMamba", n_channels=3, num_classes=2),
                                          torch.Generator().manual_seed(0)), 37).eval()
    for name, n_classes, text in HYBRID_MODELS + (("MedMamba", 2, False),):
        model = medmamba if name == "MedMamba" else hybrid_model(name, n_classes)
        taps = () if name == "MedMamba" else HYB_TAPS
        t = fake_text(1) if text else None
        args = () if name == "MedMamba" else (t,)
        gpu = copy.deepcopy(model).cuda()
        feats = {"cpu": {}, "gpu": {}}
        hooks = []
        for side, mdl in (("cpu", model), ("gpu", gpu)):
            hooks += [mdl.get_submodule(n).register_forward_hook(
                lambda mod, inp, o, n=n, d=feats[side]: d.__setitem__(n, o.float().cpu()))
                for n in taps]
        with torch.inference_mode():
            want = model(x, *args)
            c0 = scan_counts()
            got = gpu(x.cuda(), *[a if a is None else a.cuda() for a in args])
            scans = {k: v - c0[k] for k, v in scan_counts().items() if v != c0[k]}
        for h in hooks:
            h.remove()
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        errs = {f"out{i}": rel_err(p.cpu(), q)[1] for i, (p, q) in enumerate(zip(got, want))}
        errs.update({n: rel_err(feats["gpu"][n], feats["cpu"][n])[1] for n in taps})
        out[name] = max(errs.values())
        log(f"  {name} b1 {HYB_CMP_HW}x{HYB_CMP_HW}" + (" with text" if text else "")
            + ", GPU vs CPU: " + ", ".join(f"{k} rel {v:.3e}" for k, v in errs.items())
            + f" (tol {MODEL_TOL:g}); GPU scans {scans}")
        if out[name] > MODEL_TOL:
            raise SmokeError(f"{name} on the GPU disagrees with the CPU")
        if scans != want_scans[name]:
            raise SmokeError(f"{name}: scan launches {scans}, expected {want_scans[name]}")
        del gpu
        gc_cuda()
    return out


# ----------------------------------------- KNUnet, U-KAN and SegMamba .pth files
# KNUnet (KMUNet: hidden 64/128/256/512, depths 1/2/6/2, d_state 16) and U-KAN
# (embed 256/320/512) at full width; neither is in the 224 preset, so both run
# at 256x256 (config.get_config), batch 8
KAN_HW = 256
# the fused selective scan under KNUnet's decoder (no z; D, bias, softplus):
# the last VSSBlock of up1 / up2 / up3 runs one SS2D at d_inner D = hidden[i]
# over L = (256 / 16, 8, 4)^2 steps, one launch per direction: (name, B, L, D, N)
KNUNET_SCAN_SHAPES = (("knunet.up1", B, (KAN_HW // 16) ** 2, 512, N_STATES),
                      ("knunet.up2", B, (KAN_HW // 8) ** 2, 256, N_STATES),
                      ("knunet.up3", B, (KAN_HW // 4) ** 2, 128, N_STATES))
KNUNET_PER_FORWARD = 12  # 3 SS2Ds (up1-up3's last blocks) x 4 directions
# U-KAN's DWBnRelu depthwise convs (3x3 with bias; their weight and bias
# gradient is dwconv2d_wgrad): block1_0 and dblock1_0 at 16x16x320, block2_0
# at 8x8x512, dblock2_0 at 32x32x256, three each: (name, side, C)
UKAN_DW_SHAPES = (("block1_0", KAN_HW // 16, 320), ("block2_0", KAN_HW // 32, 512),
                  ("dblock2_0", KAN_HW // 8, 256))
UKAN_WGRAD_PER_STEP = 12  # 4 KANBlocks x 3 DWBnRelus
KAN_CMP_HW = 64
KAN_MODELS = {
    "KNUnet": (("decoder.up1", "decoder.up2", "decoder.up3", "decoder.final_up"),
               {"selective_scan_fwd": KNUNET_PER_FORWARD}),
    "UKAN": (("encoder3", "norm3", "norm4", "dnorm3", "dnorm4"), {})}
# phase 41: Segmamba's checkpoint through the eval CLI, 4 images of 64x64 in 2
# forwards (the source model's CPU forward sets the phase's time)
CKPT_EVAL_N, CKPT_EVAL_B, CKPT_EVAL_HW = 4, 2, 64


def ukan_wgrad_cases(dev):
    """Phases 38 and 42: dwconv2d_wgrad (with db) at U-KAN b8 256x256's
    three DWBnRelu maps (x and g ~ N(0, 1))."""
    g = torch.Generator(device=dev).manual_seed(38)

    def cases(dt):
        return [wgrad_case(f"ukan.{name}",
                           *(torch.randn(B, hw, hw, c, generator=g, device=dev).to(dt)
                             for _ in range(2)))
                for name, hw, c in UKAN_DW_SHAPES]

    return cases


def kan_train_launches(name):
    """Per KNUnet train step: 12 fused forwards and 12 fused backwards (4
    directions of the three SS2Ds that run), per validation forward 12 fused
    forwards; per U-KAN train step 12 dwconv2d_wgrad (one per DWBnRelu), per
    validation forward none; nothing else of the port's kernels."""
    def want(steps, val_batches):
        zero = dict.fromkeys(KERNELS, 0)
        if name == "KNUnet":
            return {"train_steps": {**zero, "selective_scan_fwd": KNUNET_PER_FORWARD * steps,
                                    "selective_scan_bwd": KNUNET_PER_FORWARD * steps},
                    "validation": {**zero, "selective_scan_fwd": KNUNET_PER_FORWARD * val_batches}}
        return {"train_steps": {**zero, "dwconv2d_wgrad": UKAN_WGRAD_PER_STEP * steps},
                "validation": zero}
    return want


def kan_model(name):
    """KNUnet or U-KAN at full width (3 channels in, 1 class: KNUnet's
    logits, U-KAN's sigmoid probabilities), seeded with the JAX package's
    initialisers, U-KAN's BNs moved off their init values; eval mode, CPU."""
    from accunet_tpu_torch.models import build, init_parameters

    model = init_parameters(build(name, n_channels=3, n_classes=1),
                            torch.Generator().manual_seed(0))
    return seeded_bns(model, 40).eval()


def launch_counts():
    from accunet_tpu_torch.ops.kernels import dwconv2d as DW
    from accunet_tpu_torch.ops.kernels import selective_scan as SS

    return {"dwconv2d_wgrad": DW.dwconv2d_wgrad.launches, **scan_counts()}


def compare_kan_cpu(name):
    """Phase 40: `name` at full width, b1 64x64, GPU (kernels) vs CPU (plain
    versions) as compare_on_cpu holds it, and the GPU forward's launches
    (KNUnet 12 fused forwards, U-KAN none)."""
    taps, want = KAN_MODELS[name]
    model = kan_model(name)
    c0 = launch_counts()
    err = compare_on_cpu(model, name, KAN_CMP_HW, taps, 40)
    got = {k: v - c0[k] for k, v in launch_counts().items() if v != c0[k]}
    if got != want:
        raise SmokeError(f"{name}: the GPU forward launched {got}, expected {want}")
    log(f"  {name} GPU forward launches {got}")
    return err


def reference_ckpt(model, path, seed):
    """A reference-format .pth.tar of `model` as the reference's 3-D SegMamba
    writes it: each 4-D kernel (conv O, I, kh, kw or transposed conv I, O,
    kh, kw) as a 5-D one, every third of depth 1 and the others of depth 3
    with random off-centre taps, under DataParallel's 'module.' prefixes.
    Returns the number of 5-D kernels."""
    g = torch.Generator().manual_seed(seed)
    state, n3d = {}, 0
    for key, v in model.state_dict().items():
        if v.ndim == 4:
            v = v[:, :, None]
            if n3d % 3:
                off = torch.randn(v.shape, generator=g)
                v = torch.cat([off, v, -off], dim=2)
            n3d += 1
        state[f"module.{key}"] = v
    torch.save({"epoch": 1, "state_dict": state}, path)
    return n3d


def run_segmamba_ckpt_eval(counters):
    """Phase 41: Segmamba at full width (1 channel in, 1 logit out), seeded,
    written as a reference-format .pth.tar (reference_ckpt), evaluated
    through the eval entry point with --torch-ckpt on cuda (CKPT_EVAL_N
    images of CKPT_EVAL_HW x CKPT_EVAL_HW in batches of CKPT_EVAL_B): the
    dumped outputs against the source model's on the CPU (rel <=
    MODEL_TOL), 16 fused forwards a forward and nothing else."""
    from accunet_tpu_torch.cli import eval as cli
    from accunet_tpu_torch.models import build, init_parameters

    # one channel in: the dataset reads write_folder's (4, H, W) arrays so
    src = init_parameters(build("Segmamba", in_chans=1, out_chans=1),
                          torch.Generator().manual_seed(41)).eval()
    with tempfile.TemporaryDirectory() as tmp:
        data, path = os.path.join(tmp, "data"), os.path.join(tmp, "best_model-Segmamba.pth.tar")
        write_folder(data, CKPT_EVAL_N, CKPT_EVAL_HW)
        n3d = reference_ckpt(src, path, 41)
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = cli.main(["--model", "Segmamba", "--test-dir", data,
                        "--img-size", str(CKPT_EVAL_HW), "--batch", str(CKPT_EVAL_B),
                        "--device", "cuda", "--torch-ckpt", path,
                        "--csv", os.path.join(tmp, "m.csv"), "--result", os.path.join(tmp, "r"),
                        "--dump-dir", os.path.join(tmp, "dump")])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        dumps = [np.load(os.path.join(tmp, "dump", n)) for n in sorted(os.listdir(
            os.path.join(tmp, "dump")))]
    if res.n_images != CKPT_EVAL_N or len(dumps) != CKPT_EVAL_N:
        raise SmokeError(f"Segmamba --torch-ckpt eval: {res.n_images} images, {len(dumps)} dumps")
    got = torch.from_numpy(np.stack([d["output"] for d in dumps]))
    with torch.inference_mode():
        want = src(torch.from_numpy(np.stack([d["input"] for d in dumps])))
    abs_err, rel = rel_err(got, want)
    forwards = -(-CKPT_EVAL_N // CKPT_EVAL_B)
    want_launches = {k: SCANS_PER_FORWARD * forwards if k == "selective_scan_fwd" else 0
                     for k in launches}
    log(f"  Segmamba --torch-ckpt ({n3d} 5-D kernels) eval on cuda: {CKPT_EVAL_N} images in "
        f"{seconds:.2f} s, dice {res.dice:.4f}; output vs the source model on the CPU: "
        f"max_abs_err {abs_err:.3e}, rel {rel:.3e} (tol {MODEL_TOL:g}); launches {launches}")
    if rel > MODEL_TOL:
        raise SmokeError("the checkpoint's model on the GPU disagrees with its source on the CPU")
    if launches != want_launches:
        raise SmokeError(f"the eval path launched {launches}, expected {want_launches}")
    return launches, rel


def time_kan(name):
    """Phase 42: `name` at full width, b8 256x256, fp32 (TF32 off):
    inference and the train step (weighted Dice+BCE, backward, Adam), ms,
    img/s, peak memory and the launches a forward and a step; CUDA events, 5
    iterations after 2 warm-up (and the counted call)."""
    from accunet_tpu_torch.train.engine import make_train_fns

    model = kan_model(name)
    g = torch.Generator("cuda").manual_seed(42)
    x = torch.rand(B, KAN_HW, KAN_HW, 3, generator=g, device="cuda")
    m = copy.deepcopy(model).cuda()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        c0 = launch_counts()
        y = m(x)
        per_fwd = {k: v - c0[k] for k, v in launch_counts().items() if v != c0[k]}
        ms = time_ms(lambda: m(x), iters=5, warmup=2)
    if y.shape != (B, KAN_HW, KAN_HW, 1) or not bool(y.isfinite().all()):
        raise SmokeError(f"{name}: output {tuple(y.shape)}, finite {bool(y.isfinite().all())}")
    out = {"inference_fp32": {"batch": B, "ms_per_batch": ms, "img_per_s": B * 1e3 / ms,
                              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                              "launches_per_forward": per_fwd}}
    del m, y
    gc_cuda()
    torch.cuda.reset_peak_memory_stats()
    fns = make_train_fns(copy.deepcopy(model).cuda())
    batch = {"image": x, "mask": (torch.rand(B, KAN_HW, KAN_HW, 1, generator=g,
                                             device="cuda") > 0.5).float()}
    c0 = launch_counts()
    fns.train_step(fns.state, batch)
    torch.cuda.synchronize()
    per_step = {k: v - c0[k] for k, v in launch_counts().items() if v != c0[k]}
    ms = time_ms(lambda: fns.train_step(fns.state, batch), iters=5, warmup=2)
    _, stats = fns.train_step(fns.state, batch)
    if not bool(torch.isfinite(stats["loss"])):
        raise SmokeError(f"non-finite loss in the timed {name} train step")
    out["train_step_fp32"] = {"batch": B, "ms_per_step": ms, "img_per_s": B * 1e3 / ms,
                              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                              "launches_per_step": per_step}
    del fns, batch
    gc_cuda()
    i, s = out["inference_fp32"], out["train_step_fp32"]
    log(f"  {name} b{B} {KAN_HW}x{KAN_HW} fp32: inference {i['ms_per_batch']:.3f} ms/batch, "
        f"{i['img_per_s']:.1f} img/s, peak {i['peak_mem_gib']:.2f} GiB, launches a forward "
        f"{per_fwd}; train step {s['ms_per_step']:.3f} ms/step, {s['img_per_s']:.1f} img/s, "
        f"peak {s['peak_mem_gib']:.2f} GiB, launches a step {per_step}")
    return out


# phases 43-47: the ACC-UNet paper's UNet baselines; no hand-written kernel
# runs on their paths, as no Pallas kernel runs on JAX's. By name: (the side
# the CLIs train and time it at, the module outputs compared GPU vs CPU).
# UCTransNet runs at 224, its default img_size: at its 256 preset it fails
# in JAX and in the port (ROADMAP Queue 3)
_R50_TAPS = ("hybrid_model.block3_unit9", "encoder_norm", "blocks.3")
ZOO = {"UNet_base": (256, ("down4", "up4", "up1")),
       "Unetpp": (256, ("conv4_0", "conv2_2", "conv0_4")),
       "MultiResUnet": (256, ("respath1", "multiresblock5", "multiresblock9")),
       "UCTransNet": (224, ("down4", "mtc.reconstruct_1", "up1")),
       "TransUNet": (224, _R50_TAPS),
       "TransUnet_fKAN": (224, _R50_TAPS),
       "TransUNet_Vit_fKAN": (224, ("encoder_norm", "blocks.3")),
       "TransUNet_fJNB": (224, _R50_TAPS)}
ZOO_FAMILIES = ("UNet_base", "Unetpp", "MultiResUnet", "UCTransNet", "TransUNet")
ZOO_TRAIN_CLI = ("UNet_base", "UCTransNet", "TransUNet")
ZOO_CMP_HW = 64
ZOO_MC_CLASSES = 3  # the eval CLI's multi-class run (UNet_base: n_classes + 1 logits)
ZOO_BIG = "TransUnet_fKAN"  # 614.86M parameters: its train step's batch is phase 47's


def zoo_model(name, side=None, final_sigmoid=True):
    """`name` at full width (3 channels in, 1 class) built as the CLIs build
    it (`models.build_for`) for side x side images, on the card, seeded with
    the JAX package's initialisers drawn on the card (a CPU draw of 615M
    parameters costs tens of seconds), its BNs moved off their init values;
    `side` also sizes UCTransNet's position embeddings; eval mode."""
    from accunet_tpu_torch.models import build_for, init_parameters

    kw = {"img_size": side} if name == "UCTransNet" and side else {}
    if name not in ("SegViT_fKAN", "TinyUNet"):  # their heads give logits alone
        kw["final_sigmoid"] = final_sigmoid
    with torch.device("cuda"):
        model = build_for(name, side, 3, 1, **kw).cuda()  # index buffers made from numpy
    init_parameters(model, torch.Generator("cuda").manual_seed(43))
    return seeded_bns(model, 43).eval()


def no_launches(steps, val_batches):
    """The zoo's train CLI paths: no kernel of the port, steps or validation."""
    return {"train_steps": dict.fromkeys(KERNELS, 0), "validation": dict.fromkeys(KERNELS, 0)}


def compare_zoo_cpu(name, counters, side=ZOO_CMP_HW, taps=None):
    """Phases 43 and 48: `name` at full width, b1 side x side, fp32 logits
    and the `taps` module outputs (ZOO's by default), GPU vs CPU as
    compare_on_cpu holds them, and no launch of a port kernel on either
    side."""
    model = zoo_model(name, side, final_sigmoid=False)
    cpu = copy.deepcopy(model).cpu()
    del model
    gc_cuda()
    c0 = {k: fn.launches for k, fn in counters.items()}
    err = compare_on_cpu(cpu, name, side, taps or ZOO[name][1], 43)
    got = {k: fn.launches - c0[k] for k, fn in counters.items() if fn.launches != c0[k]}
    if got:
        raise SmokeError(f"{name}: its forwards launched {got}, expected none")
    del cpu
    gc_cuda()
    return err


def time_zoo(name, batches=(B,), dtypes=(torch.float32, torch.bfloat16)):
    """Phases 46, 47 and 51: `name` at full width at its ZOO (ZOO2) side, fp32 (TF32
    off): b8 inference in each of `dtypes` (the compute dtype over fp32
    parameters, as JAX's `dtype` field and the train CLI's bf16), then the
    fp32 train step (weighted Dice+BCE, backward, Adam) at the first of
    `batches` that fits in the card's memory; ms, img/s and peak memory above
    what earlier phases hold; CUDA events, 3 iterations after one warm-up."""
    from accunet_tpu_torch.train.engine import make_train_fns

    side = (ZOO[name] if name in ZOO else ZOO2[name])[0]
    model = zoo_model(name, side)
    g = torch.Generator("cuda").manual_seed(46)
    x = torch.rand(B, side, side, 3, generator=g, device="cuda")
    gc_cuda()
    held = torch.cuda.memory_allocated()
    out = {}
    for dt in dtypes:
        model.dtype = dt
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            y = model(x)
            if y.shape != (B, side, side, 1) or not bool(y.isfinite().all()):
                raise SmokeError(f"{name} {dt}: output {tuple(y.shape)}, finite "
                                 f"{bool(y.isfinite().all())}")
            ms = time_ms(lambda: model(x), iters=3, warmup=1)
        out[f"inference_{str(dt)[6:]}"] = {
            "batch": B, "ms_per_batch": ms, "img_per_s": B * 1e3 / ms,
            "peak_mem_gib": (torch.cuda.max_memory_allocated() - held) / 2 ** 30}
        del y
    model.dtype = torch.float32
    tried = []
    for b in batches:
        gc_cuda()
        torch.cuda.reset_peak_memory_stats()
        fns = batch = None
        try:
            fns = make_train_fns(model.train())
            batch = {"image": x[:b], "mask": (torch.rand(b, side, side, 1, generator=g,
                                                          device="cuda") > 0.5).float()}
            ms = time_ms(lambda: fns.train_step(fns.state, batch), iters=3, warmup=1)
            _, stats = fns.train_step(fns.state, batch)
            if not bool(torch.isfinite(stats["loss"])):
                raise SmokeError(f"non-finite loss in the timed {name} train step")
        except torch.cuda.OutOfMemoryError:
            tried.append(b)
            fns = batch = None
            continue
        out["train_step_fp32"] = {
            "batch": b, "ms_per_step": ms, "img_per_s": b * 1e3 / ms,
            "peak_mem_gib": (torch.cuda.max_memory_allocated() - held) / 2 ** 30,
            "out_of_memory_at": tried}
        break
    else:
        raise SmokeError(f"{name}: no train step of batch {batches} fits")
    del model, fns, batch
    gc_cuda()
    s = out["train_step_fp32"]
    log(f"  {name} {side}x{side}: inference b{B} "
        + ", ".join(f"{k[10:]} {v['ms_per_batch']:.3f} ms ({v['img_per_s']:.1f} img/s, peak "
                    f"{v['peak_mem_gib']:.2f} GiB)" for k, v in out.items()
                    if k.startswith("inference"))
        + f"; fp32 train step b{s['batch']} {s['ms_per_step']:.3f} ms/step "
        f"({s['img_per_s']:.1f} img/s), peak {s['peak_mem_gib']:.2f} GiB"
        + (f" (out of memory at b{tried})" if tried else ""))
    return out


# phases 48-51: the rest of the ACC-UNet paper's comparison zoo; no
# hand-written kernel runs on their paths, as no Pallas kernel runs on JAX's.
# By name: (the side the CLIs train and time it at, the side of its GPU vs
# CPU comparison, the module outputs compared). SwinUnet and SMESwinUnet fix
# their token grid by img_size (224, their preset), in JAX too
ZOO2 = {"SwinUnet": (224, 224, ("layers_2_downsample", "norm", "layers_up_3_blocks.1")),
        "SMESwinUnet": (224, 224, ("mcct.reconstruct_2", "EA_channeld2", "layers_up_3_blocks.1")),
        "SegViT_fKAN": (224, 64, ("encoder_norm", "encoder5", "decoder2")),
        "TinyUNet": (256, 64, ("encoder4_cmrf", "decoder3_cmrf", "decoder1_cmrf"))}


def compare_boundary_mask():
    """Phase 48: SMESwinUnet's boundary mask of a normal and of a [0, 1)
    image at its comparison side, GPU vs CPU: equal, pixel for pixel."""
    from accunet_tpu_torch.models.sme_swin_unet import boundary_mask

    side = ZOO2["SMESwinUnet"][1]
    rng = np.random.default_rng(48)
    masks = {}
    for label, img in (("normal", rng.standard_normal((1, side, side, 3), dtype=np.float32)),
                       ("uniform", rng.random((1, side, side, 3), dtype=np.float32))):
        x = torch.from_numpy(img)
        want, got = boundary_mask(x), boundary_mask(x.cuda()).cpu()
        if not torch.equal(got, want):
            raise SmokeError(f"SMESwinUnet's boundary mask ({label} image): "
                             f"{int((got != want).sum())} pixels differ GPU vs CPU")
        masks[label] = int(want.sum())
    log(f"  SMESwinUnet boundary mask equal GPU vs CPU: {masks} of {side * side} pixels set")
    return masks


def run_zoo2_train_cli(counters, name):
    """Phase 49: the train entry point for `name` at its ZOO2 side, two
    epochs at the largest of b8, b4, b2 that fits, with no port kernel
    launched; the last epoch's ms a step and the peak memory."""
    tried = []
    for b in (B, B // 2, B // 4):
        gc_cuda()  # what an out-of-memory attempt held
        timing = {}
        try:
            zoo_launches = run_train_cli(counters, name, no_launches, hw=ZOO2[name][0], batch=b,
                                         timing=timing, resume=False)
        except torch.cuda.OutOfMemoryError:
            tried.append(b)
            continue
        log(f"  {name} train CLI b{b}: last epoch {timing['last_epoch_ms_per_step']:.1f} "
            f"ms/step, peak {timing['peak_mem_gib']:.2f} GiB"
            + (f" (out of memory at b{tried})" if tried else ""))
        return zoo_launches, {**timing, "batch": b, "out_of_memory_at": tried}
    raise SmokeError(f"{name}: no train CLI batch of {(B, B // 2, B // 4)} fits")


# phases 52-54: the last 16 UNext_CMRF names (the OD, BS and BSRB encoders,
# the CSSE, GS and GAB skips, the Haar wavelet pool, rKAN token blocks). Their
# one port kernel is dwconv2d_wgrad in the token blocks' depthwise backward:
# 4 a train step (the ShiftedBlocks) or 12 (_GS_Wavelet_rKAN: 3 DWBnRelus in
# each of its 4 KANBlocks), at UNext's shapes (phases 19 and 24 hold the
# kernel there); none in an eval forward. The 15 distinct forwards
# (_GS_Wavelet_hd is _GS_Wavelet's), the five that cover every new axis, and
# the two that go through the CLIs
CMRF_REST = ("UNext_CMRF_enc_CSSE", "UNext_CMRF_GS", "UNext_CMRF_GS_Wavelet",
             "UNext_CMRF_Wavelet", "UNext_CMRF_GAB", "UNext_CMRF_OD", "UNext_CMRF_BS",
             "UNext_CMRF_BSRB", "UNext_CMRF_GAB_wavelet", "UNext_CMRF_GAB_wavelet_OD",
             "UNext_CMRF_GS_Wavelet_OD", "UNext_CMRF_BS_GS_Wavelet", "UNext_CMRF_BSRB_GS",
             "UNext_CMRF_BSRB_GS_Wavelet", "UNext_CMRF_GS_Wavelet_rKAN")
CMRF_COVER = ("UNext_CMRF_enc_CSSE", "UNext_CMRF_GAB_wavelet_OD", "UNext_CMRF_BSRB_GS",
              "UNext_CMRF_BS_GS_Wavelet", "UNext_CMRF_GS_Wavelet_rKAN")
CMRF_CLI = ("UNext_CMRF_GAB_wavelet_OD", "UNext_CMRF_GS_Wavelet_rKAN")
RKAN_WGRAD_PER_STEP = 12


def cmrf_rest_taps(name):
    """Module outputs compared GPU vs CPU besides the logits: the stem, the
    tokens, the last decoder block, and the skip's own modules."""
    from accunet_tpu_torch.models.unext_cmrf import VARIANTS

    skip = VARIANTS[name].get("skip", "add")
    return ("encoder3", "norm3", "dnorm4") + {"gs": ("norm4_gs", "sim1"), "gab": ("GAB4", "GAB1"),
                                              "csse": ("csse1", "csse4")}.get(skip, ())


def compare_cmrf_rest(counters):
    """Phase 52: each of CMRF_REST at full width, b1 64x64, fp32, GPU vs CPU
    as compare_on_cpu holds it, and no launch of a port kernel in either
    forward."""
    errs = {}
    for name in CMRF_REST:
        c0 = {k: fn.launches for k, fn in counters.items()}
        errs[name] = compare_on_cpu(seeded_unext(name), name, CMRF_CMP_HW,
                                    cmrf_rest_taps(name), 52)
        got = {k: fn.launches - c0[k] for k, fn in counters.items() if fn.launches != c0[k]}
        if got:
            raise SmokeError(f"{name}: its eval forwards launched {got}, expected none")
    return errs


def check_gab_dilated_bf16():
    """Phase 53: the GAB's dilated depthwise convs (cuDNN's grouped conv with
    a dilation) in bf16 on the card, at UNext_CMRF_GAB_wavelet_OD b8
    224x224's four GABs (groups of dim_xl / 2 + 1 channels) and each
    dilation: the output and the input, weight and bias gradients against
    the same conv in fp32 on the same bf16-rounded inputs, rel <= BF16_TOL.
    (torch's CPU weight gradient of such a conv in bf16 is wrong, so the
    port refuses it there: ops/conv.py.)"""
    from accunet_tpu_torch.ops.conv import dilated_depthwise_conv2d

    g = torch.Generator("cuda").manual_seed(53)
    errs = {}
    for side, c in ((HW // 2, 9), (HW // 4, 17), (HW // 8, 65), (HW // 16, 81)):
        x, gy = (torch.randn(B, side, side, c, generator=g, device="cuda").bfloat16()
                 for _ in range(2))
        w = (0.3 * torch.randn(c, 1, 3, 3, generator=g, device="cuda")).bfloat16()
        bias = torch.randn(c, generator=g, device="cuda").bfloat16()
        for d in (1, 2, 5, 7):
            outs = {}
            for dt in (torch.float32, torch.bfloat16):
                xt, wt, bt = (t.detach().to(dt).requires_grad_(True) for t in (x, w, bias))
                y = dilated_depthwise_conv2d(xt, wt, bt, d)
                y.backward(gy.to(dt))
                outs[dt] = tuple(t.detach() for t in (y, xt.grad, wt.grad, bt.grad))
            errs[f"{side}x{side}x{c}.d{d}"] = max(
                rel_err(a, b)[1] for a, b in zip(outs[torch.bfloat16], outs[torch.float32]))
    worst = max(errs.values())
    log(f"  GAB dilated depthwise convs, bf16 vs fp32 on the card: worst rel {worst:.3e} "
        f"(tol {BF16_TOL:g}); " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    if worst > BF16_TOL:
        raise SmokeError("a GAB dilated depthwise conv in bf16 disagrees with fp32 on the card")
    return errs


def cmrf_train_launches(name):
    """Per train step of `name`: dwconv2d_wgrad 4 times, 12 for the rKAN
    name; per validation forward nothing."""
    per_step = RKAN_WGRAD_PER_STEP if name.endswith("rKAN") else 4

    def want(steps, val_batches):
        zero = dict.fromkeys(KERNELS, 0)
        return {"train_steps": {**zero, "dwconv2d_wgrad": per_step * steps}, "validation": zero}
    return want


# ------------------------------------------- UNext_InceptionNext_MLFC slice
# UNext_InceptionNext_MLFC (and _fKAN, the same model) at its 256x256 preset,
# b8: its four ShiftedBlocks' depthwise convs take their weight gradient from
# dwconv2d_wgrad, at maps smaller than any earlier path's
INC_NAMES = ("UNext_InceptionNext_MLFC", "UNext_InceptionNext_MLFC_fKAN")
INC_HW = 256
INC_CMP_HW = 64
INC_DW_SHAPES = (("block1_0", INC_HW // 64, 160), ("block2_0", INC_HW // 128, 256),
                 ("dblock1_0", INC_HW // 64, 160), ("dblock2_0", INC_HW // 32, 128))
INC_TAPS = ("stage1", "stage2", "stage3", "norm3", "norm4", "dnorm3", "dnorm4")


def inc_wgrad_cases(dev):
    """Phase 55 and 56 cases: dwconv2d_wgrad at the four ShiftedBlock maps of
    UNext_InceptionNext_MLFC b8 256x256 (x and g ~ N(0, 1))."""
    g = torch.Generator(device=dev).manual_seed(55)

    def cases(dt):
        return [wgrad_case(f"inception.{name}",
                           *(torch.randn(B, hw, hw, c, generator=g, device=dev).to(dt)
                             for _ in range(2)))
                for name, hw, c in INC_DW_SHAPES]

    return cases


def compare_inception_cpu(name, counters):
    """Phase 55: `name` at full width, GPU vs CPU: the b1 64x64 eval forward
    (logits and INC_TAPS, compare_on_cpu) launching no port kernel; a b2
    64x64 train-mode forward with every BN's running statistics, the GPU's
    fp32 and the CPU's fp32 (the control) each against the CPU's float64:
    each within twice the control's gap, or MODEL_TOL."""
    model = seeded_unext(name)
    for fn in counters.values():
        fn.launches = 0
    out = {"eval_rel": compare_on_cpu(model, name, INC_CMP_HW, INC_TAPS, 55)}
    if any(fn.launches for fn in counters.values()):
        raise SmokeError(f"{name}'s eval forward launched "
                         f"{ {k: fn.launches for k, fn in counters.items()} }")
    x = torch.from_numpy(np.random.default_rng(56).standard_normal(
        (2, INC_CMP_HW, INC_CMP_HW, 3), dtype=np.float32))
    init = {n: t.double() for n, t in model.named_buffers() if "running" in n}
    res = {}
    for tag, d, dt in (("gpu", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                       ("cpu64", "cpu", torch.float64)):
        m = copy.deepcopy(model).to(device=d, dtype=dt).train()
        with torch.no_grad():
            y = m(x.to(d, dt)).double().cpu()
        res[tag] = (y, {n: t.double().cpu() for n, t in m.named_buffers() if "running" in n})
    for tag in ("gpu", "cpu"):
        out[f"train_out_{tag}"] = rel_err(res[tag][0], res["cpu64"][0])[1]
        out[f"bn_stats_{tag}"], out[f"bn_worst_{tag}"] = bn_stat_err(res[tag][1], res["cpu64"][1],
                                                                     init)
    lim_out = max(2 * out["train_out_cpu"], MODEL_TOL)
    lim_bn = max(2 * out["bn_stats_cpu"], MODEL_TOL)
    log(f"  {name} b2 {INC_CMP_HW}x{INC_CMP_HW} train-mode forward vs the float64 CPU one, GPU "
        f"(CPU fp32 control): output rel {out['train_out_gpu']:.3e} ({out['train_out_cpu']:.3e}, "
        f"limit {lim_out:.3e}); BN statistics {out['bn_stats_gpu']:.3e} at "
        f"{out['bn_worst_gpu']} ({out['bn_stats_cpu']:.3e}, limit {lim_bn:.3e})")
    if out["train_out_gpu"] > lim_out or out["bn_stats_gpu"] > lim_bn:
        raise SmokeError(f"{name}'s train-mode forward on the GPU disagrees with the CPU")
    return out


# ------------------------------------------------- scale-out: parallel/
# Two ranks on the one card, over gloo with CUDA tensors (NCCL refuses two
# ranks on one device); parallel/ uses all-reduce, all-gather and (the
# initial weights) broadcast, which gloo runs on CUDA tensors. The sequence-parallel scan at the JAX
# bench's scan shape (bench.py:150-179), Segmamba b8 224x224 under
# sequence_sharding with seq=2, ACC_UNet b8 224x224 as 2 ranks x b4 with
# data=2 and as 2 ranks x b8 with model=2.
MESH_RANKS = 2
# model=2 vs the one-process step, the gradients' gap over the largest: both
# ranks compute the whole step, so only the card's run-to-run summation order
# moves them (8.8e-7 and 6.8e-7 measured on an H100); a wrong shard slice or
# index moves them by O(1)
MESH_MODEL_GRAD_TOL = 1e-4
SEQ_SCAN_SHAPE = (B, 3136, 768)
SEQ_TOL = (2e-5, 1e-4)  # atol, rtol: tests/test_torch_parallel.py's SS2D / SSM bar
MESH_TIMEOUT = 600


def _record_grads(state, names):
    """Wrap state.optimizer.step to keep each gradient (on the CPU, as
    float64) just before the update."""
    grads, step = {}, state.optimizer.step

    def recording(*args, **kw):
        for p in state.optimizer_params():
            if p.grad is not None:
                grads[names[id(p)]] = p.grad.detach().double().cpu()
        return step(*args, **kw)

    state.optimizer.step = recording
    return grads


def _grad_gap(got, want, shards=None):
    """The largest gradient error over the largest reference gradient; a
    sharded gradient against its slice of the reference."""
    scale = max(float(t.abs().max()) for t in want.values())
    worst = 0.0
    for n, t in want.items():
        if shards and n in shards:
            dim, index = shards[n]
            size = got[n].shape[dim]
            t = t.narrow(dim, index * size, size)
        worst = max(worst, float((got[n] - t).abs().max()))
    return worst / scale


def worker_mesh_acc(rank, counters):
    """ACC_UNet b8 224x224 (n_filts 32): the one-process step on the 8
    images (rank 0), then one step on data=2 (each rank its 4 images) and on
    model=2 (both ranks the 8; cnv72's 128 -> 4352 weights and their Adam
    moments sharded), each followed by a validation forward (eval_step), with
    the launches of each. Rank 0 compares the loss, the running statistics
    and the gradients with the one-process step."""
    from accunet_tpu_torch.parallel.mesh import MeshSpec, batch_slice, make_mesh
    from accunet_tpu_torch.train.engine import make_train_fns

    base = acc_unet()
    rs = np.random.default_rng(41)
    x = torch.from_numpy(rs.random((B, HW, HW, 3), dtype=np.float32)).cuda()
    share = np.repeat([0.8, 0.2], B // 2)[:, None, None, None]  # per data slice
    mask = torch.from_numpy((rs.random((B, HW, HW, 1)) < share).astype(np.float32)).cuda()
    init = {n: t.double() for n, t in base.named_buffers() if "running" in n}
    ref = None
    if rank == 0:
        m = copy.deepcopy(base).cuda()
        fns = make_train_fns(m)
        names = {id(p): n for n, p in m.named_parameters()}
        grads = _record_grads(fns.state, names)
        _, stats = fns.train_step(fns.state, {"image": x, "mask": mask})
        ref = (float(stats["loss"]), grads,
               {n: t.double().cpu() for n, t in m.named_buffers() if "running" in n})
        del m, fns
        torch.cuda.empty_cache()
    out = {}
    for tag, spec in (("data2", MeshSpec(data=2)), ("model2", MeshSpec(data=1, model=2))):
        mesh = make_mesh(spec)
        m = copy.deepcopy(base).cuda()
        fns = make_train_fns(m, mesh=mesh)
        st = fns.state
        names = {id(p): n for n, p in m.named_parameters()}
        shards = {}
        if st.sharding is not None:
            names.update({id(it.shard): it.name for it in st.sharding.items})
            shards = {it.name: (it.dim, mesh.coords["model"]) for it in st.sharding.items}
        grads = _record_grads(st, names)
        rows = batch_slice(mesh, B)
        batch = {"image": x[rows], "mask": mask[rows]}
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        _, stats = fns.train_step(st, batch)
        torch.cuda.synchronize()
        step_launches = {k: fn.launches for k, fn in counters.items()}
        for fn in counters.values():
            fn.launches = 0
        fns.eval_step(st, batch)
        torch.cuda.synchronize()
        val_launches = {k: fn.launches for k, fn in counters.items()}
        r = {"loss": float(stats["loss"]), "step_launches": step_launches,
             "validation_launches": val_launches,
             "sharded": {it.name: {"local": list(it.shard.shape), "whole": list(it.shape),
                                   "dim": it.dim}
                         for it in (st.sharding.items if st.sharding else ())}}
        if ref is not None:
            stats_now = {n: t.double().cpu() for n, t in m.named_buffers() if "running" in n}
            r["loss_rel"] = abs(r["loss"] - ref[0]) / abs(ref[0])
            r["bn_stats"], r["bn_worst"] = bn_stat_err(stats_now, ref[2], init)
            r["grad_gap"] = _grad_gap(grads, ref[1], shards)
        out[tag] = r
        del m, fns, st, grads
        torch.cuda.empty_cache()
    return out


def worker_seq_scan(rank, counters):
    """sequence_parallel_scan at (8, 3136, 768) over the seq axis: each rank
    its (8, 1568, 768) shard; h, da and db against one rank's linear_scan /
    linear_scan_reverse on the whole sequence and against the plain
    versions; the launches of one call and its backward; ms of the
    two-rank call (forward and backward, the ranks sharing the card) beside
    one rank's kernels on the whole sequence."""
    from accunet_tpu_torch.ops.kernels import scan as S
    from accunet_tpu_torch.parallel import MeshSpec, make_mesh, sequence_parallel_scan

    mesh = make_mesh(MeshSpec(data=1, seq=MESH_RANKS))
    group = mesh.group("seq")
    b, l, d = SEQ_SCAN_SHAPE
    g = torch.Generator("cuda").manual_seed(57)
    a, x = scan_inputs(g, b, l, d)
    gy = torch.randn(b, l, d, generator=g, device="cuda")
    per = l // MESH_RANKS
    rows = slice(rank * per, (rank + 1) * per)
    h = S.linear_scan(a, x)
    da, db = S.linear_scan_reverse(a, h, gy)
    hp = S.linear_scan_plain(a, x)
    dap, dbp = S.linear_scan_grads_plain(a, hp, gy)

    def seq_call():
        a_s = a[:, rows].clone().requires_grad_()
        x_s = x[:, rows].clone().requires_grad_()
        h_s = sequence_parallel_scan(a_s, x_s, group)
        h_s.backward(gy[:, rows])
        return h_s, a_s.grad, x_s.grad

    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    got = seq_call()
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    errs = {}
    for key, mine, kern, plain in (("h", got[0], h, hp), ("da", got[1], da, dap),
                                   ("db", got[2], db, dbp)):
        errs[f"{key}_vs_kernel"] = rel_err(mine, kern[:, rows])[1]
        errs[f"{key}_vs_plain"] = rel_err(mine, plain[:, rows])[1]
    ms = time_ms(seq_call, iters=5, warmup=1)
    full_ms = time_ms(lambda: S.linear_scan_reverse(a, S.linear_scan(a, x), gy), iters=5,
                      warmup=1)
    return {"errs": errs, "launches": launches, "ms_fwd_bwd": ms,
            "one_rank_kernels_ms": full_ms}


def worker_seq_segmamba(rank, counters):
    """Segmamba b8 224x224 (full width, seeded): rank 0 runs the one-process
    fused path (the eval forward, one train step); then both ranks run the
    eval forward and one train step under sequence_sharding with seq=2
    (every scan on the unfused route, its L over the two ranks), with the
    launches of each; rank 0 compares them with the fused path."""
    from accunet_tpu_torch.parallel import MeshSpec, make_mesh, sequence_sharding
    from accunet_tpu_torch.train import losses as L
    from accunet_tpu_torch.train.engine import make_train_fns

    base = segmamba_model()
    rs = np.random.default_rng(58)
    x = torch.from_numpy(rs.standard_normal((B, HW, HW, 3), dtype=np.float32)).cuda()
    mask = torch.from_numpy((rs.random((B, HW, HW, 1)) > 0.5).astype(np.float32)).cuda()
    batch = {"image": x, "mask": mask}
    loss_fn = L.LOSSES["binary_dice_bce"]  # Segmamba's preset loss
    ref = None
    if rank == 0:
        m = copy.deepcopy(base).cuda()
        with torch.no_grad():
            ref_out = m(x).cpu()
        fns = make_train_fns(m, loss_fn=loss_fn)
        grads = _record_grads(fns.state, {id(p): n for n, p in m.named_parameters()})
        _, stats = fns.train_step(fns.state, batch)
        ref = (ref_out, float(stats["loss"]), grads)
        del m, fns
        torch.cuda.empty_cache()
    mesh = make_mesh(MeshSpec(data=1, seq=MESH_RANKS))
    m = copy.deepcopy(base).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad(), sequence_sharding(mesh):
        out = m(x).cpu()
    fwd_s = time.perf_counter() - t0
    fwd_launches = {k: fn.launches for k, fn in counters.items()}
    fns = make_train_fns(m, loss_fn=loss_fn, mesh=mesh)
    grads = _record_grads(fns.state, {id(p): n for n, p in m.named_parameters()})
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with sequence_sharding(mesh):
        _, stats = fns.train_step(fns.state, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    r = {"forward_launches": fwd_launches,
         "step_launches": {k: fn.launches for k, fn in counters.items()},
         "forward_s": fwd_s, "step_s": step_s,
         "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if ref is not None:
        r["out_rel"] = rel_err(out, ref[0])[1]
        r["out_close"] = bool(torch.allclose(out, ref[0], atol=SEQ_TOL[0], rtol=SEQ_TOL[1]))
        r["loss_rel"] = abs(float(stats["loss"]) - ref[1]) / abs(ref[1])
        r["grad_gap"] = _grad_gap(grads, ref[2])
    return r


def rank_worker(rank: int, world: int, port: int, out_path: str) -> None:
    """One rank of phase 57 (started by run_mesh_ranks): gloo over
    127.0.0.1:port, cuda:0, the counters wrapped as in main; writes its
    results to out_path as JSON."""
    import torch.distributed as dist

    from accunet_tpu_torch.ops.kernels.dwconv2d import dwconv2d_wgrad
    from accunet_tpu_torch.ops.kernels.hanc_block import hanc_block
    from accunet_tpu_torch.ops.kernels.hanc_mix import hanc_mix
    from accunet_tpu_torch.ops.kernels.respath import respath_level
    from accunet_tpu_torch.ops.kernels.scan import linear_scan, linear_scan_reverse
    from accunet_tpu_torch.ops.kernels.selective_scan import selective_scan_bwd, selective_scan_fwd

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        acc = {"hanc_block": hanc_block, "respath_level": respath_level, "hanc_mix": hanc_mix,
               "dwconv2d_wgrad": dwconv2d_wgrad}
        scans = {"linear_scan": linear_scan, "linear_scan_reverse": linear_scan_reverse,
                 "selective_scan_fwd": selective_scan_fwd, "selective_scan_bwd": selective_scan_bwd}
        res = {"acc": worker_mesh_acc(rank, acc), "scan": worker_seq_scan(rank, scans),
               "segmamba": worker_seq_segmamba(rank, scans)}
        with open(out_path, "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_mesh_ranks():
    """Phase 57: MESH_RANKS processes of rank_worker on the one card, each
    waited for with its own timeout and killed if it outlives it; returns
    rank 0's results after checking both ranks' launches agree, with the
    scan's errors the largest of the ranks'."""
    port = free_port()
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(MESH_RANKS)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.rank_worker({r}, {MESH_RANKS}, "
                                   f"{port}, {outs[r]!r})"],
            cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(MESH_RANKS)]
        texts = []
        try:
            for p in procs:
                texts.append(p.communicate(timeout=MESH_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate(timeout=60)
        for r, (p, text) in enumerate(zip(procs, texts)):
            if p.returncode != 0:
                raise SmokeError(f"mesh rank {r} exited {p.returncode}:\n{text[-4000:]}")
        res = []
        for path in outs:
            with open(path) as f:
                res.append(json.load(f))
    for key in (("acc", "data2", "step_launches"), ("acc", "model2", "step_launches"),
                ("scan", "launches"), ("segmamba", "forward_launches"),
                ("segmamba", "step_launches")):
        a, b_ = (_dig(r, key) for r in res)
        if a != b_:
            raise SmokeError(f"ranks launched differently at {key}: {a} vs {b_}")
    # every rank's shard of the scan is checked (rank 0's carry-in is 0)
    res[0]["scan"]["errs"] = {k: max(r["scan"]["errs"][k] for r in res)
                              for k in res[0]["scan"]["errs"]}
    res[0]["segmamba"]["peak_mem_gib_by_rank"] = [r["segmamba"]["peak_mem_gib"] for r in res]
    return res[0]


def _dig(d, keys):
    for k in keys:
        d = d[k]
    return d


def check_mesh_results(res):
    """Phase 57's gates on rank 0's results: the sequence-parallel scan
    within FP32_TOL of one rank's kernels and of the plain versions, one
    linear_scan and one linear_scan_reverse a call; Segmamba under
    sequence_sharding: 16 linear_scan a forward and 16 of each a step, no
    fused launch, the forward within SEQ_TOL of the fused path's, the loss
    within FP32_TOL, the gradients reported (gap over the largest, gated at
    TRAIN_TOL); ACC_UNet data=2 and model=2: the launches of one rank's
    step (16 hanc_mix, 18 dwconv2d_wgrad) and validation forward (7
    hanc_block, 7 respath_level, 9 hanc_mix), the loss and the running
    statistics within TRAIN_TOL of the one-process step, cnv72's sharded
    weights half their dim; model=2's gradients (the shards' against their
    slices) within MESH_MODEL_GRAD_TOL; data=2's reported only (the fp32 ACC
    step at random init moves ~10% of the largest gradient with summation
    order, compare_train_step; the float64 CPU test holds them to 1e-8)."""
    bad = []
    sc = res["scan"]
    if max(sc["errs"].values()) > FP32_TOL or \
            (sc["launches"]["linear_scan"], sc["launches"]["linear_scan_reverse"]) != (1, 1):
        bad.append(f"sequence_parallel_scan {sc}")
    sm = res["segmamba"]
    want_fwd = {"linear_scan": SCANS_PER_FORWARD, "linear_scan_reverse": 0,
                "selective_scan_fwd": 0, "selective_scan_bwd": 0}
    want_step = {**want_fwd, "linear_scan_reverse": SCANS_PER_FORWARD}
    if sm["forward_launches"] != want_fwd or sm["step_launches"] != want_step:
        bad.append(f"Segmamba seq launches {sm['forward_launches']} / {sm['step_launches']}")
    if not sm["out_close"] or sm["loss_rel"] > FP32_TOL or sm["grad_gap"] > TRAIN_TOL:
        bad.append(f"Segmamba seq vs fused: {sm}")
    for tag in ("data2", "model2"):
        r = res["acc"][tag]
        want_step = {"hanc_block": 0, "respath_level": 0, "hanc_mix": 16, "dwconv2d_wgrad": 18}
        want_val = {**{k: v for k, v in EVAL_LAUNCHES.items() if k != "expand_dw"},
                    "dwconv2d_wgrad": 0}
        if r["step_launches"] != want_step or r["validation_launches"] != want_val:
            bad.append(f"ACC {tag} launches {r['step_launches']} / {r['validation_launches']}")
        if r["loss_rel"] > TRAIN_TOL or r["bn_stats"] > TRAIN_TOL:
            bad.append(f"ACC {tag} vs one process: loss {r['loss_rel']}, BN {r['bn_stats']}")
        if tag == "model2" and r["grad_gap"] > MESH_MODEL_GRAD_TOL:
            bad.append(f"ACC model2 gradients vs one process: {r['grad_gap']}")
        if tag == "model2" and not (r["sharded"] and all(
                v["local"][v["dim"]] * MESH_RANKS == v["whole"][v["dim"]]
                for v in r["sharded"].values())):
            bad.append(f"ACC model2 shards {r['sharded']}")
    if bad:
        raise SmokeError("mesh phases: " + "; ".join(bad))


class Phases:
    """Logs each phase's title and, when the next begins (or `end()`), the
    seconds it took."""

    def __init__(self):
        self.t0 = None

    def __call__(self, title: str) -> None:
        self.end()
        self.t0 = time.perf_counter()
        log(title)

    def end(self) -> None:
        if self.t0 is not None:
            log(f"  ({time.perf_counter() - self.t0:.1f} s)")
            self.t0 = None


def ptxas_summary(log_text: str) -> str:
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log_text)]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", log_text)]
    return (f"{len(regs)} kernels, registers max {max(regs, default=0)}, "
            f"spill stores max {max(spills, default=0)} bytes")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from accunet_tpu_torch.nn import acc_blocks  # noqa: F401
        from accunet_tpu_torch.ops.kernels import _build
        from accunet_tpu_torch.ops.kernels.dwconv2d import dwconv2d_wgrad
        from accunet_tpu_torch.ops.kernels.expand_dw import expand_dw
        from accunet_tpu_torch.ops.kernels.hanc_block import hanc_block
        from accunet_tpu_torch.ops.kernels.hanc_mix import hanc_mix
        from accunet_tpu_torch.ops.kernels.respath import respath_level
        from accunet_tpu_torch.ops.kernels.scan import (
            dma_chunked_scan, linear_scan, linear_scan_reverse)
        from accunet_tpu_torch.ops.kernels.selective_scan import (
            selective_scan_bwd, selective_scan_fwd, selective_scan_rh_bwd, selective_scan_rh_fwd)
    except ImportError as e:
        print(f"chip_smoke: run from the root of the repository ({e})", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    phase = Phases()

    phase("[1] device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")

    phase("[2] build")
    t0 = time.perf_counter()
    _build.load_library()
    build_log = _build.build_dir() / "build.log"
    log(f"  built in {time.perf_counter() - t0:.1f} s into {_build.build_dir()}; "
        + (ptxas_summary(build_log.read_text()) if build_log.exists() else "no build log"))

    phase("[3] kernels vs plain versions (main-path shapes, b8)")
    cases = kernel_cases(dev)
    worst_bf16 = {}
    worst = check_kernels(cases, worst_bf16)

    phase("[4] ACC_UNet through accunet_tpu_torch.cli.eval on cuda")
    counters = {"hanc_block": hanc_block, "respath_level": respath_level, "hanc_mix": hanc_mix,
                "expand_dw": expand_dw}
    launches = {"eval_cli": run_eval_cli(counters)}

    phase("[5] whole model, GPU vs CPU")
    model = compare_model()

    phase("[6] train-path autograd functions vs plain versions (main-path shapes, b8)")
    check_autograd_fns(dev)

    phase("[7] ACC_UNet through accunet_tpu_torch.cli.train on cuda, then --resume auto")
    counters["dwconv2d_wgrad"] = dwconv2d_wgrad
    train_launches = run_train_cli(counters, "ACC_UNet", acc_train_launches)
    launches["train_cli_steps"] = train_launches["train_steps"]
    launches["train_cli_validation"] = train_launches["validation"]

    phase(f"[8] one train step, GPU vs CPU ({TRAIN_CMP_HW}x{TRAIN_CMP_HW}, b2, fp32, TF32 off)")
    train_cmp = compare_train_step()

    phase("[9] timing")
    rates = time_model(model)
    train_rate = time_train_step(acc_unet(), "ACC_UNet",
                                 {"dwconv2d_wgrad": dwconv2d_wgrad, "hanc_mix": hanc_mix})
    times = time_kernels(cases)
    log("  " + json.dumps({"card": card, "acc_unet": rates, "train_step_fp32": train_rate,
                           "train_step_gpu_vs_cpu": train_cmp}))

    phase("[10] scan kernels vs plain versions (Segmamba's stage shapes, b8)")
    worst.update(check_scan_kernels())
    worst.update(check_fused_scan())

    phase("[11] ChunkedLinearScanFn and SelectiveScanFn gradients vs autograd of the plain versions")
    check_scan_autograd()

    phase(f"[12] Segmamba, full width: fused selective scan vs plain (b{B} {HW}x{HW}), GPU vs CPU")
    sm_model = segmamba_model()
    sm_cmp = compare_segmamba(sm_model)

    phase("[13] Segmamba through accunet_tpu_torch.cli.train on cuda, then --resume auto")
    counters.update(linear_scan=linear_scan, linear_scan_reverse=linear_scan_reverse,
                    linear_scan_staged=dma_chunked_scan, selective_scan_fwd=selective_scan_fwd,
                    selective_scan_bwd=selective_scan_bwd,
                    selective_scan_rh_fwd=selective_scan_rh_fwd,
                    selective_scan_rh_bwd=selective_scan_rh_bwd)
    sm_launches = run_train_cli(counters, "Segmamba", segmamba_train_launches)
    launches["segmamba_train_cli_steps"] = sm_launches["train_steps"]
    launches["segmamba_train_cli_validation"] = sm_launches["validation"]

    phase("[14] Segmamba timing")
    sm_rates = time_segmamba(sm_model)
    times.update({(k, c, "float32"): v for (k, c), v in time_scan_kernels().items()})
    times.update({(k, c, "float32"): v for (k, c), v in time_fused_scan().items()})
    log("  " + json.dumps({"card": card, "segmamba": sm_rates, "segmamba_checks": sm_cmp}))

    phase("[15] expand_dw vs its plain version (cnv72 of ACC_UNet b8 224x224 and of ACC_UNet_W b2 "
        "512x512, a ragged shape) and vs the unfused front half")
    ed_cases = expand_dw_cases(dev)
    worst.update(check_kernels(ed_cases, worst_bf16))
    check_unfused_front(ed_cases)

    phase(f"[16] ACC_UNet_W ({W_CLASSES} classes, {W_HW}x{W_HW}, b{W_B}, hybrid on) through "
        "accunet_tpu_torch.cli.eval on cuda")
    launches["eval_cli_w"] = run_eval_cli(
        counters, "ACC_UNet_W", W_CLASSES, W_HW, W_B, 2 * W_B, "{'hybrid_expand_dw': True}",
        {**EVAL_LAUNCHES, "expand_dw": 1})

    phase(f"[17] ACC_UNet_W mc: hybrid on vs off (b{W_B} {W_HW}x{W_HW}), hybrid_e_min=96 GPU vs CPU")
    w_model, w_cmp = compare_w_hybrid()

    phase("[18] ACC_UNet_W timing, expand_dw timing")
    w_rates = time_w_model(w_model)
    times.update(time_kernels(ed_cases))
    log("  " + json.dumps({"card": card, "acc_unet_w_mc_512_b2": w_rates, "w_checks": w_cmp}))

    phase("[19] dwconv2d_wgrad vs its plain version at UNext b8 224x224's ShiftedBlock shapes")
    un_cases = unext_wgrad_cases(dev)
    for kname, err in check_kernels(un_cases, worst_bf16).items():
        worst[kname] = max(worst[kname], err)

    phase("[20] UNext through accunet_tpu_torch.cli.eval on cuda (no kernel on its path)")
    launches["unext_eval_cli"] = run_eval_cli(counters, "UNext", per_forward={})

    phase("[21] UNext through accunet_tpu_torch.cli.train on cuda, then --resume auto")
    un_launches = run_train_cli(counters, "UNext", unext_train_launches)
    launches["unext_train_cli_steps"] = un_launches["train_steps"]
    launches["unext_train_cli_validation"] = un_launches["validation"]

    phase(f"[22] UNext GPU vs CPU: b1 {HW}x{HW} forward; one b{B} {HW}x{HW} train step vs float64")
    unext = seeded_unext()
    un_checks = {"gpu_vs_cpu_rel": compare_on_cpu(unext, "UNext", HW, UNEXT_TAPS, 22),
                 "train_step": compare_train_step(seeded_unext, B, HW, UNEXT_TRAIN_TOL)}

    phase(f"[23] UNext_CMRF topologies, b1 {CMRF_CMP_HW}x{CMRF_CMP_HW}, GPU vs CPU")
    for name in CMRF_TOPOLOGIES:
        un_checks[f"{name}_gpu_vs_cpu_rel"] = compare_on_cpu(
            seeded_unext(name), name, CMRF_CMP_HW, CMRF_TAPS, 23)

    phase("[24] UNeXt timing, dwconv2d_wgrad at its shapes")
    un_rates = {"unext": time_model(unext, "UNext")}
    un_rates["unext_b1024"] = time_model(unext, "UNext", HEADLINE_B, (torch.bfloat16,))
    un_rates["unext_train_step_fp32"] = time_train_step(unext, "UNext",
                                                       {"dwconv2d_wgrad": dwconv2d_wgrad})
    cmrf = seeded_unext("UNext_CMRF")
    un_rates["unext_cmrf"] = time_model(cmrf, "UNext_CMRF", dtypes=(torch.float32,))
    un_rates["unext_cmrf_train_step_fp32"] = time_train_step(cmrf, "UNext_CMRF",
                                                            {"dwconv2d_wgrad": dwconv2d_wgrad})
    times.update(time_kernels(un_cases))
    log("  " + json.dumps({"card": card, **un_rates, "unext_checks": un_checks}))

    phase("[25] return-hidden selective scan vs its plain versions (the variant's stage shapes, "
          "BASELINE config 5's block, N 1, an odd shape)")
    worst.update(check_rh_scan())

    phase("[26] SelectiveScanRhFn gradients vs autograd of the plain forward")
    check_rh_autograd()

    phase(f"[27] {SPM_VARIANT} through accunet_tpu_torch.cli.train on cuda (--n-classes "
          f"{SPM_CLASSES}), then --resume auto")
    spm_launches = run_train_cli(counters, SPM_VARIANT, spm_train_launches,
                                 ("--n-classes", str(SPM_CLASSES)))
    launches["spm_train_cli_steps"] = spm_launches["train_steps"]
    launches["spm_train_cli_validation"] = spm_launches["validation"]

    phase(f"[28] the variant: rh kernels vs plain (b{B} {HW}x{HW}), GPU vs CPU (b1 "
          f"{SPM_CMP_HW}x{SPM_CMP_HW}), a b2 train step vs float64; the classifier GPU vs CPU")
    spm = spm_model()
    spm_checks = compare_spm(spm)
    spm_checks["train_step"] = compare_spm_train_step()
    spm_checks["classifier"] = compare_classifier()

    phase("[29] Spatial-Mamba timing, the rh kernels at their shapes")
    spm_rates = time_spm(spm)
    times.update({(k, c, "float32"): v for (k, c), v in time_rh_scan().items()})
    log("  " + json.dumps({"card": card, "spatial_mamba": spm_rates, "spm_checks": spm_checks}))

    phase("[30] bf16 training (train.compute_dtype=bfloat16): ACC_UNet and UNext through "
          "accunet_tpu_torch.cli.train on cuda; the kernels at a bf16 step's shapes; a b2 "
          f"{TRAIN_CMP_HW}x{TRAIN_CMP_HW} bf16 step GPU vs CPU; ms/step bf16 beside fp32")
    for tag, name, want_fn in (("bf16", "ACC_UNet", with_zeros(acc_train_launches)),
                               ("unext_bf16", "UNext", unext_train_launches)):
        bf_launches = run_train_cli(counters, name, want_fn, BF16_SET)
        launches[f"{tag}_train_cli_steps"] = bf_launches["train_steps"]
        launches[f"{tag}_train_cli_validation"] = bf_launches["validation"]
    for kname, err in check_bf16_train_kernels().items():
        worst_bf16[kname] = max(worst_bf16.get(kname, 0.0), err)
    bf16_checks = {"train_step": compare_train_step(tol=BF16_TRAIN_TOL, dtype=torch.bfloat16)}
    bf16_rates = {}
    for label, mdl, cnt in (("ACC_UNet", acc_unet(), {"dwconv2d_wgrad": dwconv2d_wgrad,
                                                      "hanc_mix": hanc_mix}),
                            ("UNext", unext, {"dwconv2d_wgrad": dwconv2d_wgrad})):
        for dt in (torch.float32, torch.bfloat16):
            bf16_rates[f"{label}_train_step_{str(dt)[6:]}"] = time_train_step(mdl, label, cnt, dt)
    log("  " + json.dumps({"card": card, "train_steps": bf16_rates, "bf16_checks": bf16_checks}))

    phase(f"[31] ACC_UNet_W ({W_CLASSES} classes, {W_HW}x{W_HW}, b{W_B}, fp32) through "
          "accunet_tpu_torch.cli.train on cuda, then --resume auto")
    w_launches = run_train_cli(counters, "ACC_UNet_W", with_zeros(acc_train_launches),
                               ("--n-classes", str(W_CLASSES)), hw=W_HW, batch=W_B)
    launches["w_train_cli_steps"] = w_launches["train_steps"]
    launches["w_train_cli_validation"] = w_launches["validation"]

    phase(f"[32] Seg-Grad-CAM: accunet_tpu_torch.cli.gradcam on cuda (ACC_UNet b{B} {HW}x{HW}); "
          f"the CAM GPU vs CPU (b2 {CAM_HW}x{CAM_HW}); the eval kernels' autograd functions")
    launches["gradcam_cli"], cam_seconds = run_gradcam_cli(counters)
    cam_checks = {"gradcam_cli_seconds": cam_seconds, "gpu_vs_cpu_max_abs": compare_cam()}
    check_eval_fns(dev, ed_cases)

    phase("[33] accunet_tpu_torch.cli.profile --trace (ACC_UNet b8 224x224 fp32) and its report")
    trace = run_profile_trace()
    log("  " + json.dumps({"card": card, "gradcam": cam_checks, "trace": trace}))

    phase("[34] the fused selective scan at the hybrid family's flags (no z; N 8 at "
          "MambaVisionMixer's and TokenVSSM's shapes, N 16 at MedMamba's) vs its plain "
          "versions; its times")
    t_hyb = time.perf_counter()
    for kname, err in check_hybrid_scan().items():
        worst[kname] = max(worst[kname], err)
    times.update({(k, c, "float32"): v for (k, c), v in time_hybrid_scan().items()})

    phase(f"[35] timing, {HW}x{HW} fp32: {TEXT_TMB}, {TEXT_FLAGSHIP} (with text) and "
          f"{VSS_VARIANT}, inference b{B} and the train step; MedMamba's forward; SS2D's copies")
    hyb_rates, hyb_batch = {}, {}
    for name, n_cls, text in HYBRID_MODELS:
        hyb_batch[name], hyb_rates[name] = time_hybrid(name, n_cls, text)
    hyb_rates["MedMamba"] = time_medmamba()
    hyb_rates["vss_ss2d_copies"] = ss2d_copy_share()

    phase("[36] the text models through accunet_tpu_torch.cli.train on cuda with a prompt CSV, "
          "then --resume auto")
    for tag, name, n_cls, _ in ((("tmb_text",) + HYBRID_MODELS[0]),
                                (("flagship_text",) + HYBRID_MODELS[1])):
        extra = ("--n-classes", str(n_cls)) if n_cls > 1 else ()
        hyb_launches = run_train_cli(counters, name, hybrid_train_launches(name), extra,
                                     batch=hyb_batch[name], prompts=True)
        launches[f"{tag}_train_cli_steps"] = hyb_launches["train_steps"]
        launches[f"{tag}_train_cli_validation"] = hyb_launches["validation"]

    phase(f"[37] GPU vs CPU, b1 {HYB_CMP_HW}x{HYB_CMP_HW}: the text models (with text), "
          f"{VSS_VARIANT} and MedMamba")
    hyb_checks = compare_hybrid_cpu()
    phase.end()
    log(f"  phases 34-37 took {time.perf_counter() - t_hyb:.1f} s")
    log("  " + json.dumps({"card": card, "hybrid": hyb_rates, "hybrid_train_batch": hyb_batch,
                           "hybrid_checks": hyb_checks}))

    phase(f"[38] the fused selective scan at KNUnet's decoder shapes (b{B} {KAN_HW}x{KAN_HW}) "
          "and dwconv2d_wgrad at U-KAN's DWBnRelu maps vs their plain versions")
    t_kan = time.perf_counter()
    for kname, err in check_hybrid_scan(KNUNET_SCAN_SHAPES).items():
        worst[kname] = max(worst[kname], err)
    uk_cases = ukan_wgrad_cases(dev)
    for kname, err in check_kernels(uk_cases, worst_bf16).items():
        worst[kname] = max(worst[kname], err)

    phase(f"[39] KNUnet and U-KAN through accunet_tpu_torch.cli.train on cuda ({KAN_HW}x{KAN_HW}, "
          f"b{B}), then --resume auto")
    for name in KAN_MODELS:
        kan_launches = run_train_cli(counters, name, kan_train_launches(name), hw=KAN_HW)
        launches[f"{name.lower()}_train_cli_steps"] = kan_launches["train_steps"]
        launches[f"{name.lower()}_train_cli_validation"] = kan_launches["validation"]

    phase(f"[40] KNUnet and U-KAN through accunet_tpu_torch.cli.eval on cuda; GPU vs CPU (b1 "
          f"{KAN_CMP_HW}x{KAN_CMP_HW})")
    kan_checks = {}
    for name, (_, per_fwd) in KAN_MODELS.items():
        launches[f"{name.lower()}_eval_cli"] = run_eval_cli(counters, name, hw=KAN_HW,
                                                            per_forward=per_fwd)
        kan_checks[f"{name}_gpu_vs_cpu_rel"] = compare_kan_cpu(name)

    phase("[41] Segmamba through accunet_tpu_torch.cli.eval --torch-ckpt on cuda (a reference-"
          "format file with 5-D kernels)")
    launches["segmamba_ckpt_eval_cli"], kan_checks["segmamba_ckpt_rel"] = \
        run_segmamba_ckpt_eval(counters)

    phase(f"[42] KNUnet and U-KAN timing (b{B} {KAN_HW}x{KAN_HW} fp32); the fused scan and "
          "dwconv2d_wgrad at their shapes")
    kan_rates = {name: time_kan(name) for name in KAN_MODELS}
    times.update({(k, c, "float32"): v
                  for (k, c), v in time_hybrid_scan(KNUNET_SCAN_SHAPES).items()})
    times.update(time_kernels(uk_cases))
    phase.end()
    log(f"  phases 38-42 took {time.perf_counter() - t_kan:.1f} s")
    log("  " + json.dumps({"card": card, "kan": kan_rates, "kan_checks": kan_checks}))

    phase(f"[43] the UNet baselines (UNet_base, Unetpp, MultiResUnet, UCTransNet, the four "
          f"TransUNet names) at full width, b1 {ZOO_CMP_HW}x{ZOO_CMP_HW}, GPU vs CPU")
    t_zoo = time.perf_counter()
    zoo_checks = {f"{name}_gpu_vs_cpu_rel": compare_zoo_cpu(name, counters) for name in ZOO}

    phase(f"[44] {', '.join(ZOO_TRAIN_CLI)} through accunet_tpu_torch.cli.train on cuda "
          f"(b{B}; UCTransNet at 224), then --resume auto")
    zoo_rates = {}
    for name in ZOO_TRAIN_CLI:
        timing = {}
        zoo_launches = run_train_cli(counters, name, no_launches, hw=ZOO[name][0],
                                     timing=timing)
        launches[f"{name.lower()}_train_cli_steps"] = zoo_launches["train_steps"]
        launches[f"{name.lower()}_train_cli_validation"] = zoo_launches["validation"]
        zoo_rates[f"{name}_train_cli"] = timing
        log(f"  {name} train CLI: last epoch {timing['last_epoch_ms_per_step']:.1f} ms/step, "
            f"peak {timing['peak_mem_gib']:.2f} GiB")

    phase(f"[45] the five families through accunet_tpu_torch.cli.eval on cuda (b{B}), binary and "
          f"UNet_base with {ZOO_MC_CLASSES} classes")
    for name in ZOO_FAMILIES:
        launches[f"{name.lower()}_eval_cli"] = run_eval_cli(counters, name, hw=ZOO[name][0],
                                                            per_forward={})
    launches["unet_base_mc_eval_cli"] = run_eval_cli(counters, "UNet_base", ZOO_MC_CLASSES,
                                                     ZOO["UNet_base"][0], per_forward={})

    phase(f"[46] the five families' timing (b{B} inference fp32 and bf16, the fp32 train step)")
    zoo_rates.update({name: time_zoo(name) for name in ZOO_FAMILIES})

    phase(f"[47] {ZOO_BIG} (614.86M parameters) 224x224: b{B} inference, its fp32 train step at "
          f"the largest of b{B}, b{B // 2}, b{B // 4} that fits")
    zoo_rates[ZOO_BIG] = time_zoo(ZOO_BIG, (B, B // 2, B // 4), (torch.float32,))
    phase.end()
    log(f"  phases 43-47 took {time.perf_counter() - t_zoo:.1f} s")
    log("  " + json.dumps({"card": card, "zoo": zoo_rates, "zoo_checks": zoo_checks}))

    phase(f"[48] SwinUnet, SMESwinUnet (224x224), SegViT_fKAN, TinyUNet ({ZOO_CMP_HW}x"
          f"{ZOO_CMP_HW}) at full width, b1, GPU vs CPU; SMESwinUnet's boundary mask")
    t_zoo2 = time.perf_counter()
    zoo2_checks = {f"{name}_gpu_vs_cpu_rel": compare_zoo_cpu(name, counters, side, taps)
                   for name, (_, side, taps) in ZOO2.items()}
    zoo2_checks["SMESwinUnet_mask_pixels"] = compare_boundary_mask()

    phase(f"[49] the four through accunet_tpu_torch.cli.train on cuda (two epochs at the largest "
          f"of b{B}, b{B // 2}, b{B // 4} that fits; SwinUnet / SMESwinUnet SGD at 224, "
          "SegViT_fKAN 224, TinyUNet 256)")
    zoo2_rates = {}
    for name in ZOO2:
        zoo2_launches, zoo2_rates[f"{name}_train_cli"] = run_zoo2_train_cli(counters, name)
        launches[f"{name.lower()}_train_cli_steps"] = zoo2_launches["train_steps"]
        launches[f"{name.lower()}_train_cli_validation"] = zoo2_launches["validation"]

    phase(f"[50] the four through accunet_tpu_torch.cli.eval on cuda (b{B}), binary, and "
          f"SwinUnet with {ZOO_MC_CLASSES} classes")
    for name, (side, *_) in ZOO2.items():
        launches[f"{name.lower()}_eval_cli"] = run_eval_cli(counters, name, hw=side,
                                                            per_forward={})
    launches["swinunet_mc_eval_cli"] = run_eval_cli(counters, "SwinUnet", ZOO_MC_CLASSES,
                                                    ZOO2["SwinUnet"][0], per_forward={})

    phase(f"[51] the four's timing (b{B} inference fp32 and bf16, the fp32 train step at the "
          f"largest of b{B}, b{B // 2}, b{B // 4} that fits)")
    zoo2_rates.update({name: time_zoo(name, (B, B // 2, B // 4)) for name in ZOO2})
    phase.end()
    log(f"  phases 48-51 took {time.perf_counter() - t_zoo2:.1f} s")
    log("  " + json.dumps({"card": card, "zoo2": zoo2_rates, "zoo2_checks": zoo2_checks}))

    phase(f"[52] the last 16 UNext_CMRF names (15 distinct forwards) at full width, b1 "
          f"{CMRF_CMP_HW}x{CMRF_CMP_HW}, GPU vs CPU, no kernel launched; {card}")
    t_cmrf = time.perf_counter()
    cmrf_checks = compare_cmrf_rest(counters)

    phase(f"[53] {', '.join(CMRF_CLI)} through accunet_tpu_torch.cli.train on cuda ({HW}x{HW}, "
          f"b{B}, two epochs; the first also in bf16) and accunet_tpu_torch.cli.eval; {card}")
    cmrf_rates = {}
    for tag, name, extra in (("gab_wavelet_od", CMRF_CLI[0], ()),
                             ("gs_wavelet_rkan", CMRF_CLI[1], ()),
                             ("gab_wavelet_od_bf16", CMRF_CLI[0], BF16_SET)):
        timing = {}
        cm_launches = run_train_cli(counters, name, cmrf_train_launches(name), extra,
                                    timing=timing, resume=False)
        launches[f"cmrf_{tag}_train_cli_steps"] = cm_launches["train_steps"]
        launches[f"cmrf_{tag}_train_cli_validation"] = cm_launches["validation"]
        cmrf_rates[f"{tag}_train_cli"] = timing
    for name in CMRF_CLI:
        launches[f"{name.lower()}_eval_cli"] = run_eval_cli(counters, name, per_forward={})
    cmrf_checks["gab_dilated_bf16_rel"] = check_gab_dilated_bf16()

    phase(f"[54] timing, b{B} {HW}x{HW}: {', '.join(CMRF_COVER)} (inference fp32 and bf16, the "
          f"fp32 train step with its peak memory and launches); {card}")
    for name in CMRF_COVER:
        mdl = seeded_unext(name)
        cmrf_rates[name] = {"inference": time_model(mdl, name),
                            "train_step_fp32": time_train_step(
                                mdl, name, {"dwconv2d_wgrad": dwconv2d_wgrad})}
        del mdl
        gc_cuda()
    phase.end()
    log(f"  phases 52-54 took {time.perf_counter() - t_cmrf:.1f} s")
    log("  " + json.dumps({"card": card, "cmrf_rest": cmrf_rates, "cmrf_rest_checks": cmrf_checks}))

    phase(f"[55] {INC_NAMES[0]} and _fKAN at full width, GPU vs CPU (b1 {INC_CMP_HW}x{INC_CMP_HW} "
          f"eval, no kernel; b2 train-mode forward and BN statistics); dwconv2d_wgrad at its "
          f"four ShiftedBlock maps (b{B} {INC_HW}x{INC_HW}); {card}")
    t_inc = time.perf_counter()
    inc_checks = {name: compare_inception_cpu(name, counters) for name in INC_NAMES}
    inc_cases = inc_wgrad_cases(dev)
    for kname, err in check_kernels(inc_cases, worst_bf16).items():
        worst[kname] = max(worst[kname], err)

    phase(f"[56] {INC_NAMES[0]} through accunet_tpu_torch.cli.train on cuda ({INC_HW}x{INC_HW}, "
          f"b{B}, two epochs, fp32 and bf16), both names through accunet_tpu_torch.cli.eval; b{B} "
          f"inference fp32 and bf16, the fp32 train step; {card}")
    inc_rates = {}
    for tag, extra in (("inc", ()), ("inc_bf16", BF16_SET)):
        timing = {}
        inc_launches = run_train_cli(counters, INC_NAMES[0], unext_train_launches, extra,
                                     hw=INC_HW, timing=timing, resume=False)
        launches[f"{tag}_train_cli_steps"] = inc_launches["train_steps"]
        launches[f"{tag}_train_cli_validation"] = inc_launches["validation"]
        inc_rates[f"{tag}_train_cli"] = timing
    for name in INC_NAMES:
        launches[f"{name.lower()}_eval_cli"] = run_eval_cli(counters, name, hw=INC_HW,
                                                            per_forward={})
    inc = seeded_unext(INC_NAMES[0])
    inc_rates["inference"] = time_model(inc, INC_NAMES[0], hw=INC_HW)
    inc_rates["train_step_fp32"] = time_train_step(inc, INC_NAMES[0],
                                                   {"dwconv2d_wgrad": dwconv2d_wgrad}, hw=INC_HW)
    times.update(time_kernels(inc_cases))
    del inc
    gc_cuda()
    phase.end()
    log(f"  phases 55-56 took {time.perf_counter() - t_inc:.1f} s")
    log("  " + json.dumps({"card": card, "inception": inc_rates, "inception_checks": inc_checks}))

    phase(f"[57] parallel/, {MESH_RANKS} ranks on the one card over gloo: ACC_UNet b{B} {HW}x{HW} "
          f"on data=2 and model=2 vs one process; sequence_parallel_scan at {SEQ_SCAN_SHAPE}; "
          f"Segmamba b{B} {HW}x{HW} under sequence_sharding (seq=2) vs the fused path; {card}")
    t_mesh = time.perf_counter()
    mesh_res = run_mesh_ranks()
    log("  " + json.dumps({"card": card, "mesh": mesh_res}))
    check_mesh_results(mesh_res)
    for tag in ("data2", "model2"):
        launches[f"mesh_acc_{tag}_step"] = mesh_res["acc"][tag]["step_launches"]
        launches[f"mesh_acc_{tag}_validation"] = mesh_res["acc"][tag]["validation_launches"]
    launches["seq_parallel_scan"] = mesh_res["scan"]["launches"]
    launches["seq_segmamba_forward"] = mesh_res["segmamba"]["forward_launches"]
    launches["seq_segmamba_step"] = mesh_res["segmamba"]["step_launches"]

    phase(f"[58] the real backend: ACC_UNet through accunet_tpu_torch.cli.train --distributed "
          f"(NCCL, a world of one) --mesh data=1 on cuda, two epochs; {card}")
    nccl_launches = run_train_cli(counters, "ACC_UNet", with_zeros(acc_train_launches),
                                  ("--distributed", f"127.0.0.1:{free_port()},0,1",
                                   "--mesh", "data=1"), resume=False)
    launches["nccl_train_cli_steps"] = nccl_launches["train_steps"]
    launches["nccl_train_cli_validation"] = nccl_launches["validation"]
    phase.end()
    log(f"  phases 57-58 took {time.perf_counter() - t_mesh:.1f} s")

    # the shapes whose times the kernels line lists per kernel
    by_shape = {"hanc_block": ("cnv12", "cnv22", "cnv81", "cnv91"),
                "respath_level": ("rspth1.level0", "rspth1.level1", "rspth2.level1"),
                "hanc_mix": ("cnv11", "cnv31", "cnv61", "cnv72"),
                "dwconv2d_wgrad": ("cnv12", "cnv52", "cnv61", "cnv72")
                + tuple(f"unext.{name}" for name, *_ in UNEXT_DW_SHAPES)
                + tuple(f"ukan.{name}" for name, *_ in UKAN_DW_SHAPES)
                + tuple(f"inception.{name}" for name, *_ in INC_DW_SHAPES)}
    timed_case = {"hanc_block": "cnv91", "respath_level": "rspth1.level1", "hanc_mix": "cnv72",
                  "dwconv2d_wgrad": "cnv72", "linear_scan": "stage0",
                  "linear_scan_staged": "stage0", "expand_dw": "cnv72.w_b2_512",
                  "selective_scan_fwd": "stage0", "selective_scan_bwd": "stage0",
                  "selective_scan_rh_fwd": "stage0", "selective_scan_rh_bwd": "stage0"}
    # source, the TPU kernel it replaces, and the path whose run gives
    # `launches`: the inference kernels' own path is the eval CLI (they run
    # in the train CLI only in its validation forwards), the wgrad's is the
    # train CLI's train steps; `launches_by_path` has every path's count.
    # expand_dw's path is the W eval CLI (phase 16; off by default, so 0 on
    # the ACC_UNet eval path); its entry adds the unfused front half's time
    # and both cnv72 shapes.
    # The fused selective scan's path is Segmamba's train CLI (its forward
    # also runs in the validation forwards); their entries add the unfused
    # path's time and every stage. linear_scan's path is Segmamba's train
    # step under sequence_sharding on two ranks (phase 57: its count adds
    # its reverse instantiation's; both given apart; its entry adds the
    # sequence-parallel scan's check and time); elsewhere the fused kernels
    # took its place. linear_scan_staged is on no path (JAX never dispatches
    # its TPU kernel either) and ran only in phases 10 and 14. The rh kernels' path is the Spatial-Mamba
    # variant's train CLI (the forward also runs in its validation forwards);
    # their entries add every shape of phase 29. The hybrid paths (phase 36:
    # the text rung's fused scans without z, the flagship's rh scans) are in
    # `launches_by_path`, and the fused kernels' `by_shape` adds phase 34's
    # shapes (MambaVisionMixer's "mvm.stage0-3", "vss.stage0",
    # "medmamba.stage0"). Phases 39-41's paths (KNUnet's fused scans, U-KAN's
    # wgrad, the Segmamba checkpoint's eval) are in `launches_by_path` too;
    # the fused kernels' `by_shape` adds KNUnet's "knunet.up1-3", the wgrad's
    # U-KAN's "ukan.*" maps. Phases 44-45's paths (the UNet baselines' train
    # and eval CLIs) and 49-50's (SwinUnet, SMESwinUnet, SegViT_fKAN,
    # TinyUNet) launch no kernel: `launches_by_path` holds their zeros.
    # Phase 53's paths (UNext_CMRF_GAB_wavelet_OD in fp32 and bf16 and
    # UNext_CMRF_GS_Wavelet_rKAN through the train CLI: the wgrad 4 and 12
    # times a step; both through the eval CLI: none) are in
    # `launches_by_path` too, and so are phases 56-58's (InceptionNext's
    # train and eval CLIs, the mesh steps and validation forwards of each
    # rank, the sequence-parallel scan and Segmamba, the NCCL train CLI)
    meta = {
        "hanc_block": ("accunet_tpu_torch/csrc/hanc_block.cu",
                       "accunet_tpu/ops/pallas/hanc_block.py:335", "eval_cli"),
        "respath_level": ("accunet_tpu_torch/csrc/respath_level.cu",
                          "accunet_tpu/ops/pallas/respath.py:72", "eval_cli"),
        "hanc_mix": ("accunet_tpu_torch/csrc/hanc_mix.cu", "accunet_tpu/ops/pallas/hanc.py:154",
                     "eval_cli"),
        "dwconv2d_wgrad": ("accunet_tpu_torch/csrc/dwconv2d_wgrad.cu",
                           "accunet_tpu/ops/pallas/dwconv2d.py:76", "train_cli_steps"),
        "linear_scan": ("accunet_tpu_torch/csrc/linear_scan.cu",
                        "accunet_tpu/ops/pallas/scan.py:62", "seq_segmamba_step"),
        "linear_scan_staged": ("accunet_tpu_torch/csrc/linear_scan.cu",
                               "accunet_tpu/ops/pallas/scan_dma.py:114",
                               "segmamba_train_cli_steps"),
        "expand_dw": ("accunet_tpu_torch/csrc/expand_dw.cu",
                      "accunet_tpu/ops/pallas/expand_dw.py:77", "eval_cli_w"),
        "selective_scan_fwd": ("accunet_tpu_torch/csrc/selective_scan.cu",
                               "accunet_tpu/ops/pallas/scan.py:62", "segmamba_train_cli_steps"),
        "selective_scan_bwd": ("accunet_tpu_torch/csrc/selective_scan.cu",
                               "accunet_tpu/ops/pallas/scan.py:119", "segmamba_train_cli_steps"),
        "selective_scan_rh_fwd": ("accunet_tpu_torch/csrc/selective_scan.cu",
                                  "accunet_tpu/ops/pallas/scan.py:73", "spm_train_cli_steps"),
        "selective_scan_rh_bwd": ("accunet_tpu_torch/csrc/selective_scan.cu",
                                  "accunet_tpu/ops/pallas/scan.py:119", "spm_train_cli_steps"),
    }

    def count(c, name):
        return c[name] + c["linear_scan_reverse"] if name == "linear_scan" else c[name]

    kernels = []
    for name, (source, replaces, path) in meta.items():
        t = times[(name, timed_case[name], "float32")]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": count(launches[path], name), "launches_path": path,
                        "launches_by_path": {p: count(c, name) for p, c in launches.items()
                                             if name in c},
                        "max_abs_err": worst[name], "max_abs_err_bf16": worst_bf16.get(name),
                        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                        "shape": f"{timed_case[name]} fp32"
                                 + ("" if name == "expand_dw" else f" b{B}")})
        if name in ("hanc_mix", "hanc_block", "respath_level", "expand_dw"):
            # own path: 3xTF32 in fp32, bf16 mma (expand_dw: and its taps)
            kernels[-1]["own_bound_ms"] = t["own_bound_ms"]
            kernels[-1]["own_bound_by"] = t["own_bound_by"]
        if name in by_shape:
            kernels[-1]["by_shape"] = {f"{c} {d}": times[(name, c, d)] for c in by_shape[name]
                                       for d in ("float32", "bfloat16")}
        if name == "expand_dw":
            kernels[-1]["unfused_ms"] = t["unfused_ms"]
            kernels[-1]["by_shape"] = {f"{c} {d}": times[("expand_dw", c, d)]
                                       for c, _ in CNV72_SHAPES for d in ("float32", "bfloat16")}
        if name == "linear_scan":
            kernels[-1]["launches_forward"] = launches[path]["linear_scan"]
            kernels[-1]["launches_reverse"] = launches[path]["linear_scan_reverse"]
            kernels[-1]["seq_parallel"] = {
                "shape": f"{SEQ_SCAN_SHAPE} over {MESH_RANKS} ranks of one card",
                "ms_fwd_bwd": mesh_res["scan"]["ms_fwd_bwd"],
                "one_rank_kernels_ms": mesh_res["scan"]["one_rank_kernels_ms"],
                "rel_errs": mesh_res["scan"]["errs"]}
        if name in ("selective_scan_fwd", "selective_scan_bwd"):
            kernels[-1]["unfused_ms"] = t["unfused_ms"]
            kernels[-1]["by_shape"] = {f"{c} float32": times[(name, c, "float32")]
                                       for c, *_ in FUSED_STAGES + HYB_SCAN_SHAPES
                                       + KNUNET_SCAN_SHAPES}
        if name.startswith("selective_scan_rh"):
            kernels[-1]["by_shape"] = {f"{c} float32": times[(name, c, "float32")]
                                       for c, *_ in RH_SHAPES[:-1]}
        if name == "selective_scan_rh_bwd":  # the cotangent in the kernel's own layout
            kernels[-1]["by_shape_bldn_cotangent"] = {
                f"{c} float32": times[(name + ".bldn", c, "float32")] for c, *_ in RH_SHAPES[:-1]}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
