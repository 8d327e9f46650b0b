"""ACC-UNet / ACC-UNet-Lite / ACC-UNet-W (torch.nn, NHWC in and out).

Counterpart of accunet_tpu/models/acc_unet.py:66-239. Head: with
n_classes == 1 (and final_sigmoid) a sigmoid probability map with one
channel; otherwise n_classes+1 raw logits.

Kernel assignment, fixed by the model's shapes (eval mode): the level-1/2
HANCBlocks other than the stem cnv11 run the fused `hanc_block` kernel where
their input width fits it (cin <= 128: all of them up to n_filts=32; from
n_filts=33 cnv81 stays unfused, from 65 cnv22/cnv82/cnv91 too), with the
pairs cnv21->cnv22, cnv81->cnv82 and cnv91->cnv92 chained through the SE
prologue when both are fused;
rspth1/rspth2 run the `respath_level` kernel; every other HANC layer with
k >= 2 runs the `hanc_mix` kernel. At n_filts=32 the fused set is exactly the
one the JAX package picks at s2d_levels=2 (n_filts*inv_fctr >= 96). In train
mode every block takes the unfused path: every k >= 2 HANC layer still runs
the `hanc_mix` kernel forward, and every HANCBlock's depthwise conv computes
its weight gradient with the `dwconv2d_wgrad` kernel.

`hybrid_expand_dw=True` (default off, as JAX's ACCUNET_HYBRID_EXPAND_DW)
runs the eval-mode front half (expand, BN, lrelu, depthwise, BN, lrelu) of
every unfused HANCBlock whose interior width E = n_filts * inv_fctr is at
least `hybrid_e_min` (JAX's ACCUNET_HYBRID_E_MIN, default 2048) as the
`expand_dw` kernel; its HANC mix stays on `hanc_mix`. At n_filts=32 that is
cnv72 alone (E = 128 * 34 = 4352); `hybrid_e_min=96` gives JAX's "hybrid
all-E" variant (benchmarks/ab_acc_lite.py:73): every unfused block but the
stem cnv11 (E = 9), i.e. cnv31-cnv72. The fused blocks keep `hanc_block`.

`remat=True` (default off, as in JAX :73, :92-95) checkpoints each HANCBlock,
ResPath and MLFC while gradients are recorded: their activations are
recomputed in the backward instead of kept.

`dtype` is the compute type (JAX's `dtype=`, :77): the input is cast to it
and every layer computes in it, with the parameters (fp32 in training, and
Adam's state with them) cast at use; the BatchNorms take fp32 statistics and
the output is float32, as in JAX. `dtype=torch.bfloat16` is how the train
CLI trains under `train.compute_dtype=bfloat16`; the fused eval kernels
then run their bf16 paths. `dtype=None` computes in the parameters' own
type, so `model.to(torch.bfloat16)` also runs bf16 inference, with the same
results as fp32 parameters of the same values under `dtype=torch.bfloat16`
(tests/test_torch_bf16_train.py).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from accunet_tpu_torch.nn.acc_blocks import MLFC, BatchNorm, HANCBlock, ResPath
from accunet_tpu_torch.ops.conv import conv1x1, conv_transpose_2x2
from accunet_tpu_torch.ops.kernels.hanc_block import MAX_CIN
from accunet_tpu_torch.ops.pooling import max_pool2d


class ConvTranspose2x2(nn.ConvTranspose2d):
    """torch.nn.ConvTranspose2d(k=2, s=2) on NHWC tensors, evaluated as one
    matmul + depth-to-space. The weight keeps torch's (I, O, 2, 2) layout
    (the JAX tree's `kernel_t`); `bias=False` for the UNETR decoder's."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__(in_features, out_features, 2, stride=2, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_transpose_2x2(x, self.weight, self.bias)


@contextlib.contextmanager
def _frozen_stats(module: nn.Module):
    """Keep `module`'s BatchNorms from updating their running statistics
    (the recompute of a checkpointed block must not count the batch twice)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.frozen_stats = True
    try:
        yield
    finally:
        for m in bns:
            m.frozen_stats = False


class ACCUNet(nn.Module):
    def __init__(self, n_channels: int = 3, n_classes: int = 1, n_filts: int = 32,
                 variant: str = "base", final_sigmoid: bool = True,
                 wide_decoder_block: bool = True, remat: bool = False,
                 hybrid_expand_dw: bool = False, hybrid_e_min: int = 2048,
                 dtype: torch.dtype | None = None):
        super().__init__()
        f = n_filts
        self.n_classes, self.final_sigmoid, self.remat = n_classes, final_sigmoid, remat
        self.dtype = dtype
        mode = {"base": "full", "lite": "lite", "w": "w"}[variant]

        def hanc(n_in, n_out, k, inv=3, level12=False, defer=False):
            # a level-1/2 block is fused when its width fits the kernel
            # (cin <= MAX_CIN); a wider one stays unfused, as in JAX
            fused = level12 and n_in <= MAX_CIN
            return HANCBlock(n_in, n_out, k=k, inv_fctr=inv, fused=fused, defer_se=defer,
                             hybrid=hybrid_expand_dw, hybrid_e_min=hybrid_e_min)

        self.cnv11 = hanc(n_channels, f, 3)
        self.cnv12 = hanc(f, f, 3, level12=True)
        self.cnv21 = hanc(f, f * 2, 3, level12=True, defer=True)
        self.cnv22 = hanc(f * 2, f * 2, 3, level12=True)
        self.cnv31 = hanc(f * 2, f * 4, 3)
        self.cnv32 = hanc(f * 4, f * 4, 3)
        self.cnv41 = hanc(f * 4, f * 8, 2)
        self.cnv42 = hanc(f * 8, f * 8, 2)
        self.cnv51 = hanc(f * 8, f * 16, 1)
        self.cnv52 = hanc(f * 16, f * 16, 1)

        self.rspth1 = ResPath(f, 4, fused=True)
        self.rspth2 = ResPath(f * 2, 3, fused=True)
        self.rspth3 = ResPath(f * 4, 2)
        self.rspth4 = ResPath(f * 8, 1)

        filts = (f, f * 2, f * 4, f * 8)
        self.mlfc1 = MLFC(filts, 1, mode)
        self.mlfc2 = MLFC(filts, 1, mode)
        self.mlfc3 = MLFC(filts, 1, mode)

        self.up6 = ConvTranspose2x2(f * 16, f * 8)
        self.cnv61 = hanc(f * 16, f * 8, 2)
        self.cnv62 = hanc(f * 8, f * 8, 2)
        self.up7 = ConvTranspose2x2(f * 8, f * 4)
        self.cnv71 = hanc(f * 8, f * 4, 3)
        self.cnv72 = hanc(f * 4, f * 4, 3, 34 if wide_decoder_block else 3)
        self.up8 = ConvTranspose2x2(f * 4, f * 2)
        self.cnv81 = hanc(f * 4, f * 2, 3, level12=True, defer=True)
        self.cnv82 = hanc(f * 2, f * 2, 3, level12=True)
        self.up9 = ConvTranspose2x2(f * 2, f)
        self.cnv91 = hanc(f * 2, f, 3, level12=True, defer=True)
        self.cnv92 = hanc(f, f, 3, level12=True)

        out_ch = n_classes if n_classes == 1 else n_classes + 1
        self.out = nn.Conv2d(f, out_ch, 1)

    def _run(self, block: nn.Module, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False,
                              context_fn=lambda: (contextlib.nullcontext(), _frozen_stats(block)))
        return block(*args)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, n_channels), H and W divisible by 16 ->
        (B, H, W, out_ch) float32."""
        r = self._run
        x = x.to(self.out.weight.dtype if self.dtype is None else self.dtype)
        x2 = r(self.cnv12, r(self.cnv11, x))
        x3 = r(self.cnv22, r(self.cnv21, max_pool2d(x2, 2)))
        x4 = r(self.cnv32, r(self.cnv31, max_pool2d(x3, 2)))
        x5 = r(self.cnv42, r(self.cnv41, max_pool2d(x4, 2)))
        x6 = r(self.cnv52, r(self.cnv51, max_pool2d(x5, 2)))

        x2 = r(self.rspth1, x2)
        x3 = r(self.rspth2, x3)
        x4 = r(self.rspth3, x4)
        x5 = r(self.rspth4, x5)
        for mlfc in (self.mlfc1, self.mlfc2, self.mlfc3):
            x2, x3, x4, x5 = r(mlfc, x2, x3, x4, x5)

        x7 = r(self.cnv62, r(self.cnv61, torch.cat([self.up6(x6), x5], dim=-1)))
        x8 = r(self.cnv72, r(self.cnv71, torch.cat([self.up7(x7), x4], dim=-1)))
        x9 = r(self.cnv82, r(self.cnv81, torch.cat([self.up8(x8), x3], dim=-1)))
        x10 = r(self.cnv92, r(self.cnv91, torch.cat([self.up9(x9), x2], dim=-1)))

        logits = conv1x1(x10, self.out.weight, self.out.bias)
        if self.n_classes == 1 and self.final_sigmoid:
            logits = torch.sigmoid(logits)
        return logits.float()


def ACC_UNet(n_channels=3, n_classes=1, n_filts=32, **kw):
    return ACCUNet(n_channels, n_classes, n_filts, variant="base", **kw)


def ACC_UNet_Lite(n_channels=3, n_classes=1, n_filts=32, **kw):
    return ACCUNet(n_channels, n_classes, n_filts, variant="lite", **kw)


def ACC_UNet_W(n_channels=3, n_classes=1, n_filts=32, **kw):
    return ACCUNet(n_channels, n_classes, n_filts, variant="w", **kw)
