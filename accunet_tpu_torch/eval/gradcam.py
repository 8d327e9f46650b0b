"""Seg-Grad-CAM: class activation maps for segmentation, counterpart of
accunet_tpu/eval/gradcam.py (`seg_grad_cam`, `_score`).

A forward hook on the module whose dotted name is `layer` (the port keeps
JAX's module names: "cnv92", "up9", "block1.0") takes its output A and
returns A + delta, delta a zero tensor that requires grad, so one forward
both captures A and makes the score differentiable in it; JAX captures A in
one apply and intercepts a second. Then

    score = mean(output)                              (one channel)
          | mean(output[..., class_idx])             (multi-class, given)
          | mean(output[b, ..., argmax_c sum_hw])    (multi-class, per sample)
    CAM   = ReLU( sum_c mean_hw(dScore/dA_c) * A_c )

bilinear to the input's size (align_corners=False) and min-max normalised
per image to [0, 1]. The model runs as the caller left it (the gradcam CLI:
eval mode), so on the card the gradient passes back through the fused eval
kernels' autograd functions (`HancBlockFn`, `RespathLevelFn`, `ExpandDwFn`:
the VJPs of their plain versions). The parameters do not require grad for
the duration of the call: only dScore/dA is wanted.
"""

from __future__ import annotations

import torch

from accunet_tpu_torch.nn.acc_blocks import PendingSE
from accunet_tpu_torch.ops.resize import resize_bilinear


def _score(logits: torch.Tensor, class_idx: int | None) -> torch.Tensor:
    if logits.shape[-1] == 1:
        return logits.mean()
    if class_idx is not None:
        return logits[..., class_idx].mean()
    idx = logits.sum(dim=(1, 2)).argmax(dim=-1)  # per-sample argmax class
    sel = torch.take_along_dim(logits, idx[:, None, None, None], dim=-1)
    return sel.mean()


def seg_grad_cam(model: torch.nn.Module, x: torch.Tensor, layer: str,
                 class_idx: int | None = None) -> torch.Tensor:
    """CAM heatmaps (B, H, W) float32 in [0, 1] of `model` on x (B, H, W, C)
    at the output of the module named `layer` (dotted, as named_modules
    gives it). A fused block that hands its SE on to the next block
    (`PendingSE`) is captured after that SE."""
    target = dict(model.named_modules()).get(layer)
    if target is None or not layer:
        raise KeyError(f"no module {layer!r} in {type(model).__name__}")
    seen = {}

    def hook(_mod, _inp, out):
        if isinstance(out, PendingSE):
            out = out.apply()
        if not isinstance(out, torch.Tensor):
            raise TypeError(f"{layer} returns {type(out).__name__}, not a map")
        delta = torch.zeros_like(out, requires_grad=True)
        seen["act"], seen["delta"] = out.detach(), delta
        return out + delta

    params = [p for p in model.parameters() if p.requires_grad]
    handle = target.register_forward_hook(hook)
    try:
        for p in params:
            p.requires_grad_(False)
        with torch.enable_grad():
            out = model(x)
            if isinstance(out, (tuple, list)):
                out = out[0]
            (grads,) = torch.autograd.grad(_score(out, class_idx), seen["delta"])
    finally:
        handle.remove()
        for p in params:
            p.requires_grad_(True)
    act = seen["act"].float()
    weights = grads.float().mean(dim=(1, 2), keepdim=True)
    cam = torch.relu((weights * act).sum(-1))
    cam = resize_bilinear(cam[..., None], tuple(x.shape[1:3]), align_corners=False)[..., 0]
    cmin = cam.amin(dim=(1, 2), keepdim=True)
    cmax = cam.amax(dim=(1, 2), keepdim=True)
    return (cam - cmin) / (cmax - cmin + 1e-8)
