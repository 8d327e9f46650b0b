"""How far rounding moves one ACC-UNet train step's gradients, on the CPU.

    python tools/train_step_conditioning.py [--n-filts 8] [--img 64] \
        [--batch 2] [--ablate lrelu|maxpool]

A diagnostic of the PyTorch port (accunet_tpu_torch), run from the root of
the repository. For one seeded step (weighted Dice+BCE, backward) it prints:
  * the largest difference between the float32 and the float64 gradients,
    over the largest float64 gradient, in train mode and in eval mode, and
    the two losses;
  * in train mode, how far the float64 gradients move when the input is
    scaled by 1 + eps, eps = 1e-14, 1e-10, 1e-7: a smooth function moves in
    proportion to eps, a jump shows a LeakyReLU input crossing 0.
`--ablate lrelu` runs the blocks with the identity in place of LeakyReLU,
`--ablate maxpool` with average pools in place of max pools. chip_smoke.py
(phase 8) and tests/test_torch_train_engine.py choose their comparisons of
a whole train step by what it reports.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
from unittest import mock


def step_grads(model, x, y, dtype, train: bool):
    """(loss, [gradients as float64]) of one step of a copy of `model`."""
    from accunet_tpu_torch.train.losses import weighted_dice_bce

    m = copy.deepcopy(model).to(dtype).train(train)
    loss = weighted_dice_bce(m(x.to(dtype)), y.to(dtype))
    loss.backward()
    return loss.item(), [p.grad.double() for p in m.parameters()]


def gap(got, want) -> float:
    """Largest |got - want| over the largest |want|, over all parameters."""
    scale = max(float(w.abs().max()) for w in want)
    return max(float((g - w).abs().max()) for g, w in zip(got, want)) / scale


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-filts", type=int, default=8)
    ap.add_argument("--img", type=int, default=64)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--ablate", choices=["lrelu", "maxpool"], default=None)
    args = ap.parse_args(argv)
    # the package lives at the root of the repository, beside tools/
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import numpy as np
    import torch

    from accunet_tpu_torch.models import ACC_UNet, acc_unet, init_parameters
    from accunet_tpu_torch.nn import acc_blocks
    from accunet_tpu_torch.ops import pooling
    from accunet_tpu_torch.ops.kernels import hanc_mix

    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.rand(args.batch, args.img, args.img, 3))
    y = torch.from_numpy((rs.rand(args.batch, args.img, args.img, 1) > 0.5).astype(np.float64))
    model = init_parameters(ACC_UNet(3, 1, args.n_filts), torch.Generator().manual_seed(0))
    patches = {
        None: [],
        "lrelu": [mock.patch.object(acc_blocks, "lrelu", lambda t: t)],
        "maxpool": [mock.patch.object(hanc_mix, "max_pool2d", pooling.avg_pool2d),
                    mock.patch.object(acc_unet, "max_pool2d", pooling.avg_pool2d)],
    }[args.ablate]
    head = f"n_filts={args.n_filts} {args.img}x{args.img} b{args.batch} ablate={args.ablate}"
    res = {}
    for p in patches:
        p.start()
    try:
        for mode in ("train", "eval"):
            l32, g32 = step_grads(model, x, y, torch.float32, mode == "train")
            l64, g64 = step_grads(model, x, y, torch.float64, mode == "train")
            res[mode] = gap(g32, g64)
            print(f"{head} {mode}: fp32 vs float64 gradient gap {res[mode]:.3e} of the largest "
                  f"gradient; loss fp32 {l32:.9f} float64 {l64:.9f}")
            if mode == "train":
                for eps in (1e-14, 1e-10, 1e-7):
                    res[f"perturb {eps:g}"] = gap(
                        step_grads(model, x * (1 + eps), y, torch.float64, True)[1], g64)
                    print(f"{head} train: float64 gradients, input x (1 + {eps:g}): moved "
                          f"{res[f'perturb {eps:g}']:.3e} of the largest gradient")
    finally:
        for p in patches:
            p.stop()
    return res


if __name__ == "__main__":
    main()
