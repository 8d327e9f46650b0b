"""Seg-Grad-CAM entry point of the port (counterpart of
accunet_tpu/cli/gradcam.py, the reference's test_model_gradcam.py).

    python -m accunet_tpu_torch.cli.gradcam --model ACC_UNet --test-dir DIR \
        [--ckpt ckpt/epoch_0003.pth.tar | --torch-ckpt best_model.pth.tar] \
        [--layer cnv92] [--class-idx 1] [--n-classes 1] [--batch 4] \
        [--img-size 224] [--out-dir gradcam_out] [--limit N] [--device cuda]

Loads a checkpoint that the port's train CLI wrote (`--ckpt`, the files that
`--resume` reads) or a reference-format .pth.tar (`--torch-ckpt`; a
reference SegMamba file's 3-D kernels give their centre depth tap,
port/torch_ckpt.py), else keeps seeded random weights, runs the model in
eval mode and writes, per test image, <stem>_cam.npz (cam, image, mask)
and, when PIL imports, an overlay <stem>_cam.png, as the JAX CLI does. The
default layer is the last top-level module with parameters in name order,
JAX's rule (:87-91; "up9" for ACC-UNet). `--device cuda` (the default) raises when CUDA is
unavailable; it never falls back to the CPU. On the card the fused eval
kernels run forward and their plain versions' VJPs backward.
"""

from __future__ import annotations

import argparse
import ast
import logging
import os


def default_layer(model) -> str:
    """The last top-level module with parameters, in name order."""
    return sorted(name for name, mod in model.named_children()
                  if any(True for _ in mod.parameters()))[-1]


def overlay(image, cam):
    """uint8 RGB: the image's channel mean (min-max normalised) blended half
    and half with a blue-green-red map of the CAM."""
    import numpy as np

    img = (image - image.min()) / (image.max() - image.min() + 1e-8)
    rgb = np.stack([np.clip(1.5 * cam, 0, 1), np.clip(1.5 * (1 - abs(2 * cam - 1)), 0, 1),
                    np.clip(1.5 * (1 - cam), 0, 1)], axis=-1)
    base = np.repeat(img.mean(-1, keepdims=True), 3, -1)
    return np.uint8(255 * (0.5 * base + 0.5 * rgb))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="ACC_UNet")
    ap.add_argument("--task", default="ISIC18")
    ap.add_argument("--test-dir", required=True)
    ap.add_argument("--ckpt", default=None,
                    help="a checkpoint of the port's train CLI (epoch_NNNN.pth.tar)")
    ap.add_argument("--torch-ckpt", default=None, help="reference .pth.tar")
    ap.add_argument("--layer", default=None,
                    help="dotted module name, e.g. cnv92 or block1.0 (default: the last "
                         "top-level module with parameters)")
    ap.add_argument("--class-idx", type=int, default=None)
    ap.add_argument("--n-classes", type=int, default=1)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--img-size", type=int, default=None)
    ap.add_argument("--out-dir", default="gradcam_out")
    ap.add_argument("--limit", type=int, default=None, help="stop after this many images")
    ap.add_argument("--model-kwargs", default=None,
                    help="python dict literal of extra model kwargs, must match the checkpoint")
    ap.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from accunet_tpu_torch.config import get_config
    from accunet_tpu_torch.data.dataset import SegmentationDataset
    from accunet_tpu_torch.data.loader import BatchLoader
    from accunet_tpu_torch.data.transforms import ValGenerator
    from accunet_tpu_torch.eval.gradcam import seg_grad_cam
    from accunet_tpu_torch.models import build_for, init_parameters
    from accunet_tpu_torch.port import load_reference_checkpoint, read_checkpoint

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")
    if args.ckpt and args.torch_ckpt:
        ap.error("--ckpt and --torch-ckpt exclude each other")

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    cfg = get_config(args.model, args.task)
    if args.img_size:
        cfg.data.img_size = args.img_size
    ds = SegmentationDataset(args.test_dir, cfg.data.img_size,
                             binarize_mask=args.n_classes == 1)
    loader = BatchLoader(ds, args.batch, ValGenerator((cfg.data.img_size, cfg.data.img_size)),
                         pad_last=True)
    sample, _ = ds[0]
    n_ch = sample["image"].shape[-1]
    kwargs = ast.literal_eval(args.model_kwargs) if args.model_kwargs else {}
    model = build_for(args.model, cfg.data.img_size, n_ch, args.n_classes, **kwargs)
    init_parameters(model, torch.Generator().manual_seed(0))
    if args.ckpt:
        model.load_state_dict(read_checkpoint(args.ckpt), strict=True)
    elif args.torch_ckpt:
        load_reference_checkpoint(model, args.torch_ckpt)
    model = model.to(device).eval()
    layer = args.layer or default_layer(model)
    logging.info("CAM layer: %s", layer)

    os.makedirs(args.out_dir, exist_ok=True)
    try:
        from PIL import Image
    except ImportError:
        Image = None
    n_done = 0
    for batch in loader:
        x = torch.from_numpy(batch["image"]).to(device)
        cams = seg_grad_cam(model, x, layer, class_idx=args.class_idx).cpu().numpy()
        for i, name in enumerate(batch["names"][:batch["count"]]):  # not the padding
            stem = os.path.splitext(os.path.basename(name))[0]
            image = np.asarray(batch["image"][i])
            np.savez(os.path.join(args.out_dir, f"{stem}_cam.npz"), cam=cams[i], image=image,
                     mask=np.asarray(batch["mask"][i]))
            if Image is not None:
                Image.fromarray(overlay(image, cams[i])).save(
                    os.path.join(args.out_dir, f"{stem}_cam.png"))
            n_done += 1
            if args.limit and n_done >= args.limit:
                logging.info("wrote %d CAMs to %s", n_done, args.out_dir)
                return n_done
    logging.info("wrote %d CAMs to %s", n_done, args.out_dir)
    return n_done


if __name__ == "__main__":
    main()
