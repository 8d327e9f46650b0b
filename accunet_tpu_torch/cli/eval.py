"""Evaluation entry point of the port (counterpart of accunet_tpu/cli/eval.py).

    python -m accunet_tpu_torch.cli.eval --model ACC_UNet --task ISIC18 \
        --test-dir /data/ISIC18/Test_Folder \
        [--torch-ckpt best_model-ACC_UNet.pth.tar] [--csv out.csv] [--device cuda]

Any segmentation model of the registry evaluates the same way (`--model
UNext`, `KNUnet`, `UKAN`, the 23 UNext_CMRF names, `UNet_base`, `Unetpp`,
`MultiResUnet`, `UCTransNet` with --img-size 224, the TransUNet names and
SegViT_fKAN, built at the image size, `SwinUnet` and `SMESwinUnet` at 224,
`TinyUNet`, ...), built by `models.build_for` as every CLI builds it: a
`Segmamba*` name and SegViT_fKAN with in_chans / out_chans (JAX's eval CLI
builds every model with n_channels / n_classes, which their builders
refuse); a deep-supervision model is scored on its main output. A
TEXT_MODELS name (cli/train.py) reads the prompt file of --test-dir, as the
train CLI reads its folders', and gives the model each image's prompt
embedding; without a prompt file it evaluates on the images alone. Without
--torch-ckpt the model gets seeded random weights; a reference SegMamba
file's 3-D kernels give their centre depth tap (port/torch_ckpt.py).
`--device cuda` (the default) raises when CUDA is unavailable; it never
falls back to the CPU.
"""

from __future__ import annotations

import argparse
import ast
import logging


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="ACC_UNet")
    ap.add_argument("--task", default="ISIC18")
    ap.add_argument("--test-dir", required=True)
    ap.add_argument("--torch-ckpt", default=None, help="reference .pth.tar to load")
    ap.add_argument("--n-classes", type=int, default=1,
                    help=">1 evaluates an (n+1)-way argmax head")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--img-size", type=int, default=None,
                    help="override the preset image size")
    ap.add_argument("--split", default=None,
                    help="frozen split file (one sample id per line) restricting --test-dir")
    ap.add_argument("--csv", default="metrics_results.csv")
    ap.add_argument("--result", default="test.result")
    ap.add_argument("--dump-dir", default=None)
    ap.add_argument("--model-kwargs", default=None,
                    help="python dict literal of extra model kwargs, must match "
                         "the checkpoint (e.g. \"{'n_filts': 8}\")")
    ap.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    args = ap.parse_args(argv)

    import torch

    from accunet_tpu_torch.cli.train import TEXT_MODELS
    from accunet_tpu_torch.config import get_config
    from accunet_tpu_torch.data.dataset import SegmentationDataset, list_split_ids
    from accunet_tpu_torch.data.loader import BatchLoader
    from accunet_tpu_torch.data.transforms import ValGenerator
    from accunet_tpu_torch.eval.evaluate import evaluate_model
    from accunet_tpu_torch.models import build_for, init_parameters
    from accunet_tpu_torch.port import load_reference_checkpoint
    from accunet_tpu_torch.train.engine import main_output

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    cfg = get_config(args.model, args.task)
    if args.img_size:
        cfg.data.img_size = args.img_size

    ds = SegmentationDataset(
        args.test_dir, cfg.data.img_size,
        ids=list_split_ids(args.split) if args.split else None,
        binarize_mask=args.n_classes == 1,
    )
    loader = BatchLoader(
        ds, args.batch, ValGenerator((cfg.data.img_size, cfg.data.img_size)), pad_last=True,
    )
    sample, _ = ds[0]
    n_ch = sample["image"].shape[-1]
    kwargs = ast.literal_eval(args.model_kwargs) if args.model_kwargs else {}
    model = build_for(args.model, cfg.data.img_size, n_ch, args.n_classes, **kwargs)
    init_parameters(model, torch.Generator().manual_seed(0))
    if args.torch_ckpt:
        load_reference_checkpoint(model, args.torch_ckpt)
    model = model.to(device).eval()

    batches = loader
    if args.model in TEXT_MODELS:
        from accunet_tpu_torch.data.text_prompts import read_text

        prompts = read_text(args.test_dir)
        if prompts is not None:
            from accunet_tpu_torch.nn.text import ClinicalTextEncoder

            encoder = ClinicalTextEncoder()
            logging.info("text prompts enabled (%d entries)", len(prompts))
            batches = ({**b, "text_emb": encoder([prompts.get(n) or "" for n in b["names"]])}
                       for b in loader)

    res = evaluate_model(
        lambda *inputs: main_output(model(*inputs)), batches, device,
        result_file=args.result, csv_file=args.csv, dump_dir=args.dump_dir,
        model_name=args.model, task_name=args.task,
    )
    logging.info(res.summary_line(args.model, args.task))
    logging.info("%.2f ms/image on %s", res.seconds_per_image * 1e3, device)
    return res


if __name__ == "__main__":
    main()
