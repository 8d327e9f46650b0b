"""Training entry point of the port (counterpart of accunet_tpu/cli/train.py).

    python -m accunet_tpu_torch.cli.train --model ACC_UNet --task ISIC18 \
        --train-dir /data/ISIC18/Train_Folder --val-dir /data/ISIC18/Val_Folder \
        [--n-classes 9] [--resume auto --ckpt-dir ckpt] [--device cuda] \
        [--set train.lr=3e-4 data.batch_size=16 ...]
    torchrun --nproc-per-node 4 -m accunet_tpu_torch.cli.train --distributed \
        --mesh data=4 ...    (or data=2,model=2; one process a card)

`--model Segmamba` trains the SegMamba baseline (built with in_chans /
out_chans, as the JAX CLI builds SegMamba models; binary Dice+BCE at 224 by
the config). `--model UNext` (UNeXt, BASELINE config 3; also UNext_S and the
23 UNext_CMRF names) trains with weighted Dice+BCE, at 224 for UNext by the
config (256 for the UNext_CMRF names, as in JAX); each train step runs the
dwconv2d_wgrad kernel once per shifted-MLP block (4 a step), three times per
rKAN block for UNext_CMRF_GS_Wavelet_rKAN (12 a step); no validation forward
runs it. The UNet baselines (`UNet_base`, `Unetpp`, `MultiResUnet`
and its 'MultiResUnet1_<nfilt>_<alpha>' names, `UCTransNet`, the four TransUNet
names) train with weighted Dice+BCE and run no hand-written kernel; a
TransUNet name is built at the image size, whose grid sizes its position
embeddings, and UCTransNet keeps its img_size 224, as JAX's CLI builds it
(train it with --img-size 224: at its 256 preset it fails as JAX's does).
SwinUnet and SMESwinUnet (224, SGD by the config), SegViT_fKAN (built with
in_chans / out_chans and the image size; binary Dice+BCE on its logits)
and TinyUNet (256) run no hand-written kernel either; `models.build_for`
is the build rule of every CLI.
`--synthetic` trains on a generated random npy folder instead
of dataset directories. Seeding: numpy, the loaders and the model's initialisation (a
torch.Generator) all take cfg.train.seed. `--device cuda` (the default)
raises when CUDA is unavailable; it never falls back to the CPU.

`--set train.compute_dtype=bfloat16` trains every non-SegMamba model in bf16,
as JAX builds them with `dtype=jnp.bfloat16` (accunet_tpu/cli/train.py:261-268):
the layers compute in bf16 with the fp32 parameters cast at use, Adam's state
stays fp32, the BatchNorms take fp32 statistics and the losses take the
model's fp32 output; on the card hanc_mix and the depthwise backward's
dwconv2d_wgrad run their bf16 paths. SegMamba models train in fp32 under
either setting, as JAX builds them without a dtype; the run logs one line
saying so. `--vis-dir` saves the first validation batch's input, mask and
prediction images every `--vis-frequency` epochs.

Scale-out (JAX's --mesh / --distributed): `--distributed` initialises
torch.distributed from torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR / MASTER_PORT), `--distributed ADDR:PORT,RANK,WORLD`
over tcp://ADDR:PORT; NCCL for cuda (each rank on cuda:LOCAL_RANK, or
cuda:RANK without LOCAL_RANK), gloo for --device cpu. `--mesh
data=D,model=M,seq=S` (D*M*S = the world size; data=-1 takes the rest)
places the step on the mesh (train/engine.py): each rank loads its data
slice of every global batch (data.batch_size is the global batch), the step
equals one process's on the global batch, and rank 0 alone logs and writes
checkpoints, which are a one-process run's file and load under any mesh or
none. `--distributed` without `--mesh` is refused: JAX's CLI then trains a
separate copy in each process on its own slice with no exchange (ROADMAP
Queue 3). The CLI never enters sequence_sharding, as JAX's never does: a seq
axis replicates the step, and parallel/seq_scan.py's tests drive it.

Text prompts, with JAX's rule: a model of TEXT_MODELS (or any model with
`--text`) reads the prompt file of --train-dir and --val-dir
(data/text_prompts.py: a .csv or .xlsx with Filename,Text columns or the
other two conventions); each batch's prompts, looked up by image file name
("" when absent), go through ClinicalTextEncoder (nn/text.py; without
ClinicalBERT's weights it warns and uses the FakeTextEncoder stub) and
reach the model as `text_tokens`. A TEXT_MODELS name without a prompt file
in --train-dir trains on the images alone, unless `--text` is given.
"""

from __future__ import annotations

import argparse
import ast
import functools
import logging
import os
import tempfile

# the text-conditioned models (the JAX CLI's TEXT_MODELS)
TEXT_MODELS = {
    "Segmamba_hybrid_gsc_KAN_PE_ds_text",
    "Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn",
    "Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn_TGDC",
    "Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn_HSLCA",
    "Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn_Dual",
    "Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn_HSLCA_SpatialMamba",
    "Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn_HSLCA_SpatialMamba_KAN",
    "Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn_SpatialMamba",
    "Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn_Dual_SpatialMamba",
    "Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn_HSLCA_SpatialMamba_no_text",
}


def parse_overrides(pairs):
    """['train.lr=3e-4', ...] -> {'train.lr': 3e-4}: Python literals, else
    the string as given."""
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def write_synthetic(root: str, size: int, n_classes: int) -> tuple[str, str]:
    """An ISIC-style npy folder pair (8 train, 4 val samples) from seed 0."""
    import numpy as np

    rng0 = np.random.RandomState(0)
    for split, n in (("train", 8), ("val", 4)):
        d = os.path.join(root, split)
        os.makedirs(os.path.join(d, "images"))
        os.makedirs(os.path.join(d, "masks"))
        for i in range(n):
            img = rng0.rand(4, size, size).astype(np.float32)
            msk = (rng0.rand(size, size) > 0.5).astype(np.float32)
            if n_classes > 1:
                msk = rng0.randint(0, n_classes + 1, (size, size)).astype(np.float32)
            np.save(os.path.join(d, "images", f"s{i:03d}.npy"), img)
            np.save(os.path.join(d, "masks", f"s{i:03d}.npy"), msk)
    return os.path.join(root, "train"), os.path.join(root, "val")


def parse_mesh(spec: str):
    """'data=4,model=2' -> MeshSpec(data=4, model=2)."""
    from accunet_tpu_torch.parallel.mesh import MeshSpec

    kw = {}
    for part in spec.split(","):
        k, v = part.split("=")
        kw[k.strip()] = int(v)
    return MeshSpec(**kw)


def init_distributed(spec: str, device):
    """Initialise the default process group from torchrun's environment
    (spec 'env') or from 'ADDR:PORT,RANK,WORLD', and return the rank's
    device: NCCL for cuda, the rank bound to cuda:LOCAL_RANK (else
    cuda:RANK) unless `device` names a card; gloo for the CPU."""
    import torch
    import torch.distributed as dist

    if spec == "env":
        rank, kw = int(os.environ.get("RANK", 0)), {}
    else:
        addr, rank, world = spec.rsplit(",", 2)
        rank = int(rank)
        kw = dict(init_method=f"tcp://{addr}", rank=rank, world_size=int(world))
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        if device.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank}: {device} does not exist "
                               f"({torch.cuda.device_count()} CUDA devices)")
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", **kw)
    return device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="ACC_UNet")
    ap.add_argument("--task", default="ISIC18")
    ap.add_argument("--train-dir", default=None)
    ap.add_argument("--val-dir", default=None)
    ap.add_argument("--synthetic", action="store_true",
                    help="train on a generated random dataset (no dirs needed)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--img-size", type=int, default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--n-classes", type=int, default=1,
                    help=">1 trains an (n+1)-way softmax head")
    ap.add_argument("--text", action="store_true",
                    help="use text prompts with any model, and with a TEXT_MODELS model even "
                         "without a prompt file")
    ap.add_argument("--check-numerics", action="store_true",
                    help="abort on the first non-finite train loss (a device sync per batch)")
    ap.add_argument("--resume", default=None,
                    help="checkpoint path to resume, or 'auto' for the newest "
                         "restorable checkpoint in --ckpt-dir (a fresh run if none)")
    ap.add_argument("--train-split", default=None,
                    help="frozen split file (one sample id per line) restricting --train-dir")
    ap.add_argument("--val-split", default=None,
                    help="frozen split file restricting --val-dir")
    ap.add_argument("--vis-dir", default=None,
                    help="save input/gt/pred PNGs of the first val batch every --vis-frequency "
                         "epochs")
    ap.add_argument("--vis-frequency", type=int, default=10)
    ap.add_argument("--set", nargs="*", default=[], help="dotted config overrides")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    ap.add_argument("--mesh", default=None,
                    help="mesh of the ranks, e.g. data=4 or data=2,model=2 (more than one rank "
                         "needs --distributed)")
    ap.add_argument("--distributed", nargs="?", const="env", default=None,
                    help="start torch.distributed: from torchrun's environment with no value, "
                         "or 'ADDR:PORT,RANK,WORLD'")
    args = ap.parse_args(argv)
    if args.distributed and not args.mesh:
        ap.error("--distributed needs --mesh, e.g. --mesh data=N for N ranks: without one each "
                 "rank would train its own copy on its own data slice, with no exchange")

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")
    if args.distributed:
        device = init_distributed(args.distributed, device)
    try:
        return _train(args, ap, device)
    finally:
        if args.distributed:
            torch.distributed.destroy_process_group()


def _train(args, ap, device):
    import numpy as np
    import torch

    from accunet_tpu_torch.config import get_config
    from accunet_tpu_torch.data.dataset import SegmentationDataset, list_split_ids
    from accunet_tpu_torch.data.loader import BatchLoader, PrefetchLoader
    from accunet_tpu_torch.data.transforms import RandomGenerator, ValGenerator
    from accunet_tpu_torch.models import build_for, init_parameters, takes_dtype
    from accunet_tpu_torch.parallel.mesh import make_mesh
    from accunet_tpu_torch.train import losses as L
    from accunet_tpu_torch.train import metrics as M
    from accunet_tpu_torch.train.engine import (
        RESTORE_ERRORS, fit, list_checkpoints, make_train_fns, restore_checkpoint,
    )

    mesh = make_mesh(parse_mesh(args.mesh)) if args.mesh else None
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    if mesh is not None:
        logging.info("mesh %s: rank %d of %d at %s on %s", mesh.shape, mesh.rank,
                     mesh.shape["data"] * mesh.shape["model"] * mesh.shape["seq"], mesh.coords,
                     device)
        if not mesh.is_chief:  # rank 0 alone logs
            logging.getLogger().setLevel(logging.WARNING)
    data_index, data_count = (0, 1) if mesh is None else (mesh.coords["data"], mesh.shape["data"])

    synth_dir = None
    if args.synthetic:
        synth_dir = tempfile.TemporaryDirectory(prefix="accunet_synth_")
        args.train_dir, args.val_dir = write_synthetic(
            synth_dir.name, args.img_size or 64, args.n_classes)
    if not args.train_dir or not args.val_dir:
        ap.error("--train-dir/--val-dir required (or pass --synthetic)")

    cfg = get_config(args.model, args.task)
    cfg.data.train_dir, cfg.data.val_dir = args.train_dir, args.val_dir
    if args.img_size:
        cfg.data.img_size = args.img_size
    if args.batch:
        cfg.data.batch_size = args.batch
    if args.epochs:
        cfg.train.epochs = args.epochs
    if args.ckpt_dir:
        cfg.train.ckpt_dir = args.ckpt_dir
    cfg = cfg.override(parse_overrides(args.set))
    compute_dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(
        cfg.train.compute_dtype)
    if compute_dtype is None:
        raise ValueError(f"train.compute_dtype={cfg.train.compute_dtype!r}: float32 or bfloat16")

    np.random.seed(cfg.train.seed)

    binarize = args.n_classes == 1  # multi-class keeps integer label ids
    train_ds = SegmentationDataset(
        cfg.data.train_dir, cfg.data.img_size,
        ids=list_split_ids(args.train_split) if args.train_split else None,
        binarize_mask=binarize,
    )
    val_ds = SegmentationDataset(
        cfg.data.val_dir, cfg.data.img_size,
        ids=list_split_ids(args.val_split) if args.val_split else None,
        binarize_mask=binarize,
    )
    hw = (cfg.data.img_size, cfg.data.img_size)
    train_loader = PrefetchLoader(BatchLoader(
        train_ds, cfg.data.batch_size, RandomGenerator(hw), shuffle=True,
        seed=cfg.train.seed, drop_last=True,
        process_index=data_index, process_count=data_count,
    ))
    val_loader = PrefetchLoader(BatchLoader(val_ds, cfg.data.batch_size, ValGenerator(hw),
                                            pad_last=True, process_index=data_index,
                                            process_count=data_count))

    use_text = args.text or args.model in TEXT_MODELS
    text_encoder = train_text = val_text = None
    if use_text:
        from accunet_tpu_torch.data.text_prompts import read_text
        from accunet_tpu_torch.nn.text import ClinicalTextEncoder

        train_text, val_text = read_text(cfg.data.train_dir), read_text(cfg.data.val_dir)
        if train_text is None and not args.text:
            use_text = False  # a TEXT_MODELS model trained on the images alone
        else:
            text_encoder = ClinicalTextEncoder()
            logging.info("text prompts enabled (%d train entries)", len(train_text or {}))

    def embed_texts(names):
        prompts = [(train_text or {}).get(n) or (val_text or {}).get(n) or "" for n in names]
        return torch.from_numpy(text_encoder(prompts)).to(device)

    sample, _ = train_ds[0]
    n_cls = args.n_classes
    n_ch = sample["image"].shape[-1]
    if compute_dtype != torch.float32 and not takes_dtype(args.model):
        logging.info("%s trains in float32: SegMamba models take no compute dtype, as in JAX",
                     args.model)
    model = build_for(args.model, cfg.data.img_size, n_ch, n_cls, compute_dtype,
                      **cfg.model.kwargs)
    init_parameters(model, torch.Generator().manual_seed(cfg.train.seed))
    model = model.to(device)

    if n_cls > 1:
        loss_fn, dice_show, iou_fn = L.multiclass_dice_ce, L.multiclass_dice_show, M.multiclass_batch_iou
    else:
        loss_fn, dice_show, iou_fn = L.LOSSES[cfg.train.loss], L.soft_dice_show, M.batch_iou

    def device_batches(loader):
        for b in loader:
            out = {"image": torch.from_numpy(b["image"]).to(device),
                   "mask": torch.from_numpy(b["mask"]).to(device)}
            if use_text:
                out["text_emb"] = embed_texts(b["names"])
            yield out

    fns = make_train_fns(
        model, loss_fn=loss_fn, learning_rate=cfg.train.lr,
        optimizer_name=cfg.train.optimizer, steps_per_epoch=max(len(train_loader), 1),
        dice_show=dice_show, iou_fn=iou_fn, mesh=mesh,
    )
    meta = None
    if args.resume == "auto":
        # the newest checkpoint that restores; a corrupt one falls back to
        # the next-newest, none at all is a fresh run
        args.resume = None
        candidates = list_checkpoints(cfg.train.ckpt_dir)
        if mesh is not None and torch.distributed.is_initialized():
            # every rank tries rank 0's list, so all restore the same file
            box = [candidates]
            torch.distributed.broadcast_object_list(box, src=0)
            candidates = box[0]
        for path in reversed(candidates):
            try:
                _, meta = restore_checkpoint(path, fns.state)
            except RESTORE_ERRORS as e:
                logging.warning("--resume auto: %s unrestorable (%s), trying next-newest", path, e)
                continue
            args.resume = path
            break
        if args.resume is None:
            logging.info("--resume auto: no checkpoint found, fresh run")
    elif args.resume:
        _, meta = restore_checkpoint(args.resume, fns.state)
    resume_kw = {}
    if meta is not None:
        logging.info("resumed from %s at epoch %d (best dice %.4f @ epoch %d)",
                     args.resume, meta["epoch"], meta["best_dice"], meta["best_epoch"])
        resume_kw = dict(start_epoch=meta["epoch"], best_dice=meta["best_dice"],
                         best_epoch=meta["best_epoch"])

    try:
        state, history = fit(
            fns,
            functools.partial(device_batches, train_loader),
            functools.partial(device_batches, val_loader),
            epochs=cfg.train.epochs,
            ckpt_dir=cfg.train.ckpt_dir,
            early_stop_patience=cfg.train.early_stop_patience,
            check_numerics=args.check_numerics,
            vis_dir=args.vis_dir,
            vis_frequency=args.vis_frequency,
            **resume_kw,
        )
    finally:
        if synth_dir is not None:
            synth_dir.cleanup()
    logging.info("done: best val dice %.4f",
                 max((h["val"].get("dice", 0) for h in history), default=0))
    return state, history


if __name__ == "__main__":
    main()
