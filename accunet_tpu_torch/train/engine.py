"""Training engine: train/eval steps, the epoch loop and checkpoints.

Counterpart of accunet_tpu/train/engine.py, without a mesh and without orbax:

  * `make_train_fns` builds the optimizer (Adam, or SGD momentum 0.9 with
    weight decay 1e-4), the cosine-warm-restart schedule and the steps. A
    `TrainState` holds the model, the optimizer and the step count; the train
    step updates it in place (the JAX step returns a new state) and returns it
    with the stats {loss, dice, iou, lr}, computed from the predictions made
    before the update, as JAX does. Stats stay tensors on the device; the
    epoch loop reads them once per epoch.
  * `run_epoch` (optional per-batch non-finite-loss check) and `fit`
    (best-dice checkpointing, early stopping, resume; epoch scalars to
    TensorBoard through tensorboardX when it imports; the first validation
    batch's predictions as images every `vis_frequency` epochs).
  * checkpoints are `epoch_NNNN.pth.tar` files from `torch.save` holding
    {epoch, best_dice, best_epoch, step, state_dict, optimizer}, written to a
    temporary name and renamed into place, so an interrupted save never
    looks like a checkpoint.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import pickle
import re
import time
from typing import Any, Callable, Iterable

import torch
from torch import nn

from accunet_tpu_torch.train import losses as L
from accunet_tpu_torch.train import metrics as M
from accunet_tpu_torch.train.schedules import cosine_warm_restarts

logger = logging.getLogger("accunet_tpu_torch")


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


@dataclasses.dataclass
class TrainStepFns:
    train_step: Callable  # (state, batch) -> (state, stats)
    eval_step: Callable  # (state, batch) -> stats
    predict_step: Callable  # (state, batch) -> main output
    state: TrainState


def _main_output(preds):
    if isinstance(preds, (tuple, list)):
        if len(preds) == 2 and isinstance(preds[0], (tuple, list)):
            return preds[1]
        return preds[0]
    return preds


def make_train_fns(
    model: nn.Module,
    loss_fn: Callable = L.weighted_dice_bce,
    learning_rate: float = 1e-3,
    optimizer_name: str = "adam",
    steps_per_epoch: int = 1,
    dice_show: Callable = L.soft_dice_show,
    iou_fn: Callable = M.batch_iou,
) -> TrainStepFns:
    """Steps and initial state for `model`, whose parameters are already
    initialised and on their device. Batches are {'image', 'mask'} tensors
    on the model's device; loss_fn(preds, masks)."""
    schedule = cosine_warm_restarts(
        learning_rate, t_0=10, t_mult=1, eta_min=1e-5, steps_per_epoch=steps_per_epoch
    )
    if optimizer_name == "adam":
        optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate)
    elif optimizer_name == "sgd":
        # Swin family: SGD momentum 0.9, weight decay 1e-4 added to the grad
        optimizer = torch.optim.SGD(model.parameters(), lr=learning_rate, momentum=0.9,
                                    weight_decay=1e-4)
    else:
        raise ValueError(optimizer_name)
    state = TrainState(model, optimizer)

    def train_step(state: TrainState, batch):
        lr = schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.model.train()
        preds = state.model(batch["image"])
        loss = loss_fn(preds, batch["mask"])
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            main = _main_output(preds).detach()
            stats = {
                "loss": loss.detach(),
                "dice": dice_show(main, batch["mask"]),
                "iou": iou_fn(main, batch["mask"]),
                "lr": lr,
            }
        return state, stats

    def eval_step(state: TrainState, batch):
        state.model.eval()
        with torch.no_grad():
            preds = state.model(batch["image"])
            main = _main_output(preds)
            return {
                "loss": loss_fn(preds, batch["mask"]),
                "dice": dice_show(main, batch["mask"]),
                "iou": iou_fn(main, batch["mask"]),
            }

    def predict_step(state: TrainState, batch):
        state.model.eval()
        with torch.no_grad():
            return _main_output(state.model(batch["image"]))

    return TrainStepFns(train_step, eval_step, predict_step, state)


def run_epoch(step_fn, state, loader: Iterable, train: bool, check_numerics: bool = False):
    """One epoch. `check_numerics` syncs with the device after every batch
    and aborts on the first non-finite loss, naming the batch; off, the stats
    are read once at the end of the epoch."""
    agg, n = None, 0
    t0 = time.time()
    for batch in loader:
        if train:
            state, stats = step_fn(state, batch)
        else:
            stats = step_fn(state, batch)
        if check_numerics and "loss" in stats:
            loss = float(stats["loss"])
            if not math.isfinite(loss):
                raise FloatingPointError(
                    f"non-finite loss {loss} at batch {n} ({'train' if train else 'eval'})"
                )
        agg = dict(stats) if agg is None else {k: agg[k] + v for k, v in stats.items()}
        n += 1
    agg = {k: float(v) / n for k, v in agg.items()} if n else {}
    agg["time"] = time.time() - t0
    agg["batches"] = n
    return state, agg


# ------------------------------------------------------------- checkpointing


CKPT_NAME_RE = re.compile(r"epoch_(\d{4})\.pth\.tar")
_TMP_MARK = ".tmp-"


def save_checkpoint(ckpt_dir: str, state: TrainState, epoch: int, best_dice: float,
                    best_epoch: int | None = None) -> str:
    """Write epoch_NNNN.pth.tar durably: to a temporary name, fsync'd, then
    renamed over the final name."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"epoch_{epoch:04d}.pth.tar")
    tmp = f"{path}{_TMP_MARK}{os.getpid()}"
    payload = {
        "epoch": epoch,
        "best_dice": float(best_dice),
        "best_epoch": epoch if best_epoch is None else best_epoch,
        "step": state.step,
        "state_dict": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
    }
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def prune_checkpoints(ckpt_dir: str, keep_epochs) -> None:
    """Keep only the checkpoints of `keep_epochs` (best + latest) and remove
    the temporary files of interrupted saves."""
    keep = {int(e) for e in keep_epochs}
    for name in os.listdir(ckpt_dir):
        m = CKPT_NAME_RE.fullmatch(name)
        if (m and int(m.group(1)) not in keep) or _TMP_MARK in name:
            os.remove(os.path.join(ckpt_dir, name))


def list_checkpoints(ckpt_dir: str | None) -> list[str]:
    """Completed checkpoints in `ckpt_dir`, oldest to newest; temporary
    files of interrupted saves are never listed."""
    if not ckpt_dir or not os.path.isdir(ckpt_dir):
        return []
    names = [n for n in os.listdir(ckpt_dir) if CKPT_NAME_RE.fullmatch(n)]
    return [os.path.join(ckpt_dir, n) for n in sorted(names)]


# what a truncated or foreign file raises from torch.load or the key lookups
RESTORE_ERRORS = (RuntimeError, EOFError, pickle.UnpicklingError, KeyError)


def restore_checkpoint(path: str, state: TrainState) -> tuple[TrainState, dict[str, Any]]:
    """Load a checkpoint into `state` (model, optimizer, step, in place) and
    return it with the meta {epoch, best_dice, best_epoch}."""
    device = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    model_sd, opt_sd = ckpt["state_dict"], ckpt["optimizer"]
    meta = {"epoch": int(ckpt["epoch"]), "best_dice": float(ckpt["best_dice"]),
            "best_epoch": int(ckpt["best_epoch"])}
    step = int(ckpt["step"])
    state.model.load_state_dict(model_sd)
    state.optimizer.load_state_dict(opt_sd)
    state.step = step
    return state, meta


def fit(
    fns: TrainStepFns,
    train_loader_factory: Callable[[], Iterable],
    val_loader_factory: Callable[[], Iterable],
    epochs: int,
    ckpt_dir: str | None = None,
    early_stop_patience: int = 100,
    log_every: bool = True,
    check_numerics: bool = False,
    start_epoch: int = 0,
    best_dice: float = -1.0,
    best_epoch: int = 0,
    tensorboard_dir: str | None = None,
    vis_dir: str | None = None,
    vis_frequency: int = 10,
):
    """Epoch loop with best-dice checkpointing and early stopping.

    `tensorboard_dir` logs train/ and val/ loss, dice and iou per epoch
    through tensorboardX's SummaryWriter, or warns once and logs nothing
    when tensorboardX does not import (as JAX's fit). `vis_dir` saves the
    first validation batch's input, mask and prediction (`predict_step`)
    every `vis_frequency` epochs (eval/visualize.py).

    Resume: pass the restored checkpoint's meta as start_epoch / best_dice /
    best_epoch and training continues at epoch start_epoch+1 with the
    early-stop counter and the best-model record intact (a worse epoch after
    the resume never replaces the best). The latest epoch is always saved and
    retention keeps best + latest."""
    writer = None
    if tensorboard_dir:
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            logger.warning("tensorboardX unavailable; skipping TB logging")
        else:
            writer = SummaryWriter(tensorboard_dir)
    state = fns.state
    history = []
    try:
        for epoch in range(start_epoch + 1, epochs + 1):
            state, tr = run_epoch(fns.train_step, state, train_loader_factory(), True,
                                  check_numerics=check_numerics)
            _, va = run_epoch(fns.eval_step, state, val_loader_factory(), False)
            history.append({"epoch": epoch, "train": tr, "val": va})
            if log_every:
                logger.info(
                    "epoch %d train loss %.4f dice %.4f | val loss %.4f dice %.4f",
                    epoch, tr.get("loss", 0), tr.get("dice", 0), va.get("loss", 0),
                    va.get("dice", 0),
                )
            if writer is not None:
                for split, stats in (("train", tr), ("val", va)):
                    for k in ("loss", "dice", "iou"):
                        if k in stats:
                            writer.add_scalar(f"{split}/{k}", stats[k], epoch)
            if vis_dir and epoch % vis_frequency == 0:
                _save_val_predictions(fns, state, val_loader_factory, vis_dir, epoch)
            if va.get("dice", 0) > best_dice:
                best_dice, best_epoch = va["dice"], epoch
            if ckpt_dir:
                save_checkpoint(ckpt_dir, state, epoch, best_dice, best_epoch)
                prune_checkpoints(ckpt_dir, {best_epoch, epoch})
            if va.get("dice", 0) <= best_dice and epoch - best_epoch >= early_stop_patience:
                logger.info("early stopping at epoch %d (best %d)", epoch, best_epoch)
                break
    finally:
        if writer is not None:
            writer.close()
    return state, history


def _save_val_predictions(fns: TrainStepFns, state: TrainState, val_loader_factory,
                          vis_dir: str, epoch: int) -> None:
    """The first validation batch's (input, mask, prediction) images, up to
    4 (the reference saves every vis_frequency epochs)."""
    from accunet_tpu_torch.eval.visualize import save_prediction_images

    batch = next(iter(val_loader_factory()), None)
    if batch is None:
        return
    preds = fns.predict_step(state, batch)
    save_prediction_images(vis_dir, epoch, batch["image"].cpu().numpy(),
                           batch["mask"].cpu().numpy(), preds.float().cpu().numpy(),
                           names=batch.get("names"))
