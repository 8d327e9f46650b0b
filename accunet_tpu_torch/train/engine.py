"""Training engine: train/eval steps, the epoch loop and checkpoints.

Counterpart of accunet_tpu/train/engine.py, without orbax:

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
  * `mesh=` (a parallel.mesh.Mesh; JAX's engine.py:124-147) runs the same
    step as one process on the global batch: rank 0's parameters and
    buffers are broadcast, the BatchNorms take global statistics over the
    data axis, parameters of at least `min_weight_size` elements are stored
    sharded over the model axis (with their optimizer state) and gathered
    whole for each step, the loss and the metrics are computed on the
    predictions gathered over the data axis, and the gradients are summed
    over it. Each rank's batch is its data slice. Only rank 0 writes
    checkpoints, and they are the file a one-process run writes (sharded
    parameters and moments gathered first), so they load into any mesh and
    into the one-process CLIs.
"""

from __future__ import annotations

import contextlib
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
    mesh: Any = None  # parallel.mesh.Mesh of a mesh run
    sharding: Any = None  # parallel.mesh.ShardedParams when the model axis shards weights

    @property
    def is_chief(self) -> bool:
        """The rank that logs and writes checkpoints (rank 0, or the only one)."""
        return self.mesh is None or self.mesh.is_chief

    def weights(self):
        """Context in which every parameter holds its whole value (the
        sharded ones gathered)."""
        return contextlib.nullcontext() if self.sharding is None else self.sharding.gathered()

    def optimizer_params(self) -> list:
        return [p for g in self.optimizer.param_groups for p in g["params"]]


@dataclasses.dataclass
class TrainStepFns:
    train_step: Callable  # (state, batch) -> (state, stats)
    eval_step: Callable  # (state, batch) -> stats
    predict_step: Callable  # (state, batch) -> main output
    state: TrainState


def _chief(state) -> bool:
    """Whether this rank logs and writes: TrainState.is_chief, or True for
    step functions that thread a state of their own (None)."""
    return state is None or state.is_chief


def forward(model: nn.Module, batch):
    """The model on a batch: model(image, text_emb) for a text-conditioned
    batch (the prompts' embeddings under "text_emb"), else model(image)."""
    if batch.get("text_emb") is not None:
        return model(batch["image"], batch["text_emb"])
    return model(batch["image"])


def main_output(preds):
    """The output the metrics read: the model's output, the first of a
    deep-supervision tuple, or the second of a pair whose first is a tuple."""
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
    mesh=None,
    min_weight_size: int = 2 ** 18,
) -> TrainStepFns:
    """Steps and initial state for `model`, whose parameters are already
    initialised and on their device. Batches are {'image', 'mask'} tensors
    on the model's device, with 'text_emb' for a text-conditioned model (see
    `forward`); loss_fn(preds, masks). With `mesh`, every rank calls the
    steps alike with its data slice of each global batch, and the stats are
    those of the global batch."""
    schedule = cosine_warm_restarts(
        learning_rate, t_0=10, t_mult=1, eta_min=1e-5, steps_per_epoch=steps_per_epoch
    )
    params, sharding, data_group = list(model.parameters()), None, None
    if mesh is not None:
        from accunet_tpu_torch.parallel import mesh as pmesh

        pmesh.broadcast_from_rank0(model)
        data_group = mesh.group("data")
        pmesh.set_batch_group(model, data_group)
        dims = pmesh.param_sharding_rules(mesh, min_weight_size)(model)
        if dims:
            sharding = pmesh.ShardedParams(model, mesh, dims)
            params = sharding.optimizer_params(model)
    if optimizer_name == "adam":
        optimizer = torch.optim.Adam(params, lr=learning_rate)
    elif optimizer_name == "sgd":
        # Swin family: SGD momentum 0.9, weight decay 1e-4 added to the grad
        optimizer = torch.optim.SGD(params, lr=learning_rate, momentum=0.9, weight_decay=1e-4)
    else:
        raise ValueError(optimizer_name)
    state = TrainState(model, optimizer, mesh=mesh, sharding=sharding)

    def global_batch(preds, mask):
        """The predictions (with gradient) and masks of the global batch."""
        if data_group is None:
            return preds, mask
        return pmesh.gather_batch(mesh, preds), pmesh.gather_batch(mesh, mask)

    def train_step(state: TrainState, batch):
        lr = schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.model.train()
        with state.weights():
            preds, mask = global_batch(forward(state.model, batch), batch["mask"])
            loss = loss_fn(preds, mask)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if state.sharding is not None:
                state.sharding.take_grads()
        if data_group is not None:
            pmesh.reduce_gradients(params, data_group)
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            main = main_output(preds).detach()
            stats = {
                "loss": loss.detach(),
                "dice": dice_show(main, mask),
                "iou": iou_fn(main, mask),
                "lr": lr,
            }
        return state, stats

    def eval_step(state: TrainState, batch):
        state.model.eval()
        with torch.no_grad(), state.weights():
            preds, mask = global_batch(forward(state.model, batch), batch["mask"])
            main = main_output(preds)
            return {
                "loss": loss_fn(preds, mask),
                "dice": dice_show(main, mask),
                "iou": iou_fn(main, mask),
            }

    def predict_step(state: TrainState, batch):
        """The main output for this rank's batch."""
        state.model.eval()
        with torch.no_grad(), state.weights():
            return main_output(forward(state.model, batch))

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


def whole_state(state: TrainState) -> tuple[dict, dict]:
    """The model's and the optimizer's state_dicts as one process holds
    them: under a model axis the sharded parameters and their optimizer
    state are gathered whole (a collective: every rank calls it)."""
    if state.sharding is None:
        return state.model.state_dict(), state.optimizer.state_dict()
    with state.weights():
        model_sd = state.model.state_dict()
    return model_sd, state.sharding.full_optimizer_state(state.optimizer.state_dict(),
                                                         state.optimizer_params())


def save_checkpoint(ckpt_dir: str, state: TrainState, epoch: int, best_dice: float,
                    best_epoch: int | None = None) -> str | None:
    """Write epoch_NNNN.pth.tar durably: to a temporary name, fsync'd, then
    renamed over the final name. Under a mesh every rank calls it and rank 0
    alone writes (the others return None)."""
    model_sd, opt_sd = whole_state(state)
    if not state.is_chief:
        return None
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"epoch_{epoch:04d}.pth.tar")
    tmp = f"{path}{_TMP_MARK}{os.getpid()}"
    payload = {
        "epoch": epoch,
        "best_dice": float(best_dice),
        "best_epoch": epoch if best_epoch is None else best_epoch,
        "step": state.step,
        "state_dict": model_sd,
        "optimizer": opt_sd,
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
    return it with the meta {epoch, best_dice, best_epoch}. Under a mesh
    every rank loads the same (whole) file and keeps its shards."""
    device = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    model_sd, opt_sd = ckpt["state_dict"], ckpt["optimizer"]
    meta = {"epoch": int(ckpt["epoch"]), "best_dice": float(ckpt["best_dice"]),
            "best_epoch": int(ckpt["best_epoch"])}
    step = int(ckpt["step"])
    if state.sharding is None:
        state.model.load_state_dict(model_sd)
    else:
        with state.weights():
            state.model.load_state_dict(model_sd)
            state.sharding.reshard()
        opt_sd = state.sharding.local_optimizer_state(opt_sd, state.optimizer_params())
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
    if tensorboard_dir and _chief(fns.state):
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
                if _chief(state):
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
    preds = fns.predict_step(state, batch)  # on every rank: it may gather weights
    if not _chief(state):
        return
    save_prediction_images(vis_dir, epoch, batch["image"].cpu().numpy(),
                           batch["mask"].cpu().numpy(), preds.float().cpu().numpy(),
                           names=batch.get("names"))
