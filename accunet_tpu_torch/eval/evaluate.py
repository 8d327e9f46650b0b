"""Evaluation harness — per-image dice/IoU + extended confusion metrics.

Counterpart of accunet_tpu/eval/evaluate.py:49-153, with the same artifacts:
0.5-threshold per-image dice and IoU, sensitivity / specificity / precision /
recall / F1 / accuracy, the `test.result`-style line appended to a text file,
a metrics CSV and optional per-image .npz dumps. Batches run under
`torch.inference_mode()`; on CUDA the forward is timed between two
synchronisations, so the per-image time is device time plus launch overhead.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import time
from typing import Callable, Iterable

import numpy as np
import torch

from accunet_tpu_torch.train import metrics as M

EXT_KEYS = ["sensitivity", "specificity", "precision", "recall", "f1", "accuracy"]


@dataclasses.dataclass
class EvalResult:
    n_images: int
    dice: float
    iou: float
    extended: dict
    per_image: list
    seconds_per_image: float

    def summary_line(self, model_name: str, task_name: str) -> str:
        return (
            f"model={model_name} task={task_name} n={self.n_images} "
            f"dice={self.dice:.4f} iou={self.iou:.4f} "
            + " ".join(f"{k}={v:.4f}" for k, v in self.extended.items())
        )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evaluate_model(
    forward: Callable[[torch.Tensor], torch.Tensor],
    loader: Iterable,
    device: torch.device,
    threshold: float = 0.5,
    apply_sigmoid: bool = False,
    dump_dir: str | None = None,
    result_file: str | None = None,
    csv_file: str | None = None,
    model_name: str = "model",
    task_name: str = "task",
) -> EvalResult:
    """forward(images (B,H,W,C) on `device`) -> probability/logit maps
    (B,H,W,n_out); a batch that carries the prompts' embeddings under
    "text_emb" calls forward(images, text_emb). `apply_sigmoid` mirrors the
    eval scripts re-sigmoiding raw-logit models."""
    per_image = []
    t_total = 0.0
    n = 0
    with torch.inference_mode():
        for batch in loader:
            imgs = torch.from_numpy(np.asarray(batch["image"], np.float32)).to(device)
            inputs = (imgs,) if batch.get("text_emb") is None else (
                imgs, torch.from_numpy(np.asarray(batch["text_emb"], np.float32)).to(device))
            _sync(device)
            t0 = time.perf_counter()
            preds = forward(*inputs)
            _sync(device)
            t_total += time.perf_counter() - t0
            preds = preds.float().cpu().numpy()
            if apply_sigmoid:
                preds = 1.0 / (1.0 + np.exp(-preds))
            masks = np.asarray(batch["mask"], np.float32)
            count = batch.get("count", preds.shape[0])
            for i in range(count):
                g = masks[i, ..., 0] if masks.ndim == 4 else masks[i]
                name = batch["names"][i] if "names" in batch else str(n)
                if preds.shape[-1] == 1:
                    pb = (preds[i, ..., 0] > threshold).astype(np.uint8)
                    gb = (g > 0).astype(np.uint8)
                    entry = {
                        "name": name,
                        "dice": M.np_dice(pb, gb),
                        "iou": M.np_iou(pb, gb),
                        **M.np_confusion_metrics(pb, gb),
                    }
                else:
                    # multi-class: argmax labels, macro-average the binary
                    # metrics over the foreground classes present
                    p = preds[i].argmax(-1)
                    gi = g.astype(np.int64)
                    per_cls = []
                    for c in range(1, preds.shape[-1]):
                        pc = (p == c).astype(np.uint8)
                        gc = (gi == c).astype(np.uint8)
                        if pc.sum() == 0 and gc.sum() == 0:
                            continue
                        per_cls.append({"dice": M.np_dice(pc, gc), "iou": M.np_iou(pc, gc),
                                        **M.np_confusion_metrics(pc, gc)})
                    entry = {
                        "name": name,
                        **{k: float(np.mean([e[k] for e in per_cls])) if per_cls else 1.0
                           for k in ["dice", "iou", *EXT_KEYS]},
                    }
                per_image.append(entry)
                if dump_dir:
                    os.makedirs(dump_dir, exist_ok=True)
                    np.savez_compressed(
                        os.path.join(dump_dir, f"{os.path.splitext(name)[0]}.npz"),
                        input=np.asarray(batch["image"][i]),
                        output=preds[i],
                        gt=g,
                        dice=entry["dice"],
                        iou=entry["iou"],
                    )
                n += 1

    def mean(key):
        return float(np.mean([e[key] for e in per_image])) if per_image else 0.0

    result = EvalResult(n, mean("dice"), mean("iou"), {k: mean(k) for k in EXT_KEYS},
                        per_image, t_total / max(n, 1))
    if result_file:
        with open(result_file, "a") as f:
            f.write(result.summary_line(model_name, task_name) + "\n")
    if csv_file:
        with open(csv_file, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=["name", "dice", "iou", *EXT_KEYS])
            writer.writeheader()
            for e in per_image:
                writer.writerow({k: e[k] for k in ["name", "dice", "iou", *EXT_KEYS]})
    return result
