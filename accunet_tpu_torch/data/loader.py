"""Host batching: a copy of `BatchLoader` from accunet_tpu/data/loader.py.

A deterministic epoch iterator that shuffles with an explicit per-epoch seed,
applies the joint transform with a per-(epoch, sample) Generator, and emits
NHWC numpy batches; with pad_last it pads the final batch by wrapping and
reports the true count. With process_count > 1 every process takes its
contiguous slice of each global batch.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class BatchLoader:
    """`batch_size` is always the GLOBAL batch."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        transform=None,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        pad_last: bool = False,
        mask_dtype=np.float32,
        process_index: int = 0,
        process_count: int = 1,
    ):
        if process_count > 1:
            if batch_size % process_count:
                raise ValueError(
                    f"global batch {batch_size} not divisible by "
                    f"process_count {process_count}"
                )
            if not (0 <= process_index < process_count):
                raise ValueError(f"process_index {process_index} out of range")
            if not (drop_last or pad_last):
                raise ValueError(
                    "multi-process sharding needs drop_last or pad_last "
                    "(a ragged final global batch would split unevenly)"
                )
        self.ds = dataset
        self.batch_size = batch_size
        self.transform = transform
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.epoch = 0
        self.mask_dtype = mask_dtype
        self.process_index = process_index
        self.process_count = process_count

    def __len__(self):
        n = len(self.ds)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[dict]:
        n = len(self.ds)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        bs = self.batch_size
        stop = n - n % bs if self.drop_last else n
        for start in range(0, stop, bs):
            idxs = order[start : start + bs]
            true_count = len(idxs)
            if self.pad_last and true_count < bs:
                idxs = np.concatenate([idxs, order[: bs - true_count]])
            if self.process_count > 1:
                per = bs // self.process_count
                lo = self.process_index * per
                idxs = idxs[lo : lo + per]
                true_count = min(max(true_count - lo, 0), per)
            images, labels, names = [], [], []
            for i in idxs:
                sample, fname = self.ds[int(i)]
                if self.transform is not None:
                    rng = np.random.default_rng((self.seed, self.epoch, int(i)))
                    sample = self.transform(sample, rng)
                images.append(sample["image"])
                labels.append(sample["label"])
                names.append(fname)
            mask = np.stack(labels).astype(self.mask_dtype)
            if mask.ndim == 3:
                mask = mask[..., None]  # NHWC channel dim for binary masks
            yield {
                "image": np.stack(images).astype(np.float32),
                "mask": mask,
                "names": names,
                "count": true_count,
            }
        self.epoch += 1
