"""Host batching: copies of `BatchLoader` and `PrefetchLoader` from
accunet_tpu/data/loader.py.

BatchLoader is a deterministic epoch iterator that shuffles with an explicit
per-epoch seed, applies the joint transform with a per-(epoch, sample)
Generator, and emits NHWC numpy batches; with pad_last it pads the final
batch by wrapping and reports the true count. With process_count > 1 every
process takes its contiguous slice of each global batch. PrefetchLoader
prepares the next batches on a background thread.
"""

from __future__ import annotations

import queue
import threading
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


class PrefetchLoader:
    """Background-thread prefetch around any batch iterable: a daemon thread
    runs the inner iterator and fills a bounded queue, so host-side decode and
    augmentation overlap the device's work. Batches arrive in the inner
    loader's order; an error in the inner loader is raised to the consumer."""

    _END = object()

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch: int):
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        err = []
        # a consumer may stop early (one peeked batch, an aborted epoch); a
        # bare q.put would then block the worker forever, so every put polls
        # this event and the generator's finally sets it
        closed = threading.Event()

        def _put(item) -> bool:
            while not closed.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self.loader:
                    if not _put(batch):
                        return
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                _put(self._END)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._END:
                    break
                yield item
            t.join()
            if err:
                raise err[0]
        finally:
            closed.set()
