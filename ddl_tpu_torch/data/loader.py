"""Batched, prefetching data loader and the host -> device copy (counterpart
of ``ddl_tpu/data/loader.py``).

Batches are collated host-side into numpy uint8 (B, H, W, C) arrays and
int32 labels, produced ``PREFETCH_DEPTH`` batches ahead on a thread so host
work overlaps device work.  ``to_device`` replaces the JAX package's
``shard_batch``: on a CUDA device the batch is staged in pinned host memory
and copied with ``non_blocking=True``, still as uint8 (the /255 runs on the
device).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np
import torch

from ddl_tpu_torch.data.sampler import ShardedEpochSampler

__all__ = ["DataLoader", "to_device"]

PREFETCH_DEPTH = 2


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        sampler: ShardedEpochSampler,
        drop_last: bool = True,
        num_workers: int = 2,
        pad_last_batch: bool = False,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_workers = max(0, num_workers)
        self.drop_last = drop_last
        # pad the final partial batch with -1 sentinels up to batch_size, so
        # every batch has one shape and the consumer masks rows labelled -1
        self.pad_last_batch = pad_last_batch

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _collate(self, idxs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        idxs = np.asarray(idxs)
        n_pad = int((idxs < 0).sum())
        if n_pad:
            # sentinel (-1) indices: zero image, label -1 (masked rows)
            valid = idxs[idxs >= 0]
            if len(valid):
                images, labels = self._collate(valid)
            else:
                img0 = np.asarray(self.dataset[0][0])
                images = np.zeros((0, *img0.shape), img0.dtype)
                labels = np.zeros((0,), np.int32)
            images = np.concatenate(
                [images, np.zeros((n_pad, *images.shape[1:]), images.dtype)]
            )
            labels = np.concatenate([labels, np.full((n_pad,), -1, np.int32)])
            return images, labels
        if self.num_workers > 0:
            with ThreadPoolExecutor(self.num_workers) as pool:
                samples = list(pool.map(lambda i: self.dataset[int(i)], idxs))
        else:
            samples = [self.dataset[int(i)] for i in idxs]
        images = np.stack([s[0] for s in samples])
        labels = np.asarray([s[1] for s in samples], dtype=np.int32)
        return images, labels

    def _batches(self) -> Iterator[np.ndarray]:
        idxs = np.asarray(list(self.sampler.indices()))
        n_full = len(idxs) // self.batch_size
        for b in range(n_full):
            yield idxs[b * self.batch_size : (b + 1) * self.batch_size]
        if not self.drop_last and n_full * self.batch_size < len(idxs):
            tail = idxs[n_full * self.batch_size :]
            if self.pad_last_batch:
                tail = np.concatenate(
                    [tail, np.full(self.batch_size - len(tail), -1, tail.dtype)]
                )
            yield tail

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield collated (uint8 images, int32 labels), prefetching ahead.
        A failure on the producer thread is raised here, not swallowed."""
        q: queue.Queue = queue.Queue(maxsize=PREFETCH_DEPTH)
        done = object()
        error: list[BaseException] = []

        def producer():
            try:
                for batch_idxs in self._batches():
                    q.put(self._collate(batch_idxs))
            except BaseException as e:  # handed to the consumer below
                error.append(e)
            finally:
                q.put(done)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is done:
                break
            yield item
        t.join()
        if error:
            raise error[0]


def to_device(images: np.ndarray, labels: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Host batch -> device tensors, dtypes unchanged (uint8 images).  On a
    CUDA device the copy is asynchronous from pinned memory."""
    device = torch.device(device)
    img = torch.from_numpy(np.ascontiguousarray(images))
    lab = torch.from_numpy(np.ascontiguousarray(labels))
    if device.type == "cuda":
        img, lab = img.pin_memory(), lab.pin_memory()
        return img.to(device, non_blocking=True), lab.to(device, non_blocking=True)
    return img.to(device), lab.to(device)
