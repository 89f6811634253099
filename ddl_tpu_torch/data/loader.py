"""Batched, prefetching data loader and the host -> device copy (counterpart
of ``ddl_tpu/data/loader.py``).

Batches are collated host-side into numpy uint8 (B, H, W, C) arrays and
int32 labels, produced ``PREFETCH_DEPTH`` batches ahead on a thread so host
work overlaps device work.  A file-backed dataset (one with
``image_path``) is decoded a whole batch at a time by the native decoder
(``ddl_tpu_torch/native``), falling back to PIL per sample when the
decoder cannot be built or an image fails to decode; ``native.batches``
counts both.  Labels come from ``dataset.labels``, so no image is decoded
twice.  A sample read that fails with ``OSError`` (a
flaky shared-NAS read) is retried with bounded backoff, each retry counted
and reported to ``on_retry``; ``set_start_batch`` skips the first batches
of the next epoch by index, for an exact mid-epoch resume.  ``to_device`` replaces the JAX package's
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

from ddl_tpu_torch import native
from ddl_tpu_torch.data.sampler import ShardedEpochSampler
from ddl_tpu_torch.utils import faultinject
from ddl_tpu_torch.utils.backoff import Backoff, retry_with_backoff

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
        io_retries: int = 2,
        on_retry=None,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_workers = max(0, num_workers)
        self.drop_last = drop_last
        # pad the final partial batch with -1 sentinels up to batch_size, so
        # every batch has one shape and the consumer masks rows labelled -1
        self.pad_last_batch = pad_last_batch
        # transient-I/O resilience: io_retries=0 restores fail-fast
        self.io_retries = max(0, io_retries)
        self.on_retry = on_retry
        self.retry_count = 0
        # one policy object for the loader's lifetime (_fetch runs once per
        # sample, and a Backoff seeds its RNG from OS entropy)
        self._backoff = Backoff(base=0.05, factor=4.0, max_delay=2.0)
        self._start_batch = 0
        self._hw = None  # the file-backed images' (height, width), probed once

    def _note_retry(self, exc: BaseException, attempt: int) -> None:
        self.retry_count += 1
        if self.on_retry is not None:
            self.on_retry(exc, attempt)

    def _retry_io(self, fn):
        return retry_with_backoff(
            fn,
            retries=self.io_retries,
            exceptions=(OSError,),
            backoff=self._backoff,
            on_retry=self._note_retry,
        )

    def _fetch(self, idx):
        def attempt():
            faultinject.io_check("batch")
            return self.dataset[int(idx)]

        return self._retry_io(attempt)

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def set_start_batch(self, n: int) -> None:
        """Skip the first ``n`` batches of the NEXT iteration (one-shot;
        later epochs start at 0).  The sampler's order is a function of
        (seed, epoch), so dropping the first ``n`` index batches leaves
        exactly the batches a preempted epoch had not consumed; nothing is
        loaded and discarded."""
        self._start_batch = max(0, int(n))

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
        images = self._collate_native(idxs)
        if images is None:
            if self.num_workers > 0:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    samples = list(pool.map(self._fetch, idxs))
            else:
                samples = [self._fetch(i) for i in idxs]
            images = np.stack([s[0] for s in samples])
            if hasattr(self.dataset, "image_path"):
                native.count_batch("pil")
        else:
            native.count_batch("native")
        labels = np.asarray(
            [self.dataset.labels[i] for i in idxs]
            if hasattr(self.dataset, "labels")
            else [self.dataset[i][1] for i in idxs],
            dtype=np.int32,
        )
        return images, labels

    def _collate_native(self, idxs: np.ndarray) -> np.ndarray | None:
        """Whole-batch decode through the native decoder (no per-sample
        Python), when the dataset is file-backed and the decoder is built;
        the image size is probed once."""
        if not hasattr(self.dataset, "image_path") or not native.native_available():
            return None
        paths = [self.dataset.image_path(int(i)) for i in idxs]
        if self._hw is None:
            self._hw = native.image_size(paths[0])
            if self._hw is None:
                return None
        h, w = self._hw
        # the decoder reads the same shared files: the same retry policy
        return self._retry_io(lambda: native.load_batch(paths, h, w))

    def _batches(self) -> Iterator[np.ndarray]:
        idxs = np.asarray(list(self.sampler.indices()))
        n_full = len(idxs) // self.batch_size
        skip, self._start_batch = self._start_batch, 0
        for b in range(skip, n_full):
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
