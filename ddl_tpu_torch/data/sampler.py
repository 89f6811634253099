"""Epoch-seeded sharded index sampler (own copy of ``ddl_tpu/data/sampler.py``).

A global permutation seeded by ``(seed, epoch)`` is split across shards with
rank-interleaved assignment, as ``torch.utils.data.DistributedSampler`` does.
With ``drop_last`` the tail that does not divide by ``num_shards`` is
dropped; without it every shard is padded to equal length, by wrapping
around (``pad_mode="wrap"``) or, for evaluation, with ``-1`` sentinels
(``pad_mode="sentinel"``) that the loader turns into zero images with label
``-1`` for the metrics to mask out, so every real sample counts exactly once.

With ``block=b`` the shards take consecutive runs of ``b`` in turn instead:
with ``b`` the per-shard batch, each global batch of ``b * num_shards``
consecutive indices is cut into one contiguous slice a shard, as the JAX
package's one-process loader and its sharding over the ``data`` axis cut
it (the pipelines, whose BatchNorm statistics are each replica's, need
the same rows on the same replica).  ``drop_last`` then drops the tail
that fills no global batch, and padding fills the last one.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ShardedEpochSampler"]


class ShardedEpochSampler:
    def __init__(
        self,
        num_examples: int,
        num_shards: int = 1,
        shard_rank: int = 0,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        pad_mode: str = "wrap",
        block: int = 0,
    ) -> None:
        if not (0 <= shard_rank < num_shards):
            raise ValueError(f"shard_rank {shard_rank} out of range for {num_shards}")
        if pad_mode not in ("wrap", "sentinel"):
            raise ValueError(f"pad_mode must be 'wrap' or 'sentinel', got {pad_mode!r}")
        self.pad_mode = pad_mode
        self.num_examples = num_examples
        self.num_shards = num_shards
        self.shard_rank = shard_rank
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.block = block
        unit = block * num_shards if block else num_shards
        if drop_last:
            self.shard_size = num_examples // unit * (block or 1)
        else:
            self.shard_size = -(-num_examples // unit) * (block or 1)  # ceil

    def set_epoch(self, epoch: int) -> None:
        """Reseed the permutation per epoch."""
        self.epoch = epoch

    def __len__(self) -> int:
        return self.shard_size

    def indices(self) -> np.ndarray:
        if self.shuffle:
            order = np.random.default_rng((self.seed, self.epoch)).permutation(
                self.num_examples
            )
        else:
            order = np.arange(self.num_examples)
        total = self.shard_size * self.num_shards
        if self.drop_last:
            order = order[:total]
        else:
            pad = total - len(order)
            if pad > 0:
                fill = order[:pad] if self.pad_mode == "wrap" else np.full(
                    pad, -1, order.dtype
                )
                order = np.concatenate([order, fill])
        if self.block:
            return order.reshape(-1, self.num_shards, self.block)[:, self.shard_rank].ravel()
        return order[self.shard_rank :: self.num_shards]

    def __iter__(self):
        return iter(self.indices())
