"""Token-corpus data pipeline for the transformer LM (own copy of
``ddl_tpu/data/lm_corpus.py``: same classes, same windows, same order).

A flat token array on disk is viewed as non-overlapping ``seq_len + 1``
token windows; an epoch-seeded permutation of window indices
(``data/sampler.ShardedEpochSampler``) is split across data-parallel
shards, and each batch slices ``(inputs, targets)`` as ``window[:-1] /
window[1:]``.  Storage is a memory-mapped ``.npy``: a batch touches only
its own pages.  ``encode_text_file`` builds a byte-level corpus (vocab
256) from any file; corpora tokenized elsewhere just need an integer
``.npy``.  Batches are numpy int32 arrays; the trainer moves them to the
device.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from ddl_tpu_torch.data.sampler import ShardedEpochSampler

__all__ = ["TokenCorpus", "TokenBatches", "encode_text_file"]


def encode_text_file(
    text_path: str | os.PathLike, out_path: str | os.PathLike
) -> Path:
    """Byte-level encode a file into a ``uint8`` token ``.npy``."""
    out = Path(out_path)
    tokens = np.frombuffer(Path(text_path).read_bytes(), np.uint8)
    np.save(out, tokens)
    return out


class TokenCorpus:
    """Non-overlapping ``seq_len + 1``-token windows over a memmapped
    token array.  ``__getitem__`` returns ``(inputs, targets)`` int32
    arrays of length ``seq_len`` (targets shifted by one)."""

    def __init__(self, path: str | os.PathLike, seq_len: int) -> None:
        self.tokens = np.load(path, mmap_mode="r")
        if self.tokens.ndim != 1 or not np.issubdtype(
            self.tokens.dtype, np.integer
        ):
            raise ValueError(
                f"{path}: expected a 1-D integer token array, got "
                f"{self.tokens.shape} {self.tokens.dtype}"
            )
        self.seq_len = seq_len
        self.num_windows = (len(self.tokens) - 1) // seq_len
        if self.num_windows < 1:
            raise ValueError(
                f"{path}: {len(self.tokens)} tokens is too short for even "
                f"one seq_len={seq_len} window"
            )

    def __len__(self) -> int:
        return self.num_windows

    def __getitem__(self, i: int):
        s = self.seq_len
        w = np.asarray(self.tokens[i * s : i * s + s + 1], np.int32)
        return w[:-1], w[1:]

    def max_token(self) -> int:
        """Highest token id (one pass over the memmap) — for vocab checks."""
        return int(self.tokens.max())

    def split(self, eval_fraction: float) -> tuple["_CorpusSlice", "_CorpusSlice"]:
        """(train, eval) views sharing this memmap: the LAST
        ``eval_fraction`` of windows are held out (contiguous tail split —
        no token of an eval window appears in a train window)."""
        if not 0.0 < eval_fraction < 1.0:
            raise ValueError(f"eval_fraction {eval_fraction} not in (0, 1)")
        n_eval = max(1, int(self.num_windows * eval_fraction))
        n_train = self.num_windows - n_eval
        if n_train < 1:
            raise ValueError(
                f"eval_fraction {eval_fraction} leaves no training windows "
                f"(corpus has {self.num_windows})"
            )
        return _CorpusSlice(self, 0, n_train), _CorpusSlice(self, n_train, n_eval)


class _CorpusSlice:
    """Contiguous window range of a ``TokenCorpus`` (shares the memmap)."""

    def __init__(self, corpus: TokenCorpus, start: int, count: int) -> None:
        self.corpus = corpus
        self.seq_len = corpus.seq_len
        self.start = start
        self.count = count

    def __len__(self) -> int:
        return self.count

    def __getitem__(self, i: int):
        if not 0 <= i < self.count:
            raise IndexError(i)
        return self.corpus[self.start + i]


class TokenBatches:
    """Host-sharded epoch iterator of ``(inputs, targets)`` batches, both
    ``(batch, seq_len)`` int32 — the LM analog of the image ``DataLoader``
    (same sampler semantics: ``set_epoch`` reshuffle, drop_last, shard by
    process).  ``batch`` is the *per-host* batch size."""

    def __init__(
        self,
        corpus: TokenCorpus,
        batch: int,
        num_shards: int = 1,
        shard_rank: int = 0,
        shuffle: bool = True,
        seed: int = 0,
    ) -> None:
        self.corpus = corpus
        self.batch = batch
        # (step, shuffle_epoch, epoch_pos) resume anchor, or None.  Set
        # by anchor_resume() when a snapshot cursor carries shuffle
        # state; realigns the step -> (epoch, pos) mapping so a resumed
        # run continues the SAME shuffle trajectory even when the shard
        # layout (and hence len(self)) changed across the restart.
        self._anchor: tuple[int, int, int] | None = None
        self.sampler = ShardedEpochSampler(
            len(corpus), num_shards, shard_rank, shuffle=shuffle,
            drop_last=True, seed=seed,
        )
        if len(self) == 0:
            raise ValueError(
                f"corpus yields {len(self.sampler)} windows/shard at "
                f"seq_len={corpus.seq_len} across {num_shards} shard(s) — "
                f"fewer than one batch of {batch}"
            )

    def set_epoch(self, epoch: int) -> None:
        if epoch != self.sampler.epoch:
            self.sampler.set_epoch(epoch)
            self._idxs = None

    def __len__(self) -> int:
        return len(self.sampler) // self.batch

    def _materialize(self, chunk: np.ndarray):
        s = self.corpus.seq_len
        inp = np.empty((len(chunk), s), np.int32)
        tgt = np.empty((len(chunk), s), np.int32)
        for j, i in enumerate(chunk):
            inp[j], tgt[j] = self.corpus[int(i)]
        return inp, tgt

    def _indices(self) -> np.ndarray:
        if getattr(self, "_idxs", None) is None:
            self._idxs = self.sampler.indices()
        return self._idxs

    def locate(self, step: int) -> tuple[int, int]:
        """The (shuffle_epoch, epoch_pos) global *training step* ``step``
        maps to: a pure ``divmod(step, len(self))``, unless a resume
        anchor is set — then the offset from the anchor step, so the
        shuffle-epoch trajectory survives restarts whose shard layout
        changed ``len(self)`` (e.g. an elastic N-1 respec: the epoch
        permutation reseeds from the PERSISTED epoch, not from a divmod
        against the new epoch length)."""
        if self._anchor is not None:
            a_step, a_epoch, a_pos = self._anchor
            off = a_pos + (step - a_step)
            return a_epoch + off // len(self), off % len(self)
        return divmod(step, len(self))

    def cursor_state(self, step: int) -> dict:
        """Shuffle state to persist in the snapshot data cursor at
        ``step`` — what anchor_resume() needs to continue the epoch
        reshuffle sequence exactly, beyond one corpus pass."""
        epoch, pos = self.locate(step)
        return {"shuffle_epoch": epoch, "epoch_pos": pos}

    def anchor_resume(
        self, step: int, shuffle_epoch: int, epoch_pos: int
    ) -> None:
        """Pin the mapping so ``step`` lands on the persisted
        (shuffle_epoch, epoch_pos) and later steps advance from there.
        Called on snapshot resume/rollback with the restored cursor's
        shuffle state."""
        self._anchor = (int(step), int(shuffle_epoch), int(epoch_pos))
        self.set_epoch(int(shuffle_epoch))

    def batch_at(self, step: int):
        """Deterministic batch for global *training step* ``step`` (see
        ``locate``).  Because the mapping is pure in ``step`` (relative
        to the resume anchor, if any), a resumed run continues the token
        stream exactly where the interrupted run left it."""
        epoch, pos = self.locate(step)
        self.set_epoch(epoch)
        idxs = self._indices()
        return self._materialize(idxs[pos * self.batch : (pos + 1) * self.batch])

    def __iter__(self):
        idxs = self._indices()
        for b in range(len(self)):
            yield self._materialize(idxs[b * self.batch : (b + 1) * self.batch])
