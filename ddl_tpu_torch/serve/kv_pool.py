"""Paged KV cache: a fixed pool of block-granular KV slots (counterpart of
``ddl_tpu/serve/kv_pool.py``).

* Device side, per layer: ``k``/``v`` pools of shape ``(num_blocks,
  block_size, Hkv*Dh)``, the fused storage of ``infer/decode.init_kv_cache``
  chopped along the sequence axis into block rows; the int8 pool is an
  ``ops.quant.QuantKV`` of int8 pools and ``(num_blocks, Hkv, block_size)``
  f32 scale pools.  Every pool tensor is zeroed at allocation (a masked
  NaN row would still poison attention through 0 * NaN on the value side).
* Host side: ``BlockAllocator`` (refcounted free list, LRU evictable set,
  compaction plans) and ``PrefixIndex`` (hash-chained block keys), copied
  from the JAX package.

Unlike the JAX functions, which return new arrays, the device functions
write the pool tensors IN PLACE and return the same containers, as
``ops.quant.kv_write`` does.  JAX's scatter with ``mode="drop"`` silently
skips an out-of-range block id, and its gather with ``mode="clip"`` clamps
one; PyTorch indexing does neither (an out-of-range index raises on the
CPU and trips a device-side assert on CUDA), so both are explicit here:

* a write to a block id at or past ``num_blocks`` is dropped: the entry
  repeats the write of the first entry that is kept (the same row with
  the same value, so the duplicate is harmless), and when no entry is kept
  every entry rewrites row 0 with its own content.  Nothing waits for the
  card: the decision is a ``torch.where`` on the device, not a host test;
* a gather clamps ids into ``[0, num_blocks - 1]``; the caller's length
  mask never exposes the rows so read.
"""

from __future__ import annotations

import bisect
import hashlib

import numpy as np
import torch

from ddl_tpu_torch.ops.quant import QuantKV, quantize_q8

__all__ = [
    "BlockAllocator",
    "PoolExhausted",
    "PrefixIndex",
    "apply_block_permutation",
    "blocks_for",
    "cache_write_token",
    "init_kv_pool",
    "pool_copy_block",
    "pool_gather",
    "pool_write_prefill",
    "pool_write_token",
    "token_targets",
]


def blocks_for(tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``tokens`` cache rows (ceil division)."""
    if tokens <= 0:
        raise ValueError(f"tokens must be > 0, got {tokens}")
    return -(-tokens // block_size)


class PoolExhausted(RuntimeError):
    """Raised by ``BlockAllocator.alloc`` when the pool cannot satisfy a
    request — the scheduler checks ``can_alloc`` first, so reaching this
    from the engine is a bookkeeping bug, not an overload condition."""


class BlockAllocator:
    """Host-side refcounted free list over the pool's block ids.

    Lowest-id-first allocation keeps live blocks packed toward the front
    of the pool (gathers touch a compact prefix; ``defrag`` restores the
    property when interleaved retire/admit churn breaks it).

    Every live block carries a **refcount**: ``alloc`` hands out private
    blocks at refcount 1, ``share`` lets another request's block table
    point at an existing block (+1), and ``free`` decrements — a block
    returns to circulation only when its last owner retires.  A block
    the ``PrefixIndex`` has registered (``mark_indexed``) does not go
    back to the free list at refcount 0: it parks in the LRU
    **evictable** set with its content intact, ready to be ``share``d
    by the next request with the same prefix, and is reclaimed (oldest
    first, ``on_evict`` notified so the index forgets it) only when
    ``alloc`` runs out of free blocks.

    Invariants:
    a block is never handed out twice, never freed below refcount 0
    (double-free raises), never evicted while referenced, and
    ``free + refcounted + evictable == num_blocks`` always.
    """

    def __init__(self, num_blocks: int, block_size: int) -> None:
        if num_blocks < 1 or block_size < 1:
            raise ValueError(
                f"need num_blocks >= 1 and block_size >= 1, got "
                f"{num_blocks}, {block_size}"
            )
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free = list(range(num_blocks))  # kept ascending
        self._refs: dict[int, int] = {}  # live block -> refcount >= 1
        self._evictable: dict[int, None] = {}  # ref==0 indexed blocks, LRU
        self._indexed: set[int] = set()  # blocks the PrefixIndex holds
        self.on_evict = None  # callable(block_id): index forget hook
        self.high_water = 0  # max blocks ever simultaneously in use
        self.evictions = 0

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Blocks with a live owner (refcount >= 1)."""
        return len(self._refs)

    @property
    def cached_blocks(self) -> int:
        """Indexed refcount-0 blocks holding reusable prefix content."""
        return len(self._evictable)

    def refcount(self, block_id: int) -> int:
        return self._refs.get(block_id, 0)

    def is_indexed(self, block_id: int) -> bool:
        """Whether the PrefixIndex holds this block (its content must
        not be overwritten by a live owner — CoW first)."""
        return block_id in self._indexed

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free) + len(self._evictable)

    def alloc(self, n: int) -> list[int]:
        if n < 1:
            raise ValueError(f"alloc needs n >= 1, got {n}")
        if not self.can_alloc(n):
            raise PoolExhausted(
                f"need {n} blocks, {len(self._free)} free + "
                f"{len(self._evictable)} evictable of {self.num_blocks}"
            )
        while len(self._free) < n:
            self._evict_one()
        ids, self._free = self._free[:n], self._free[n:]
        for i in ids:
            self._refs[i] = 1
        self.high_water = max(self.high_water, len(self._refs))
        return ids

    def _evict_one(self) -> None:
        """Reclaim the least-recently-released evictable block: the
        prefix index forgets it (``on_evict``) and it joins the free
        list — the LRU-on-refcount-0 watermark eviction.  Insort, not a
        re-sort: ``alloc`` evicts in a loop, and a long prompt admitted
        into a pool full of cached blocks (the prefix cache's steady
        state) would otherwise re-sort the free list once per block."""
        bid = next(iter(self._evictable))
        del self._evictable[bid]
        self._indexed.discard(bid)
        self.evictions += 1
        if self.on_evict is not None:
            self.on_evict(bid)
        bisect.insort(self._free, bid)

    def share(self, ids) -> None:
        """Add one owner to each block: a request's block table now
        points at it read-only.  Reactivates evictable (cached) blocks;
        sharing a free block is a bookkeeping bug and raises."""
        ids = list(ids)
        bad = [
            i for i in ids if i not in self._refs and i not in self._evictable
        ]
        if bad:
            raise ValueError(
                f"sharing blocks with no live or cached content: "
                f"{sorted(bad)}"
            )
        for i in ids:
            if i in self._evictable:
                del self._evictable[i]
                self._refs[i] = 1
            else:
                self._refs[i] += 1
        self.high_water = max(self.high_water, len(self._refs))

    def free(self, ids) -> None:
        """Drop one owner per block.  At refcount 0 an indexed block
        parks in the evictable set (content kept for the next prefix
        hit); an unindexed one returns to the free list."""
        ids = list(ids)
        bad = [i for i in ids if i not in self._refs]
        if bad:
            raise ValueError(
                f"freeing blocks not currently allocated: {sorted(bad)}"
            )
        released = []
        for i in ids:
            self._refs[i] -= 1
            if self._refs[i] == 0:
                del self._refs[i]
                if i in self._indexed:
                    self._evictable[i] = None  # LRU: append on release
                else:
                    released.append(i)
        if released:
            self._free = sorted(self._free + released)

    def mark_indexed(self, block_id: int) -> None:
        """The PrefixIndex registered this block: at refcount 0 it will
        be cached (evictable), not freed."""
        if block_id not in self._refs and block_id not in self._evictable:
            raise ValueError(f"indexing a free block: {block_id}")
        self._indexed.add(block_id)

    def drop_indexed(self, block_id: int) -> None:
        """Un-index a block (the public inverse of ``mark_indexed``,
        for an external invalidation path — no in-tree caller today;
        eviction uses ``_evict_one``): an evictable block returns to
        the free list immediately."""
        self._indexed.discard(block_id)
        if block_id in self._evictable:
            del self._evictable[block_id]
            bisect.insort(self._free, block_id)

    def _live(self) -> set[int]:
        return set(self._refs) | set(self._evictable)

    def fragmentation(self) -> float:
        """Fraction of the live span that is holes: 1 - live/(max+1).
        0.0 when live (refcounted or cached) blocks are packed at the
        front — the quantity ``defrag`` drives back to zero."""
        live = self._live()
        if not live:
            return 0.0
        span = max(live) + 1
        return 1.0 - len(live) / span

    def compaction_plan(self) -> dict[int, int] | None:
        """old-id -> new-id mapping that packs live AND cached blocks to
        the lowest ids (preserving relative order), or None when already
        packed.  The caller must apply it to the device pools, every
        request's block table (``apply_block_permutation``) and the
        ``PrefixIndex`` (``remap``), then ``commit_plan``."""
        live = sorted(self._live())
        plan = {old: new for new, old in enumerate(live) if old != new}
        return plan or None

    def commit_plan(self, plan: dict[int, int]) -> None:
        """Adopt a compaction plan: live blocks occupy [0, live)."""
        self._refs = {plan.get(i, i): r for i, r in self._refs.items()}
        self._evictable = {
            plan.get(i, i): None for i in self._evictable
        }  # dict comprehension preserves LRU order
        self._indexed = {plan.get(i, i) for i in self._indexed}
        self._free = sorted(
            set(range(self.num_blocks)) - set(self._refs)
            - set(self._evictable)
        )

    def stats(self) -> dict:
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "free": self.free_blocks,
            "used": self.used_blocks,
            "cached": self.cached_blocks,
            "shared": sum(1 for r in self._refs.values() if r > 1),
            "evictions": self.evictions,
            "high_water": self.high_water,
            "fragmentation": round(self.fragmentation(), 4),
        }


class PrefixIndex:
    """Content-keyed index over pool blocks holding prompt prefixes.

    Key: a chain hash over the token ids at block granularity —
    ``key_i = H(key_{i-1} || tokens[i*bs:(i+1)*bs])`` — so a block's key
    commits to the WHOLE prefix through it, not just its own tokens
    (two prompts sharing block 3's tokens but not block 2's can never
    collide).  ``lookup`` walks the chain and returns the longest run of
    cached blocks; ``insert`` registers a finished prefill's full prompt
    blocks.  Pure host-side maps; block lifetime (refcounts, LRU
    eviction) lives in ``BlockAllocator`` — the allocator calls
    ``forget_block`` when it evicts, the engine calls ``remap`` after a
    defrag.
    """

    def __init__(self, block_size: int) -> None:
        self.block_size = int(block_size)
        self._by_key: dict[str, int] = {}
        self._by_block: dict[int, str] = {}

    def __len__(self) -> int:
        return len(self._by_key)

    def chain_keys(self, tokens) -> list[str]:
        """One key per FULL block of ``tokens`` (len // block_size)."""
        toks = np.asarray(tokens, np.int32).reshape(-1)
        keys = []
        h = b""
        for i in range(len(toks) // self.block_size):
            blk = toks[i * self.block_size:(i + 1) * self.block_size]
            h = hashlib.sha1(h + blk.tobytes()).digest()
            keys.append(h.hex())
        return keys

    def lookup(self, tokens, keys: list[str] | None = None) -> list[int]:
        """Block ids of the longest cached block-aligned prefix of
        ``tokens`` (full blocks only; possibly empty).  ``keys`` lets a
        caller reuse one ``chain_keys`` pass — the hash is a pure
        function of the immutable prompt, only this dict walk needs to
        be fresh (a queue head is re-looked-up every scheduler tick)."""
        ids = []
        for key in keys if keys is not None else self.chain_keys(tokens):
            bid = self._by_key.get(key)
            if bid is None:
                break
            ids.append(bid)
        return ids

    def insert(
        self, tokens, block_ids, allocator: BlockAllocator,
        keys: list[str] | None = None,
    ) -> int:
        """Register ``tokens``'s full-block prefix as cached content in
        ``block_ids`` (the request's block table).  Blocks already
        indexed under the same key are skipped (first writer wins — both
        copies hold identical K/V, only one is worth keeping); returns
        how many blocks were newly registered."""
        new = 0
        if keys is None:
            keys = self.chain_keys(tokens)
        for i, key in enumerate(keys):
            if i >= len(block_ids):
                break
            if key in self._by_key:
                continue
            bid = int(block_ids[i])
            if bid in self._by_block:
                # the block already backs a different chain position
                # (cannot happen for distinct live tables, but a stale
                # insert after eviction could) — keep the existing entry
                continue
            self._by_key[key] = bid
            self._by_block[bid] = key
            allocator.mark_indexed(bid)
            new += 1
        return new

    def forget_block(self, block_id: int) -> None:
        """Allocator eviction hook: drop the block's index entry."""
        key = self._by_block.pop(block_id, None)
        if key is not None:
            self._by_key.pop(key, None)

    def remap(self, plan: dict[int, int]) -> None:
        """Rewrite block ids per a defrag compaction plan."""
        self._by_block = {
            plan.get(b, b): k for b, k in self._by_block.items()
        }
        self._by_key = {k: b for b, k in self._by_block.items()}


def init_kv_pool(cfg, num_blocks: int, block_size: int, dtype=None, quant: bool = False,
                 device=None) -> tuple:
    """Per-layer zeroed block pools: ``init_kv_cache``'s layouts with the
    sequence axis chopped into ``num_blocks`` rows of ``block_size``, each
    tensor its own (they are written in place).

    Plain: ``(k, v)`` of shape (num_blocks, block_size, Hkv*Dh).
    ``quant=True``: ``QuantKV`` tensors, int8 pools and (num_blocks, Hkv,
    block_size) f32 scales, so ``ops.quant.kv_attend`` reads a gathered
    pool as it reads a contiguous int8 cache."""
    if quant and dtype is not None:
        raise ValueError(
            "quant=True fixes the pool layout (int8 + f32 scales); "
            "dtype cannot be combined with it"
        )
    dtype = dtype or cfg.dtype
    shape = (num_blocks, block_size, cfg.kv_heads * cfg.head_dim)
    if quant:
        def zq():
            return torch.zeros(shape, dtype=torch.int8, device=device)

        def zs():
            return torch.zeros((num_blocks, cfg.kv_heads, block_size), device=device)

        return tuple(QuantKV(zq(), zs(), zq(), zs()) for _ in range(cfg.n_layers))
    return tuple((torch.zeros(shape, dtype=dtype, device=device),
                  torch.zeros(shape, dtype=dtype, device=device))
                 for _ in range(cfg.n_layers))


def _pool_rows(pool_layer) -> int:
    return (pool_layer.kq if isinstance(pool_layer, QuantKV) else pool_layer[0]).shape[0]


def _kept(ids, num_blocks: int):
    """``(src, any_kept)``: entry i writes what entry ``src[i]`` writes --
    itself where its id is below ``num_blocks``, else the first kept
    entry -- and ``any_kept`` (a 0-d bool tensor) says whether any is."""
    keep = ids < num_blocks
    first = torch.argmax(keep.to(torch.int8))  # the first kept entry (0 if none)
    src = torch.where(keep, torch.arange(ids.shape[0], device=ids.device), first)
    return src, keep.any()


def token_targets(blk, slot, num_blocks: int) -> tuple:
    """The write plan of ``pool_write_token`` for (B,) ``blk``/``slot``:
    ``(block, slot, src, any_kept)``, where a dropped lane (``blk >=
    num_blocks``) repeats the write of the first kept lane, and with none
    kept every lane rewrites row (0, 0).  One plan serves every layer of
    a decode step."""
    src, any_kept = _kept(blk, num_blocks)
    zero = torch.zeros((), dtype=blk.dtype, device=blk.device)
    return (torch.where(any_kept, blk[src], zero), torch.where(any_kept, slot[src], zero),
            src, any_kept)


def _set_rows(x, index, values, src, any_kept) -> None:
    """``x[index] = values`` with the dropped entries repeating a kept one
    (``_kept``): ``index`` is a tuple of index tensors addressing one row
    of ``x`` per entry, already remapped; with no entry kept, every entry
    rewrites its target (row 0) with the content it holds."""
    x[index] = torch.where(any_kept, values[src].to(x.dtype), x[index])


def pool_write_prefill(pool_layer, cache_layer, block_ids):
    """Scatter one request's contiguous prefill cache into its blocks, in
    place; returns ``pool_layer``.

    ``cache_layer`` is a (1, Pb, fused) single-request cache (bf16 tuple
    or QuantKV) fresh out of ``infer.decode.LMDecode``'s prefill;
    ``block_ids`` (Pb / block_size,) integer ids (a tensor or a host
    sequence) -- entries >= num_blocks are dropped (bucket padding beyond
    the request's reservation).  Rows past the true prompt length carry
    pad-token K/V; ``pool_write_token`` overwrites them before the length
    mask ever exposes them."""
    nb = _pool_rows(pool_layer)
    ref = pool_layer.kq if isinstance(pool_layer, QuantKV) else pool_layer[0]
    ids = torch.as_tensor(block_ids, dtype=torch.long, device=ref.device)
    n, bs = ids.shape[0], ref.shape[1]
    src, any_kept = _kept(ids, nb)
    target = (torch.where(any_kept, ids[src], torch.zeros_like(ids)),)

    def rows(x):  # (1, Pb, fused) -> (n, bs, fused)
        return x[0].reshape(n, bs, x.shape[-1])

    if isinstance(pool_layer, QuantKV):
        hkv = pool_layer.ks.shape[1]

        def scales(s):  # (1, Hkv, Pb) -> (n, Hkv, bs)
            return s[0].reshape(hkv, n, bs).transpose(0, 1)

        for pool, cache, view in ((pool_layer.kq, cache_layer.kq, rows),
                                  (pool_layer.ks, cache_layer.ks, scales),
                                  (pool_layer.vq, cache_layer.vq, rows),
                                  (pool_layer.vs, cache_layer.vs, scales)):
            _set_rows(pool, target, view(cache), src, any_kept)
        return pool_layer
    for pool, cache in zip(pool_layer, cache_layer):
        _set_rows(pool, target, rows(cache), src, any_kept)
    return pool_layer


def _q8(x):
    """``quantize_q8(x)``, or ``x`` itself where it is already a ``(q,
    scale)`` pair."""
    return x if isinstance(x, tuple) else quantize_q8(x)


def pool_write_token(pool_layer, k, v, blk, slot, targets=None):
    """Write one new K/V row per lane into the pool, in place; returns
    ``pool_layer``.

    ``k``/``v``: (B, 1, Hkv, Dh) fresh projections; ``blk``/``slot``: (B,)
    integer tensors, each lane's target block and in-block row.  Lanes with
    ``blk >= num_blocks`` (idle lanes) are dropped.  ``targets`` is
    ``token_targets(blk, slot, num_blocks)`` when the caller planned the
    step's writes once for every layer.  QuantKV pools quantize on the way
    in, exactly like ``ops.quant.kv_write``; ``k``/``v`` may also be given
    as ``quantize_q8``'s ``(q, scale)`` pairs, quantized once for this
    write and ``cache_write_token``'s."""
    if targets is None:
        targets = token_targets(blk, slot, _pool_rows(pool_layer))
    tb, ts, src, any_kept = targets
    b = tb.shape[0]
    if isinstance(pool_layer, QuantKV):
        (kq, ks), (vq, vs) = _q8(k), _q8(v)
        heads = torch.arange(pool_layer.ks.shape[1], device=tb.device)
        scale_index = (tb[:, None], heads[None, :], ts[:, None])
        for pool, val, index in ((pool_layer.kq, kq.reshape(b, -1), (tb, ts)),
                                 (pool_layer.ks, ks[:, 0, :, 0], scale_index),
                                 (pool_layer.vq, vq.reshape(b, -1), (tb, ts)),
                                 (pool_layer.vs, vs[:, 0, :, 0], scale_index)):
            _set_rows(pool, index, val, src, any_kept)
        return pool_layer
    for pool, val in zip(pool_layer, (k.reshape(b, -1), v.reshape(b, -1))):
        _set_rows(pool, (tb, ts), val, src, any_kept)
    return pool_layer


def cache_write_token(cache_layer, k, v, pos):
    """Write one new K/V row per lane into a GATHERED contiguous cache, in
    place; returns ``cache_layer``.

    ``cache_layer``: (B, L, fused) tuple / QuantKV out of ``pool_gather``;
    ``pos``: (B,) integer tensor, each lane's row (its current length,
    below L); ``k``/``v`` as ``pool_write_token`` takes them.  A decode
    dispatch gathers each lane's table ONCE and then
    appends rows here -- a (B, fused) scatter a step instead of
    re-gathering the whole (B, L, fused) view per layer per step.  Row
    ``pos[b]`` of lane b's view is position ``(blk, slot)`` of the pool
    (``pos = table_index * block_size + slot``), so attention over this
    cache equals attention over a fresh gather."""
    b = pos.shape[0]
    lanes = torch.arange(b, device=pos.device)
    if isinstance(cache_layer, QuantKV):
        (kq, ks), (vq, vs) = _q8(k), _q8(v)
        cache_layer.kq[lanes, pos] = kq.reshape(b, -1)
        cache_layer.ks[lanes, :, pos] = ks[:, 0, :, 0].to(cache_layer.ks.dtype)
        cache_layer.vq[lanes, pos] = vq.reshape(b, -1)
        cache_layer.vs[lanes, :, pos] = vs[:, 0, :, 0].to(cache_layer.vs.dtype)
        return cache_layer
    ck, cv = cache_layer
    ck[lanes, pos] = k.reshape(b, -1).to(ck.dtype)
    cv[lanes, pos] = v.reshape(b, -1).to(cv.dtype)
    return cache_layer


def pool_gather(pool_layer, tables):
    """Gather each lane's block table into a contiguous per-lane cache: a
    new (B, L, fused) tuple / QuantKV (scales (B, Hkv, L)), L = max_blocks *
    block_size, the layout ``ops.quant.kv_attend`` expects.

    ``tables``: (B, max_blocks) integer tensor; ids out of range are
    clamped into the pool (idle entries use ``num_blocks``, which reads
    the last block) -- never a fill value, since a masked NaN row would
    still poison the output through 0 * NaN on the value side."""
    b, nmax = tables.shape
    idx = tables.clamp(0, _pool_rows(pool_layer) - 1)

    def rows(x):  # (B, nmax, bs, fused) -> (B, L, fused)
        return x[idx].reshape(b, nmax * x.shape[1], x.shape[-1])

    if isinstance(pool_layer, QuantKV):
        hkv, bs = pool_layer.ks.shape[1:]

        def scales(s):  # (B, nmax, Hkv, bs) -> (B, Hkv, L)
            return s[idx].transpose(1, 2).reshape(b, hkv, nmax * bs)

        return QuantKV(rows(pool_layer.kq), scales(pool_layer.ks),
                       rows(pool_layer.vq), scales(pool_layer.vs))
    return tuple(rows(x) for x in pool_layer)


def pool_copy_block(pools, src: int, dst: int):
    """Copy block row ``src`` -> ``dst`` in every layer's pool, in place
    (the device half of copy-on-write: a request about to write into a
    block other tables share gets its own bit-identical copy first);
    returns ``pools``."""
    for layer in pools:
        for x in layer:
            x[dst] = x[src]
    return pools


def apply_block_permutation(pools, plan: dict[int, int], num_blocks: int):
    """Move pool rows per a compaction plan (the device half of
    ``BlockAllocator.compaction_plan``), in place: new row j holds old row
    ``inverse(j)``; rows the plan does not mention keep their id.  Returns
    ``pools``."""
    inv = list(range(num_blocks))
    for old, new in plan.items():
        inv[new] = old
    for layer in pools:
        for x in layer:
            x.copy_(x[torch.as_tensor(inv, device=x.device)])
    return pools
