"""Ulysses sequence parallelism: the all-to-all head/sequence exchange
(counterpart of ``ddl_tpu/parallel/ulysses.py``).

The second long-context strategy beside the ring (``parallel/
ring_attention.py``): activations arrive sequence-sharded, (B, T/n, H, D)
on each of the ``n`` ``seq`` ranks; one all-to-all (``parallel.mesh.
all_to_all``) regroups them to (B, T, H/n, D) -- the whole sequence over a
head group -- so each rank runs full attention over its heads, and the
inverse all-to-all restores the sequence shards.  The inner attention is
``ops.attention.dense_attention`` or, under ``flash``, the flash kernels
(``ops.flash_attention.flash_attention``: #4-#6 at the full sequence on a
card).  The exchanges' backward is the inverse exchange.

Ulysses needs the head counts to split over ``n``; grouped-query K/V moves
at Hkv heads, ``H / Hkv`` times less than repeat-then-attend.
"""

from __future__ import annotations

import torch.distributed as dist

from ddl_tpu_torch.ops.attention import dense_attention
from ddl_tpu_torch.parallel.mesh import all_to_all

__all__ = ["make_ulysses_self_attention", "ulysses_attention"]


def ulysses_attention(q, k, v, group, causal: bool = False, attn_fn=None, window: int = 0):
    """Attention over a sequence-sharded batch on this rank's blocks: q
    (B, T_local, H, D), k/v (B, T_local, Hkv, D), the local head counts
    dividing by the ``group``'s size (``seq``; None is one rank) -> this
    rank's output block (B, T_local, H, D), full attention over the
    global sequence.  ``attn_fn(q, k, v, causal=..., [window=...])``
    replaces the dense inner attention."""
    n = 1 if group is None else dist.get_world_size(group)
    h, hkv = q.shape[2], k.shape[2]
    if h % n:
        raise ValueError(
            f"local head count {h} must divide by sequence axis size {n} "
            "for Ulysses all-to-all attention (use ring attention otherwise)"
        )
    if hkv != h and (h % hkv or hkv % n):
        raise ValueError(
            f"local K/V head count {hkv} must divide local q heads {h} and "
            f"divide by sequence axis size {n} for grouped-query Ulysses "
            "(the head/sequence all-to-all must keep whole K/V groups "
            "aligned with their query chunks; use ring attention otherwise)"
        )

    def fwd(x):  # (B, T/n, H, D) -> (B, T, H/n, D): split heads, gather sequence
        return all_to_all(x, group, split_axis=2, concat_axis=1)

    attn = attn_fn if attn_fn is not None else dense_attention
    # each head group holds the whole sequence: a window is the inner
    # attention's own
    kwargs = {"window": window} if window else {}
    out = attn(fwd(q), fwd(k), fwd(v), causal=causal, **kwargs)
    return all_to_all(out, group, split_axis=1, concat_axis=2)


def make_ulysses_self_attention(mesh, causal: bool = False, attn_fn=None, window: int = 0):
    """The attention core ``fn(q, k, v)`` of this rank of ``mesh`` (a
    ``parallel.mesh.LMMesh``, or None for one rank): ``ulysses_attention``
    over its ``seq_group``, mirroring ``make_ring_self_attention``."""
    group = None if mesh is None else mesh.seq_group

    def core(q, k, v):
        return ulysses_attention(q, k, v, group, causal=causal, attn_fn=attn_fn, window=window)

    return core
