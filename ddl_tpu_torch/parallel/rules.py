"""ZeRO-1 eligibility and the optimizer's per-device bytes (own copy of
what the port needs from ``ddl_tpu/parallel/rules.py``: ``ZERO_THRESHOLD``
(``:94``), ``zero_shard_spec`` (``:405-436``) and ``optimizer_hbm_bytes``
(``:499-533``)).

The JAX module resolves every parameter's ``PartitionSpec`` from regex
rule tables and derives the ZeRO shard from it.  The port's data-parallel
parameters are replicated (the CNN family's table maps everything to
``P()``), so here a leaf is a shape and the shard is a dimension: the
first one the data axis divides.  The regex partition tables, and with
them sharded parameters (tensor, sequence and expert parallelism, FSDP),
are ROADMAP item 11.

Eligibility does not depend on the layout: torch's (O, I, kh, kw) conv
kernel holds the dimensions of JAX's (kh, kw, I, O), permuted, so the same
leaves are eligible; the dimension chosen may differ, which changes
nothing, as Adam is elementwise and snapshots keep the full layout.
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence

__all__ = ["ZERO_THRESHOLD", "optimizer_hbm_bytes", "zero_shard_spec"]

# Parameter leaves at or above this many elements get their optimizer
# state ZeRO-sharded over 'data' (below it the all-gather latency costs
# more than the replicated bytes).
ZERO_THRESHOLD = 8192


def zero_shard_spec(shape: Sequence[int], dp: int,
                    threshold: int = ZERO_THRESHOLD) -> int | None:
    """The dimension of a replicated leaf of ``shape`` that ZeRO-1 splits
    over a data axis of ``dp`` ranks (the first one ``dp`` divides), or
    None when the leaf stays replicated: under ``threshold`` elements, a
    trivial axis, or no dimension divides."""
    size = math.prod(shape) if shape else 1
    if size < threshold or dp <= 1:
        return None
    for i, dim in enumerate(shape):
        if dim % dp == 0:
            return i
    return None


def optimizer_hbm_bytes(shapes: Iterable[Sequence[int]], dp: int,
                        threshold: int = ZERO_THRESHOLD,
                        moment_bytes_per_param: int = 8) -> dict:
    """Per-device Adam-state bytes of parameter leaves of ``shapes``: mu
    and nu per leaf (f32, ``moment_bytes_per_param`` = 2 x 4 bytes),
    replicated over the data axis against ZeRO-sharded (an eligible leaf's
    bytes divided by ``dp``).  Pure accounting, shapes in, bytes out."""
    replicated = zero = 0.0
    leaves = sharded = 0
    for shape in shapes:
        size = math.prod(shape) if shape else 1
        bytes_ = size * moment_bytes_per_param
        leaves += 1
        replicated += bytes_
        if zero_shard_spec(shape, dp, threshold) is not None:
            sharded += 1
            zero += bytes_ / dp
        else:
            zero += bytes_
    return {
        "replicated_bytes": int(replicated),
        "zero_bytes": int(zero),
        "dp": dp,
        "leaves": leaves,
        "zero_sharded_leaves": sharded,
    }
