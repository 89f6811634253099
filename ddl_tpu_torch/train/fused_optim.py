"""ZeRO-1 weight-update sharding over the data axis (counterpart of
``ddl_tpu/train/fused_optim.py``: ``ZeroConfig`` and ``with_zero``).

With plain data parallelism every rank holds Adam's two f32 moments of
every parameter: twice the parameter bytes, on every rank.  Under ZeRO-1
each parameter leaf at or above the threshold (``parallel/rules.
zero_shard_spec`` picks the dimension) keeps its moments and computes its
update on a 1/dp shard.  A train step then makes, in this order:

* **one reduce-scatter** of a flat buffer whose layout is fixed for the
  run (``ZeroPlacement``): for each rank in turn, its shard of every
  eligible leaf, in parameter order.  Rank r receives the sum of its
  segment, divided by dp as ``parallel.mesh.mean_over_data`` divides;
* the small leaves averaged by ``mean_over_data``, as in the replicated
  step;
* Adam on the shard (and, replicated, on the small leaves);
* **one all-gather** of the new parameter shards back into the live
  tensors.

The JAX package plants the same collectives through sharding constraints
on one SPMD program; here they are explicit, and the layout is a function
of the parameter shapes and dp alone, so it is the same in every step and
every incarnation (a resumed run sums each element in the same order at
any number of ranks, as ``mean_over_data`` does for the replicated step).

The update is Adam's math exactly, as ``train/state.Optimizer`` computes
it: the shard is one flat tensor stepped by the same ``torch.optim.Adam``
(b1, b2, eps, the bias correction ``1 - b**count``, the learning rate
times ``update_scale``), and Adam is elementwise, so given equal gradients
the sharded update is bit-equal to the replicated one.  Only placement
changes: ``Optimizer.state_dict`` gathers the moments back into the
replicated layout and ``load_state_dict`` takes this rank's shard, so
snapshots interoperate both ways and across data axes of any size.

The collectives follow the data group's backend: NCCL moves device
tensors; gloo on a card's tensors goes through a host copy on each side
(the one-card world of several ranks), as ``parallel/pipeline.Handoff``
does.  ``ZERO`` says which transport ran and counts the collectives.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch
import torch.distributed as dist

from ddl_tpu_torch.parallel.rules import ZERO_THRESHOLD, zero_shard_spec

__all__ = ["ZERO", "ZeroConfig", "ZeroPlacement", "with_zero"]

# The transport of the last placement built, and the collectives and bytes
# (this rank's input to each) the ZeRO steps issued since the last reset.
ZERO = {"transport": None, "reduce_scatters": 0, "all_gathers": 0, "bytes": 0}

# the flat-tensor collectives (torch 2.13 renamed them; same signatures)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)
_ALL_GATHER = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)


@dataclasses.dataclass(frozen=True)
class ZeroConfig:
    """ZeRO-1 placement: the data axis of ``mesh`` (a ``parallel.mesh.Mesh``),
    the element ``threshold`` below which a leaf stays replicated (None:
    ``ZERO_THRESHOLD``) and, under tensor parallelism, ``specs``: each
    parameter's one-device shape and spec, so the threshold reads the
    whole leaf and the split takes a dimension the spec leaves whole (as
    JAX's ``zero_shard_spec``)."""

    mesh: Any
    threshold: int | None = None
    # per parameter, its one-device shape and its rule-table spec (a
    # tensor-parallel rank's parameters are parts of larger leaves); None:
    # every parameter whole and replicated
    specs: Any = None

    def resolved_threshold(self) -> int:
        return ZERO_THRESHOLD if self.threshold is None else self.threshold


def _data_size(mesh) -> int:
    """The data axis's size of a ``parallel.mesh.Mesh`` or of a spec with a
    ``data`` field (``LMMeshSpec``)."""
    return getattr(getattr(mesh, "spec", mesh), "data", 1)


def with_zero(optimizer, mesh, threshold: int | None = None, specs=None):
    """``optimizer`` (a ``train/state.Optimizer``) with ZeRO-1 weight-update
    sharding attached over ``mesh``'s data axis.

    A no-op on a trivial data axis: the replicated path IS the sharded
    path at dp = 1.  Only plain Adam supports it (``Optimizer.fused``:
    weight decay and gradient clipping keep the JAX package's optax chain
    there), so asking for ZeRO with anything else is a loud error rather
    than a silent replication."""
    if _data_size(mesh) <= 1:
        return optimizer
    if not getattr(optimizer, "fused", False):
        raise ValueError(
            "zero_sharding requires the fused Adam optimizer "
            "(train/fused_optim.fused_adam — the default for plain Adam "
            "configs; weight_decay/grad_clip_norm configs keep the optax "
            f"chain and cannot be ZeRO-sharded); got {type(optimizer).__name__}"
        )
    return optimizer.rebuild(zero=ZeroConfig(mesh=mesh, threshold=threshold, specs=specs))


class ZeroPlacement:
    """The fixed layout of one run's ZeRO-1 shards over ``params``.

    ``leaves`` lists ``(index, dim)`` for each eligible parameter (its
    index in ``params``, the dimension split over the ranks), ``small``
    the indices of the rest.  Rank r's segment of a flat buffer of ``dp *
    shard_numel`` elements holds its chunk of each eligible leaf in
    ``leaves`` order; a chunk is ``chunk(dp, dim)[r]``, flattened."""

    def __init__(self, params: Sequence[torch.Tensor], zero: ZeroConfig) -> None:
        mesh = zero.mesh
        self.mesh = mesh
        self.dp = mesh.spec.data
        self.rank = mesh.data_index
        self.group = mesh.group
        threshold = zero.resolved_threshold()
        self.leaves: list[tuple[int, int]] = []
        self.small: list[int] = []
        for i, p in enumerate(params):
            shape, spec = (tuple(p.shape), None) if zero.specs is None else zero.specs[i]
            dim = zero_shard_spec(shape, self.dp, threshold, spec)
            if dim is None:
                self.small.append(i)
            else:
                self.leaves.append((i, dim))
        shapes = [self._chunk_shape(params[i], d) for i, d in self.leaves]
        self.chunk_shapes = shapes
        sizes = [math.prod(s) for s in shapes]
        self.offsets = [sum(sizes[:k]) for k in range(len(sizes))]
        self.sizes = sizes
        self.shard_numel = sum(sizes)
        backend = dist.get_backend(self.group)
        device = mesh.device
        self.host = backend == "gloo" and device.type == "cuda"
        where = "through a host copy" if self.host else (
            "device to device" if device.type == "cuda" else "on the CPU")
        self.transport = f"{backend}, {where}"
        ZERO["transport"] = self.transport

    def _chunk_shape(self, p: torch.Tensor, dim: int) -> tuple[int, ...]:
        shape = list(p.shape)
        shape[dim] //= self.dp
        return tuple(shape)

    def _chunks(self, t: torch.Tensor, k: int) -> torch.Tensor:
        """A view of eligible leaf ``k``'s tensor ``t`` as (dp, *chunk):
        row r is rank r's chunk."""
        dim = self.leaves[k][1]
        return t.unflatten(dim, (self.dp, t.shape[dim] // self.dp)).movedim(dim, 0)

    def _segments(self, flat: torch.Tensor, k: int) -> torch.Tensor:
        """A view of a flat (dp * shard_numel) buffer's slots of eligible
        leaf ``k`` as (dp, *chunk)."""
        off, n = self.offsets[k], self.sizes[k]
        rows = flat.view(self.dp, self.shard_numel)
        return rows[:, off:off + n].view(self.dp, *self.chunk_shapes[k])

    def pack(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """The flat buffer of the eligible leaves' ``tensors`` (one full
        tensor each, in ``leaves`` order)."""
        t0 = tensors[0]
        flat = torch.empty(self.dp * self.shard_numel, dtype=t0.dtype, device=t0.device)
        for k, t in enumerate(tensors):
            self._segments(flat, k).copy_(self._chunks(t, k))
        return flat

    def unpack(self, flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
        """Copy a flat buffer back into the eligible leaves' ``tensors``."""
        for k, t in enumerate(tensors):
            self._chunks(t, k).copy_(self._segments(flat, k))

    def take(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """This rank's shard (``shard_numel``,) of full ``tensors``."""
        return torch.cat([self._chunks(t, k)[self.rank].reshape(-1)
                          for k, t in enumerate(tensors)])

    def take_into(self, out: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
        """``take``, written into ``out`` in place."""
        for k, t in enumerate(tensors):
            off, n = self.offsets[k], self.sizes[k]
            out[off:off + n].view(self.chunk_shapes[k]).copy_(self._chunks(t, k)[self.rank])

    def reduce_scatter_mean(self, flat: torch.Tensor) -> torch.Tensor:
        """This rank's segment of ``flat`` summed over the data axis,
        divided by dp: the one reduce-scatter of a step."""
        ZERO["reduce_scatters"] += 1
        ZERO["bytes"] += flat.numel() * flat.element_size()
        device = flat.device
        if self.host:
            flat = flat.cpu()
        out = torch.empty(self.shard_numel, dtype=flat.dtype, device=flat.device)
        _REDUCE_SCATTER(out, flat, group=self.group)
        out.div_(self.dp)
        return out.to(device) if self.host else out

    def all_gather(self, shard: torch.Tensor) -> torch.Tensor:
        """Every rank's ``shard``, in rank order: a flat (dp *
        shard_numel) buffer."""
        ZERO["all_gathers"] += 1
        ZERO["bytes"] += shard.numel() * shard.element_size()
        device = shard.device
        if self.host:
            shard = shard.cpu()
        out = torch.empty(self.dp * self.shard_numel, dtype=shard.dtype, device=shard.device)
        _ALL_GATHER(out, shard.contiguous(), group=self.group)
        return out.to(device) if self.host else out

    def gather_full(self, shard: torch.Tensor, like: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Every rank's ``shard`` gathered into new full tensors shaped
        like ``like`` (the eligible leaves)."""
        out = [torch.empty_like(t, dtype=shard.dtype) for t in like]
        self.unpack(self.all_gather(shard), out)
        return out
