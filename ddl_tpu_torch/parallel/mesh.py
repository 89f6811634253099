"""The ``(data, pipe)`` mesh of the DenseNet trainer (counterpart of
``ddl_tpu/parallel/mesh.py:64-87``).

In the JAX package one SPMD program spans every device of the mesh.  Here
each rank is a process driving one device, joined by ``torch.distributed``
(``launch.bootstrap``), and ``build_mesh`` gives this rank's view of the
mesh.  Rank ``r`` sits at ``(data_index, pipe_index) = divmod(r, pipe)``,
as JAX's ``devices.reshape(data, pipe)`` places its devices, and holds
three process groups:

* ``group``: the device collectives over ``data`` (the ranks that share
  this rank's pipe coordinate), on the world's backend (NCCL on the card,
  gloo on the CPU): the BatchNorm statistics' sums (``sum_over_data``)
  and the gradient (and a pipeline's running-statistics) averages
  (``mean_over_data``);
* ``pipe_group``: the ranks of this rank's data row, one a stage: a
  pipeline's boundary activations and cotangents
  (``parallel/pipeline.Handoff``); None when ``pipe`` is 1;
* ``host_group``: gloo on CPU tensors over the whole world, whatever its
  backend: the host-side agreements (``agree``, ``any``) and the
  epoch-end metric gather (``gather``).  These run on numbers already on
  the host, so they cost no device synchronisation, and they take one
  code path on every backend.

The DP train step hands ``group`` to the model (``DenseNet.data_group``),
whose train-mode BatchNorm then takes its moments over the global batch
(the JAX package's SyncBN semantics; ``models/densenet._batch_stats``).
A pipeline leaves it unset: each microbatch normalizes by its own
statistics, as in the JAX package's pipeline.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

__all__ = [
    "COLLECTIVES",
    "DATA_AXIS",
    "PIPE_AXIS",
    "Mesh",
    "MeshSpec",
    "broadcast_from_first",
    "build_mesh",
    "mean_over_data",
    "sum_over_data",
]

DATA_AXIS = "data"
PIPE_AXIS = "pipe"

# What ``sum_over_data`` did on this process since the last reset: the
# all-reduces it issued (forward and backward) and, while ``timed`` is
# set, their wall seconds, each measured from a synchronised device so it
# holds the collective and not the work queued before it (timing
# therefore serialises the step; leave it off for speed figures).
COLLECTIVES = {"all_reduces": 0, "seconds": 0.0, "timed": False}


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    data: int = 1
    pipe: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.pipe

    @property
    def axis_names(self) -> tuple[str, str]:
        return (DATA_AXIS, PIPE_AXIS)


class Mesh:
    """One rank's view of the mesh: ``spec``, ``rank`` (in the world),
    ``size`` (the world's ranks, ``data * pipe``), ``data_index`` and
    ``pipe_index`` (this rank's coordinates), ``device``, and ``group``,
    ``pipe_group`` and ``host_group`` (None where the axis or the world
    has one rank)."""

    def __init__(self, spec: MeshSpec, device: torch.device, rank: int = 0,
                 group=None, host_group=None, pipe_group=None) -> None:
        self.spec = spec
        self.device = device
        self.rank = rank
        self.size = spec.num_devices
        self.data_index, self.pipe_index = divmod(rank, spec.pipe)
        self.group = group
        self.pipe_group = pipe_group
        self.host_group = host_group

    def pipe_rank(self, stage: int) -> int:
        """The world rank of ``stage`` in this rank's data row."""
        return self.data_index * self.spec.pipe + stage

    def __repr__(self) -> str:
        group = self.group or self.pipe_group
        return (f"Mesh({self.spec}, rank={self.rank} at (data, pipe) = ({self.data_index}, "
                f"{self.pipe_index}), device={self.device}, "
                f"backend={dist.get_backend(group) if group else None})")

    def agree(self, fn):
        """``fn()`` computed on rank 0 and broadcast, so every rank acts on
        one decision (the JAX package's ``coord.agreed_resume_epoch`` and
        ``agreed_rollback_epoch`` inside one process group); ``fn`` must
        return something picklable."""
        if self.size == 1:
            return fn()
        box = [fn() if self.rank == 0 else None]
        dist.broadcast_object_list(box, src=0, group=self.host_group)
        return box[0]

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank (a MAX all-reduce of one
        integer on the host group)."""
        if self.size == 1:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return bool(t.item())

    def gather(self, array: np.ndarray) -> np.ndarray:
        """Every data row's ``array`` (the same shape and dtype on each),
        concatenated along the first axis in data order: an all-reduce
        over the world of a zeroed ``(data, *shape)`` buffer into which
        the first stage of each data row writes its row (the stages of a
        row hold the same array).  One data row returns ``array`` itself."""
        data = self.spec.data
        if data == 1:
            return array
        array = np.ascontiguousarray(array)
        buf = torch.zeros((data, *array.shape), dtype=torch.from_numpy(array).dtype)
        if self.pipe_index == 0:
            buf[self.data_index] = torch.from_numpy(array)
        dist.all_reduce(buf, group=self.host_group)
        return buf.numpy().reshape(data * array.shape[0], *array.shape[1:])

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.host_group)


def build_mesh(spec: MeshSpec, device=None) -> Mesh:
    """This rank's view of the ``spec`` mesh.

    The world (``launch.bootstrap``) must hold exactly ``spec.data *
    spec.pipe`` ranks; a mesh that needs more devices than exist raises
    ``ValueError``, as in the JAX package.  ``device`` is the rank's
    device; by default ``cuda:<local rank>`` in a world of several ranks
    (ValueError when the host has fewer GPUs) and ``cuda`` in a world of
    one.  Every rank creates every data and pipe group, in one order, as
    ``dist.new_group`` requires; the groups take the world's backend."""
    from ddl_tpu_torch.launch import resolve_rank_device

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != spec.num_devices:
        raise ValueError(
            f"mesh {spec} needs {spec.num_devices} ranks, one device each; the world "
            f"has {world} (launch the ranks with the command line's spawner or set "
            "DDL_COORDINATOR/DDL_NUM_PROCESSES/DDL_PROCESS_ID)")
    device = resolve_rank_device(device)
    if world == 1:
        return Mesh(spec, device)
    rank, host_group = dist.get_rank(), dist.new_group(backend="gloo")
    if spec.pipe == 1:
        return Mesh(spec, device, rank=rank, group=dist.group.WORLD, host_group=host_group)
    data_groups = [dist.new_group([d * spec.pipe + p for d in range(spec.data)])
                   for p in range(spec.pipe)]
    pipe_groups = [dist.new_group([d * spec.pipe + p for p in range(spec.pipe)])
                   for d in range(spec.data)]
    d, p = divmod(rank, spec.pipe)
    return Mesh(spec, device, rank=rank, group=data_groups[p] if spec.data > 1 else None,
                host_group=host_group, pipe_group=pipe_groups[d])


def _all_reduce(t: torch.Tensor, group) -> None:
    COLLECTIVES["all_reduces"] += 1
    if not COLLECTIVES["timed"]:
        dist.all_reduce(t, group=group)
        return
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    dist.all_reduce(t, group=group)
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    COLLECTIVES["seconds"] += time.perf_counter() - t0


class _SumOverData(torch.autograd.Function):
    """y = the sum of x over the ranks of ``group``.  Every rank's loss
    reads the same y, so x's cotangent on each rank is the sum of every
    rank's cotangent of y: the backward is the same all-reduce."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        _all_reduce(y, group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        _all_reduce(grad, ctx.group)
        return grad, None


def sum_over_data(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of ``group``."""
    return _SumOverData.apply(x, group)


def mean_over_data(tensors: list[torch.Tensor], mesh) -> None:
    """Replace each tensor by its mean over the data axis, in one
    all-reduce of their concatenation.  The concatenation's layout is the
    list's, the same in every step and every incarnation of a run, so each
    element's sum over the ranks is taken in one order: a resumed run of
    any number of ranks is bit-equal to the uninterrupted one (a bucketed
    all-reduce whose buckets change after a run's first step is not)."""
    if mesh.group is None or not tensors:
        return
    flat = _flatten_dense_tensors(tensors)
    dist.all_reduce(flat, group=mesh.group)
    flat.div_(mesh.spec.data)
    for t, avg in zip(tensors, _unflatten_dense_tensors(flat, tensors)):
        t.copy_(avg)


def broadcast_from_first(tensors: list[torch.Tensor], mesh) -> None:
    """Overwrite each tensor with the data axis's first rank's, one
    broadcast per dtype."""
    if mesh.group is None:
        return
    src = dist.get_global_rank(mesh.group, 0)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        same = [t for t in tensors if t.dtype == dtype]
        flat = _flatten_dense_tensors(same)
        dist.broadcast(flat, src=src, group=mesh.group)
        for t, got in zip(same, _unflatten_dense_tensors(flat, same)):
            t.copy_(got)
