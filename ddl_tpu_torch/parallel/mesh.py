"""The ``(data, pipe)`` mesh of the DenseNet trainer (counterpart of
``ddl_tpu/parallel/mesh.py:64-87``), the LM's ``(data, seq)`` mesh
(``build_lm_mesh``, counterpart of ``ddl_tpu/parallel/sharding.py:171-189``)
and the differentiable collectives that sequence parallelism runs on.

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

The LM's mesh (``LMMesh``) lays ``data * seq`` ranks on JAX's axis order,
``seq`` varying fastest: rank ``r`` sits at ``(data_index, seq_index) =
divmod(r, seq)``.  Its ``group`` is the data axis (ZeRO-1's
reduce-scatter), ``seq_group`` the ranks of this rank's data row (the
ring's rotations, Ulysses' exchanges, the dense path's K/V gather), and
``world_group`` every rank (the step's one gradient all-reduce).  The
collectives on ``seq_group`` are ``torch.autograd.Function``s whose
backward is the transposed collective, as JAX transposes them:
``ppermute`` (the reverse shift), ``all_to_all`` (the inverse exchange)
and ``all_gather`` (a reduce-scatter).  Over NCCL they move device to
device; gloo takes CPU tensors, so a card's tensors go through a host copy
on each side (the one-card world of several ranks), as
``parallel/pipeline.Handoff`` does.  A failed transfer raises.

The LM's mesh grew to every training axis: ``LMMesh`` lays ``data * pipe
* seq * model`` ranks out as rank ``((d*pipe + p)*seq + s)*model + m``,
``model`` innermost (a tensor-parallel pair on neighbouring cards), so
the ``(data, pipe)`` and ``(data, seq)`` layouts above are this formula
with the other axes at 1.  Beside ``group`` (data), ``pipe_group`` and
``seq_group`` it holds ``model_group`` (the ranks of this rank's (data,
pipe, seq) coordinate) and ``replica_group`` (the ranks of its (pipe,
model) coordinate: every rank holding the same parameters, over which a
gradient is averaged).  Megatron's two operators run on ``model_group``
as autograd Functions (``copy_to_model``: identity forward, all-reduce
backward; ``reduce_from_model``: all-reduce forward, identity backward),
with ``model_all_reduce`` for the vocab-parallel loss's sums and maxima;
``MODEL_COMM`` counts their calls and bytes.
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
    "LMMesh",
    "MODEL_AXIS",
    "MODEL_COMM",
    "PIPE_AXIS",
    "SEQ_AXIS",
    "SEQ_COMM",
    "Mesh",
    "MeshSpec",
    "all_gather",
    "all_to_all",
    "broadcast_from_first",
    "build_lm_mesh",
    "build_mesh",
    "copy_to_model",
    "mean_over_data",
    "mean_over_mesh",
    "model_all_reduce",
    "ppermute",
    "reduce_from_model",
    "sum_over_data",
]

DATA_AXIS = "data"
PIPE_AXIS = "pipe"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"

# What ``sum_over_data`` did on this process since the last reset: the
# all-reduces it issued (forward and backward) and, while ``timed`` is
# set, their wall seconds, each measured from a synchronised device so it
# holds the collective and not the work queued before it (timing
# therefore serialises the step; leave it off for speed figures).
COLLECTIVES = {"all_reduces": 0, "seconds": 0.0, "timed": False}

# What the sequence-axis collectives did on this process since the last
# reset (forward and backward calls alike): calls of each, the bytes this
# rank sent, and the transport of the last one.
SEQ_COMM = {"transport": None, "ppermute": 0, "all_to_all": 0, "all_gather": 0, "bytes": 0}

# What the model-axis collectives did on this process since the last
# reset: the calls of each operator (forward and backward alike: a
# ``copy_to_model`` reduces in its backward only), the all-reduces
# issued, the bytes this rank sent and the transport of the last one.
MODEL_COMM = {"transport": None, "copy_to_model": 0, "reduce_from_model": 0,
              "all_reduce": 0, "all_reduces": 0, "bytes": 0}


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
    ``pipe_index`` (this rank's coordinates; ``seq_index`` and
    ``model_index`` 0), ``device``, and ``group``, ``pipe_group`` and
    ``host_group`` (None where the axis or the world has one rank)."""

    def __init__(self, spec: MeshSpec, device: torch.device, rank: int = 0,
                 group=None, host_group=None, pipe_group=None) -> None:
        self.spec = spec
        self.device = device
        self.rank = rank
        self.size = spec.num_devices
        self.data_index, self.pipe_index = divmod(rank, spec.pipe)
        self.seq_index = self.model_index = 0
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

    @property
    def row_leader(self) -> bool:
        """Whether this rank speaks for its data row in ``gather`` (the
        row's ranks hold the same array)."""
        return self.pipe_index == 0

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
        if self.row_leader:
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


class LMMesh(Mesh):
    """One rank's view of the LM's ``(data, pipe, seq, model)`` mesh:
    ``spec`` (an ``LMMeshSpec``; ``expert`` 1), ``rank``, ``size``,
    ``data_index``, ``pipe_index``, ``seq_index`` and ``model_index``,
    ``device``; ``group`` (the data axis: the ranks of this rank's (pipe,
    seq, model) coordinate), ``pipe_group``, ``seq_group`` and
    ``model_group`` (likewise), ``replica_group`` (the ranks of this
    rank's (pipe, model) coordinate: data x seq), ``world_group`` and
    ``host_group`` (None where the axis or the world has one rank).  A
    data row's ranks hold different stages, sequence blocks or model
    shards of the same rows, so ``gather`` takes each row's array from its
    rank at (pipe, seq, model) = 0."""

    def __init__(self, spec, device: torch.device, rank: int = 0, group=None,
                 seq_group=None, world_group=None, host_group=None, pipe_group=None,
                 model_group=None, replica_group=None) -> None:
        super().__init__(MeshSpec(spec.data, spec.pipe), device, rank=rank, group=group,
                         host_group=host_group, pipe_group=pipe_group)
        self.spec = spec
        self.size = spec.data * spec.pipe * spec.seq * spec.model
        rest, self.model_index = divmod(rank, spec.model)
        rest, self.seq_index = divmod(rest, spec.seq)
        self.data_index, self.pipe_index = divmod(rest, spec.pipe)
        self.seq_group = seq_group
        self.model_group = model_group
        self.world_group = world_group
        self.replica_group = replica_group

    def pipe_rank(self, stage: int) -> int:
        """The world rank of ``stage`` at this rank's (data, seq, model)."""
        sp = self.spec
        return (((self.data_index * sp.pipe + stage) * sp.seq + self.seq_index) * sp.model
                + self.model_index)

    @property
    def row_leader(self) -> bool:
        return self.pipe_index == self.seq_index == self.model_index == 0

    def __repr__(self) -> str:
        group = self.world_group
        return (f"LMMesh({self.spec}, rank={self.rank} at (data, pipe, seq, model) = "
                f"({self.data_index}, {self.pipe_index}, {self.seq_index}, "
                f"{self.model_index}), device={self.device}, "
                f"backend={dist.get_backend(group) if group else None})")


def _axis_groups(spec, axis: str) -> dict:
    """``dist.new_group`` for each line of the mesh along ``axis`` (the
    ranks that differ in that coordinate alone), keyed by the world ranks
    it holds; every rank creates every group, in one order."""
    sizes = {"data": spec.data, "pipe": spec.pipe, "seq": spec.seq, "model": spec.model}
    names = list(sizes)
    others = [a for a in names if a != axis]
    lines = []
    for fixed in np.ndindex(*(sizes[a] for a in others)):
        coord = dict(zip(others, fixed))
        ranks = []
        for i in range(sizes[axis]):
            c = dict(coord, **{axis: i})
            ranks.append(((c["data"] * spec.pipe + c["pipe"]) * spec.seq + c["seq"])
                         * spec.model + c["model"])
        lines.append(ranks)
    return {tuple(r): dist.new_group(r) for r in lines}


def build_lm_mesh(spec, device=None) -> LMMesh:
    """This rank's view of the LM's ``spec`` mesh (``data`` x ``pipe`` x
    ``seq`` x ``model``).

    The world (``launch.bootstrap``) must hold exactly ``spec.data *
    spec.pipe * spec.seq * spec.model`` ranks (ValueError otherwise);
    ``device`` as ``build_mesh``'s.  Every rank creates every group of
    every axis above 1, in one order, as ``dist.new_group`` requires; over
    NCCL each group's first call is an all-reduce of all its ranks (a
    ring's point-to-point exchanges then run on a communicator every rank
    has joined)."""
    from ddl_tpu_torch.launch import resolve_rank_device

    if spec.expert > 1:
        raise ValueError(f"build_lm_mesh: mesh {spec} has an expert axis; the port's LM mesh "
                         "is (data, pipe, seq, model)")
    need = spec.data * spec.pipe * spec.seq * spec.model
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(
            f"mesh {spec} needs {need} ranks, one device each; the world has {world} "
            "(launch the ranks with the command line's spawner or set "
            "DDL_COORDINATOR/DDL_NUM_PROCESSES/DDL_PROCESS_ID)")
    device = resolve_rank_device(device)
    if world == 1:
        return LMMesh(spec, device)
    rank, host_group = dist.get_rank(), dist.new_group(backend="gloo")
    mine = {}
    for axis in ("data", "pipe", "seq", "model"):
        if getattr(spec, axis) > 1:
            mine[axis] = next(g for ranks, g in _axis_groups(spec, axis).items()
                              if rank in ranks)
    # the replicas of this rank's parameters: data x seq at its (pipe, model)
    replica = None
    if spec.data * spec.seq < world:
        if spec.data * spec.seq > 1:
            lines = {}
            for r in range(world):
                rest, m = divmod(r, spec.model)
                rest, _s = divmod(rest, spec.seq)
                lines.setdefault((rest % spec.pipe, m), []).append(r)
            groups = {tuple(v): dist.new_group(v) for v in lines.values()}
            replica = next(g for ranks, g in groups.items() if rank in ranks)
    else:
        replica = dist.group.WORLD
    mesh = LMMesh(spec, device, rank=rank, group=mine.get("data"), seq_group=mine.get("seq"),
                  world_group=dist.group.WORLD, host_group=host_group,
                  pipe_group=mine.get("pipe"), model_group=mine.get("model"),
                  replica_group=replica)
    if dist.get_backend() == "nccl":
        for g in (mesh.group, mesh.pipe_group, mesh.seq_group, mesh.model_group,
                  mesh.replica_group):
            if g is not None:
                dist.all_reduce(torch.zeros(1, device=device), group=g)
    return mesh


def _on_host(x: torch.Tensor, group) -> bool:
    """Whether ``x`` crosses ``group`` through a host copy: gloo takes CPU
    tensors only."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _note(kind: str, x: torch.Tensor, host: bool, group) -> None:
    SEQ_COMM[kind] += 1
    SEQ_COMM["bytes"] += x.numel() * x.element_size()
    where = "through a host copy" if host else (
        "device to device" if x.is_cuda else "on the CPU")
    SEQ_COMM["transport"] = f"{dist.get_backend(group)}, {where}"


def _shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Rank ``i`` of ``group`` sends ``x`` to rank ``i + shift`` and
    returns what rank ``i - shift`` sent (indices mod the group's size)."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    host = _on_host(x, group)
    send = x.detach().contiguous()
    send = send.cpu() if host else send
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, (i + shift) % n), group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, (i - shift) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    _note("ppermute", send, host, group)
    return recv.to(x.device) if host else recv


class _PPermute(torch.autograd.Function):
    """``lax.ppermute`` over a ring: the cotangent travels back, the
    reverse shift."""

    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -ctx.shift), None, None


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Differentiable ring shift over ``group``: rank ``i`` receives rank
    ``i - shift``'s ``x`` (``lax.ppermute`` with the permutation ``j -> j +
    shift``); a group of None (one rank) returns ``x``."""
    if group is None:
        return x
    return _PPermute.apply(x, group, shift)


def _exchange(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    """The tiled all-to-all: ``x`` split into ``n`` chunks along
    ``split_axis``, chunk ``j`` sent to rank ``j``, the chunks received
    concatenated along ``concat_axis`` in rank order."""
    n = dist.get_world_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: axis {split_axis} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    host = _on_host(x, group)
    lead = x.detach().movedim(split_axis, 0)
    send = lead.reshape(n, lead.shape[0] // n, *lead.shape[1:]).contiguous()
    send = send.cpu() if host else send
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    _note("all_to_all", send, host, group)
    recv = recv.to(x.device) if host else recv
    return torch.cat([recv[j].movedim(0, split_axis) for j in range(n)], dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    """``lax.all_to_all(tiled=True)``: the cotangent takes the inverse
    exchange (split along ``concat_axis``, concatenate along
    ``split_axis``)."""

    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _exchange(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad):
        group, split_axis, concat_axis = ctx.args
        return _exchange(grad, group, concat_axis, split_axis), None, None, None


def all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    """Differentiable tiled all-to-all over ``group`` (Ulysses' head and
    sequence exchange); a group of None returns ``x``."""
    if group is None:
        return x
    return _AllToAll.apply(x, group, split_axis, concat_axis)


class _AllGather(torch.autograd.Function):
    """Every rank's ``x`` concatenated along ``axis`` in rank order; the
    backward reduce-scatters the cotangent (each rank's slice, summed over
    the ranks)."""

    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.args = (group, axis)
        n = dist.get_world_size(group)
        host = _on_host(x, group)
        send = x.detach().movedim(axis, 0).contiguous()
        send = send.cpu() if host else send
        out = torch.empty((n * send.shape[0], *send.shape[1:]), dtype=send.dtype,
                          device=send.device)
        dist.all_gather_into_tensor(out, send, group=group)
        _note("all_gather", send, host, group)
        return (out.to(x.device) if host else out).movedim(0, axis)

    @staticmethod
    def backward(ctx, grad):
        group, axis = ctx.args
        n = dist.get_world_size(group)
        host = _on_host(grad, group)
        full = grad.movedim(axis, 0).contiguous()
        full = full.cpu() if host else full
        out = torch.empty((full.shape[0] // n, *full.shape[1:]), dtype=full.dtype,
                          device=full.device)
        dist.reduce_scatter_tensor(out, full, group=group)
        return (out.to(grad.device) if host else out).movedim(0, axis), None, None


def all_gather(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """Differentiable all-gather along ``axis`` over ``group`` (the dense
    attention's K/V under a sharded sequence); a group of None returns
    ``x``."""
    if group is None:
        return x
    return _AllGather.apply(x, group, axis)


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


def _mean_over(tensors: list[torch.Tensor], group, n: int) -> None:
    if group is None or not tensors:
        return
    flat = _flatten_dense_tensors(tensors)
    dist.all_reduce(flat, group=group)
    flat.div_(n)
    for t, avg in zip(tensors, _unflatten_dense_tensors(flat, tensors)):
        t.copy_(avg)


def mean_over_data(tensors: list[torch.Tensor], mesh) -> None:
    """Replace each tensor by its mean over the data axis, in one
    all-reduce of their concatenation.  The concatenation's layout is the
    list's, the same in every step and every incarnation of a run, so each
    element's sum over the ranks is taken in one order: a resumed run of
    any number of ranks is bit-equal to the uninterrupted one (a bucketed
    all-reduce whose buckets change after a run's first step is not)."""
    _mean_over(tensors, mesh.group, mesh.spec.data)


def mean_over_mesh(tensors: list[torch.Tensor], mesh: LMMesh, axis: str | None = None) -> None:
    """``mean_over_data``'s one all-reduce over the replicas of this rank's
    parameters (the ``data * seq`` ranks of its (pipe, model) coordinate:
    every rank of a ``(data, seq)`` mesh), or over its ``seq`` axis alone
    (``axis="seq"``)."""
    if axis == SEQ_AXIS:
        _mean_over(tensors, mesh.seq_group, mesh.spec.seq)
    else:
        _mean_over(tensors, mesh.replica_group, mesh.spec.data * mesh.spec.seq)


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


def _model_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``t`` all-reduced over ``group`` (its dtype kept)."""
    host = _on_host(t, group)
    buf = t.detach().cpu() if host else t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(buf, op=op, group=group)
    MODEL_COMM["all_reduces"] += 1
    MODEL_COMM["bytes"] += buf.numel() * buf.element_size()
    where = "through a host copy" if host else (
        "device to device" if t.is_cuda else "on the CPU")
    MODEL_COMM["transport"] = f"{dist.get_backend(group)}, {where}"
    return buf.to(t.device) if host else buf


class _CopyToModel(torch.autograd.Function):
    """Megatron's ``f``: the identity forward; the backward sums the
    cotangent over the model ranks (each rank's column-parallel product
    reads the whole input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        MODEL_COMM["copy_to_model"] += 1
        return _model_reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's ``g``: the sum of the model ranks' partial results; the
    backward is the identity (every rank reads the same sum)."""

    @staticmethod
    def forward(ctx, x, group):
        MODEL_COMM["reduce_from_model"] += 1
        return _model_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Enter a column-parallel product: ``x`` as it is, its cotangent
    all-reduced over ``group`` (the model axis); a group of None (one
    rank) returns ``x``."""
    if group is None:
        return x
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Leave a row-parallel product: the sum of every model rank's ``x``
    (differentiable; the cotangent passes as it is); a group of None
    returns ``x``."""
    if group is None:
        return x
    return _ReduceFromModel.apply(x, group)


def model_all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` reduced (``"sum"``, ``"max"`` or ``"min"``) over ``group``, not
    differentiated (the vocab-parallel loss's maxima, sums and argmax);
    a group of None returns ``t``."""
    if group is None:
        return t
    MODEL_COMM["all_reduce"] += 1
    return _model_reduce(t, group, {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
                                    "min": dist.ReduceOp.MIN}[op])
