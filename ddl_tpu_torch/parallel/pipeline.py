"""Pipeline parallelism for the DenseNet: GPipe and 1F1B over
``torch.distributed`` (counterpart of ``ddl_tpu/parallel/pipeline.py``).

The JAX package runs one SPMD program over the ``(data, pipe)`` mesh: a
``lax.scan`` over clock ticks in which the device at pipe coordinate ``s``
runs its stage, and one ``ppermute`` per boundary hands the activations
on.  Here each rank is a process holding one stage
(``models.densenet.DenseNet(cfg, stage=s)``) and the same clock runs as a
Python loop.  At tick ``t`` stage ``s`` runs

* ``gpipe``: the forward of microbatch ``t - s`` for the first
  ``M + P - 1`` ticks, then the backward of microbatch ``u - (P-1-s)`` at
  tick ``M + P - 1 + u``: all forwards, then all backwards;
* ``1f1b``: the forward of microbatch ``t - s`` and the backward of
  microbatch ``t - (2P-2-s)`` in the same tick, so stage ``s`` holds at
  most ``min(2(P-1-s)+1, M)`` microbatches' stage inputs (the JAX ring
  buffer's depth; a dict here, so ``parallel/buffers.py`` has no port).

Both schedules run every backward in microbatch order 0..M-1, so each
parameter's gradient sums the same terms in the same order and the two
give the same bits.  After each tick the stages exchange what the tick
made (``Handoff``): the boundary activations forward, the cotangents
back, each received at tick ``t`` and consumed at tick ``t + 1``.

The math is the JAX package's, step for step:

* stage 0 normalizes the uint8 microbatch with the plain
  ``normalize_images`` (the JAX pipeline ignores ``pallas_normalize``);
* train-mode BatchNorm normalizes each microbatch by its own statistics
  on its own replica (no ``data_group``), and the running statistics
  advance once per microbatch, in order; after the step they are averaged
  over ``data``;
* each microbatch's loss is its mean cross-entropy on the last stage; the
  step's loss is their sum over M, averaged over ``data``, and the
  gradient is that of the sum over M (each microbatch's backward takes
  its loss over M), averaged over ``data`` after the M backwards, in the
  one all-reduce that also averages the running statistics;
* ``remat`` stores a microbatch's stage input only, and the backward
  re-runs the stage's forward inside ``stage.running_stats_frozen()``, so the
  running statistics move once, as under ``jax.checkpoint``.  A backward
  that runs in the tick of its forward (the last stage under ``1f1b``)
  keeps the forward's graph, as the JAX package's fused ``jax.vjp`` does;
* the optimizer updates this rank's stage; its global-norm clipping sums
  the squared norm over the stages (``Optimizer.norm_reduce``).

Every rank of a data row returns the step's loss and that row's argmax
predictions, broadcast from the last stage (the JAX ``psum`` over
``pipe``); ``evaluate`` runs the GPipe forward in eval mode and returns
the row's logits on every stage.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch
import torch.distributed as dist

from ddl_tpu_torch.ops import cross_entropy_loss, normalize_images
from ddl_tpu_torch.parallel.mesh import mean_over_data

__all__ = ["HANDOFF", "Handoff", "StepFns", "make_pipeline_step_fns", "schedule_ticks"]

# What the handoff moved on this process since the last reset: its
# transport (``Handoff.transport``), the tensors sent and received, and
# the bytes sent.
HANDOFF = {"transport": None, "sends": 0, "recvs": 0, "bytes": 0}


class StepFns(NamedTuple):
    """``train(images, labels) -> (loss, preds)`` and ``evaluate(images) ->
    logits``, the JAX package's ``StepFns``."""

    train: Callable
    evaluate: Callable


def schedule_ticks(schedule: str, n_stages: int, num_microbatches: int, virtual: int = 1):
    """``(T, at)``: the schedule's tick count and ``at(stage, tick) ->
    (forward microbatch, backward microbatch)``, each None where the stage
    runs none at that tick.

    ``virtual`` V > 1 is the interleaved clock of ``parallel/lm_pipeline``
    (the JAX package's ``make_blocks_pipeline_interleaved`` and the
    interleaved 1F1B): stage ``s`` holds chunks ``s, s+P, ...`` and runs
    chunk ``c`` of microbatch ``g*P + r`` (groups of P; ``M % P == 0``) at
    ``rel = t - s = g*V*P + c*P + r``; the backward mirrors it over the
    chunks in reverse, each chunk's microbatches in order 0..M-1.  Its
    units are ``(microbatch, chunk)`` pairs.  GPipe runs every forward
    (``M*V + P - 1`` ticks), then every backward; 1F1B runs the backward
    of a unit ``2(V*P - 1 - sigma)`` ticks after its forward (``sigma = c*P
    + s``), the two in one tick on the last global stage."""
    last, m = n_stages - 1, num_microbatches
    if virtual > 1:
        return _interleaved_ticks(schedule, n_stages, m, virtual)

    def valid(i):
        return i if 0 <= i < m else None

    if schedule == "gpipe":
        tf = m + last

        def at(s, t):
            if t < tf:
                return valid(t - s), None
            return None, valid(t - tf - (last - s))

        return 2 * tf, at
    if schedule == "1f1b":
        return m + 2 * last, lambda s, t: (valid(t - s), valid(t - (2 * last - s)))
    raise ValueError(f"unknown pipeline schedule {schedule!r}")


def _interleaved_ticks(schedule: str, n_stages: int, m: int, v: int):
    """``schedule_ticks`` at ``virtual`` = ``v`` > 1: units ``(microbatch,
    chunk)``."""
    if m % n_stages:
        raise ValueError(f"num_microbatches {m} % pipe {n_stages} != 0 (the interleaved "
                         "schedule advances microbatches in groups of pipe)")
    last, vp = n_stages - 1, v * n_stages

    def unit(rel, backward):
        if not 0 <= rel < m * v:
            return None
        g, u = divmod(rel, vp)
        c, r = divmod(u, n_stages)
        return g * n_stages + r, (v - 1 - c if backward else c)

    if schedule == "gpipe":
        tf = m * v + last

        def at(s, t):
            if t < tf:
                return unit(t - s, False), None
            return None, unit(t - tf - (last - s), True)

        return 2 * tf, at
    if schedule == "1f1b":
        return m * v + vp + last - 1, lambda s, t: (unit(t - s, False),
                                                    unit(t - (vp - 1) - (last - s), True))
    raise ValueError(f"unknown pipeline schedule {schedule!r}")


class Handoff:
    """Point-to-point transfers between the stages of this rank's data row,
    over ``mesh.pipe_group``.  The transport follows the group's backend:
    NCCL moves device tensors directly; gloo takes CPU tensors only, so a
    card's tensors go through a host copy on each side (the one-card world
    of several ranks, where NCCL refuses two ranks on one GPU).  A failed
    transfer raises."""

    def __init__(self, mesh) -> None:
        self.mesh = mesh
        self.group = mesh.pipe_group
        backend = dist.get_backend(self.group)
        self.host = backend == "gloo" and mesh.device.type == "cuda"
        where = "through a host copy" if self.host else (
            "device to device" if mesh.device.type == "cuda" else "on the CPU")
        self.transport = f"{backend}, {where}"
        HANDOFF["transport"] = self.transport
        if backend == "nccl":
            # the first call on a group must involve all of its ranks; a
            # tick's transfers involve only some
            dist.all_reduce(torch.zeros(1, device=mesh.device), group=self.group)

    def exchange(self, sends: Sequence[tuple[int, torch.Tensor]],
                 recvs: Sequence[tuple[int, tuple, torch.dtype]]) -> list[torch.Tensor]:
        """Send each ``(stage, tensor)`` and receive each ``(stage, shape,
        dtype)`` in one batch; returns the received tensors, on this
        rank's device.  Two messages between the same two stages match in
        the order they are posted on each side."""
        ops, bufs = [], []
        for stage, t in sends:
            t = t.detach().contiguous()
            if self.host:
                t = t.cpu()
            ops.append(dist.P2POp(dist.isend, t, self.mesh.pipe_rank(stage), self.group))
            HANDOFF["bytes"] += t.numel() * t.element_size()
        for stage, shape, dtype in recvs:
            buf = torch.empty(shape, dtype=dtype,
                              device="cpu" if self.host else self.mesh.device)
            ops.append(dist.P2POp(dist.irecv, buf, self.mesh.pipe_rank(stage), self.group))
            bufs.append(buf)
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        HANDOFF["sends"] += len(sends)
        HANDOFF["recvs"] += len(recvs)
        return [b.to(self.mesh.device) for b in bufs] if self.host else bufs

    def broadcast(self, t: torch.Tensor, stage: int) -> torch.Tensor:
        """``t`` of ``stage`` on every stage (the others pass a tensor of
        its shape and dtype)."""
        buf = t.cpu() if self.host else t
        dist.broadcast(buf, self.mesh.pipe_rank(stage), group=self.group)
        return buf.to(self.mesh.device) if self.host else buf

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the stages."""
        buf = t.cpu() if self.host else t.clone()
        dist.all_reduce(buf, group=self.group)
        return buf.to(self.mesh.device) if self.host else buf


def make_pipeline_step_fns(
    stage: torch.nn.Module,
    optimizer,
    mesh,
    compute_dtype: torch.dtype,
    num_microbatches: int,
    boundary_shapes: Sequence[tuple[int, int, int]],
    num_classes: int,
    remat: bool = True,
    schedule: str = "gpipe",
) -> StepFns:
    """The pipeline's step functions for this rank's ``stage`` (a
    ``DenseNet(cfg, stage=mesh.pipe_index)`` on ``mesh.device``) and its
    ``optimizer`` (over the stage's parameters: ``zero_grad``/``step``;
    the port's ``Optimizer`` gets its ``norm_reduce``).

    ``train(images, labels) -> (loss, preds)``: this data row's uint8
    images (B, H, W, 3) and labels on the device, on every stage of the
    row (the first stage reads the images, the last the labels); one
    optimizer update.  ``evaluate(images) -> logits`` (B, classes), f32.
    Both leave their results on the device."""
    n_stages = mesh.spec.pipe
    s, last = mesh.pipe_index, mesh.spec.pipe - 1
    if len(boundary_shapes) != n_stages - 1:
        raise ValueError("need one boundary shape per stage cut")
    if stage.spec is None or len(stage.stages) != n_stages:
        raise ValueError(f"the mesh's pipe axis {n_stages} != the model's stages")
    n_ticks, at = schedule_ticks(schedule, n_stages, num_microbatches)
    # the eval is GPipe's forward ticks alone
    _, eval_at = schedule_ticks("gpipe", n_stages, num_microbatches)
    eval_ticks = num_microbatches + n_stages - 1
    M = num_microbatches
    handoff = Handoff(mesh) if n_stages > 1 else None
    if n_stages > 1 and hasattr(optimizer, "norm_reduce"):
        optimizer.norm_reduce = handoff.sum
    params = [p for p in stage.parameters() if p.requires_grad]
    stats = [b for name, b in stage.named_buffers() if name.endswith(("_mean", "_var"))]
    device = mesh.device

    def microbatch_size(images):
        if images.shape[0] % M:
            raise ValueError(f"per-replica batch {images.shape[0]} % microbatches {M} != 0")
        return images.shape[0] // M

    def exchange(t, mb, sends, tick_at):
        """The tick's transfers: this stage's sends, and the receives that
        its neighbours' sends of the same tick imply."""
        recvs, keys = [], []
        if s > 0 and (f := tick_at(s - 1, t)[0]) is not None:
            recvs.append((s - 1, (mb, *boundary_shapes[s - 1]), compute_dtype))
            keys.append(("act", f))
        if s < last and (b := tick_at(s + 1, t)[1]) is not None:
            recvs.append((s + 1, (mb, *boundary_shapes[s]), compute_dtype))
            keys.append(("cot", b))
        return dict(zip(keys, handoff.exchange(sends, recvs))) if sends or recvs else {}

    def train(images: torch.Tensor, labels: torch.Tensor):
        stage.train()
        mb = microbatch_size(images)
        optimizer.zero_grad()
        held, inbox, logits = {}, {}, [None] * M
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        for t in range(n_ticks):
            f, b = at(s, t)
            sends = []
            if f is not None:
                x = (normalize_images(images[f * mb:(f + 1) * mb], compute_dtype) if s == 0
                     else inbox.pop(("act", f)))
                keep = not remat or b == f
                if keep and s > 0:
                    x.requires_grad_()
                with torch.set_grad_enabled(keep):
                    out = stage(x)
                held[f] = (x, out if keep else None)
                if s == last:
                    logits[f] = out.detach()
                else:
                    sends.append((s + 1, out))
            if b is not None:
                x, out = held.pop(b)
                if out is None:
                    x = x.detach().requires_grad_(s > 0)
                    with stage.running_stats_frozen():
                        out = stage(x)
                if s == last:
                    loss = cross_entropy_loss(out, labels[b * mb:(b + 1) * mb])
                    (loss / M).backward()
                    loss_sum += loss.detach()
                else:
                    torch.autograd.backward(out, inbox.pop(("cot", b)))
                if s > 0:
                    sends.append((s - 1, x.grad))
            if handoff is not None:
                inbox.update(exchange(t, mb, sends, at))
        # the data axis's mean of the gradients, the running statistics and
        # (on the last stage) the loss, in one all-reduce
        loss = loss_sum / M
        with torch.no_grad():
            mean_over_data([p.grad for p in params] + stats
                            + ([loss.view(1)] if s == last else []), mesh)
        optimizer.step()
        if s == last:
            out = torch.cat([loss.view(1), torch.cat(logits).argmax(-1).float()])
        else:
            out = torch.empty(1 + images.shape[0], dtype=torch.float32, device=device)
        if handoff is not None:
            out = handoff.broadcast(out, last)
        return out[0], out[1:].long()

    def evaluate(images: torch.Tensor) -> torch.Tensor:
        stage.eval()
        mb = microbatch_size(images)
        inbox, logits = {}, []
        with torch.no_grad():
            for t in range(eval_ticks):
                f, _ = eval_at(s, t)
                sends = []
                if f is not None:
                    x = (normalize_images(images[f * mb:(f + 1) * mb], compute_dtype)
                         if s == 0 else inbox.pop(("act", f)))
                    out = stage(x)
                    if s == last:
                        logits.append(out.float())
                    else:
                        sends.append((s + 1, out))
                if handoff is not None:
                    inbox.update(exchange(t, mb, sends, eval_at))
            out = (torch.cat(logits) if s == last else
                   torch.empty((images.shape[0], num_classes), dtype=torch.float32,
                               device=device))
            return out if handoff is None else handoff.broadcast(out, last)

    return StepFns(train=train, evaluate=evaluate)
