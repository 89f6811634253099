"""Pipeline parallelism over a stack of uniform transformer blocks
(counterpart of the blocks part of ``ddl_tpu/parallel/lm_pipeline.py``:
``make_blocks_pipeline``, ``make_blocks_pipeline_interleaved``,
``make_blocks_pipeline_1f1b`` and ``make_blocks_pipeline_zb``).

The JAX package runs each schedule as one SPMD ``lax.scan`` over clock
ticks, manual over the ``pipe`` axis, with ``ppermute`` hops between the
stages.  Here each rank of a data row is a process holding one stage, the
clock is a Python loop (``parallel/pipeline.schedule_ticks``, with its
interleaved units), and the hops are one batched exchange a tick over
``parallel/pipeline.Handoff``.  The blocks are ``n_layers`` equal layers
cut into ``P * V`` chunks (``layer_chunks``): global stage ``sigma = c*P +
s`` is chunk ``c`` of rank ``s`` (the JAX ``stack_block_params`` layout;
the port keeps one module per layer, ``block{l}``, so the stack is an
index map).  Four schedules compute the same function:

* ``gpipe``: every forward, then every backward (V = 1: ``M + P - 1``
  ticks each way);
* ``gpipe`` with ``virtual`` V > 1 (interleaved): microbatches advance in
  groups of P, each lapping the ranks V times, the activation of chunk
  ``c`` on the last rank handed back to rank 0 for chunk ``c + 1`` (the
  wrap rides the same batched exchange as every other hop of its tick);
* ``1f1b``: the backward of a unit ``2(V*P - 1 - sigma)`` ticks after its
  forward, so a rank holds O(V*P) stage inputs, not O(M*V);
* ``zb`` (V = 1): 1F1B's clock with each backward split in two: the B
  pass (the input cotangent, which the previous stage waits for) in the
  tick, the W pass (the weight gradients, which nothing reads before the
  update) deferred into a queue of capacity ``s`` on rank ``s`` and run
  oldest first when the queue is over capacity or the rank has no B
  pass in the tick: the cooldown ticks 1F1B leaves idle.

Every schedule runs each chunk's backward (and zb's W passes) in
microbatch order 0..M-1, so every parameter's gradient sums the same
terms in the same order and the schedules give the same bits.  The last
global stage computes the loss of each microbatch on its own (``head``),
as the JAX 1F1B and zb loops do; GPipe follows them here.

Memory and recompute: with ``remat`` a rank keeps only the input of each
unit between its forward and backward ticks, and the backward tick runs
the chunk's forward again (its blocks checkpointed by the caller's
``run_chunk``), as the JAX 1F1B vjp does; without, it keeps the graph.  A
backward in the tick of its forward keeps the forward's graph either
way, and a last global stage whose backward comes later runs its forward
only then.  zb's W pass runs the chunk's forward once more from the
queued input, as the JAX W vjp does: three forwards of each unit with
``remat``, two without.

Dropout: ``run_chunk`` gets the microbatch, and draws each (step,
microbatch, layer) mask from ``mb_layer_seed``, never from the order in
which the ticks run, so every schedule draws the same masks (the JAX
``_mb_stage_key``).
"""

from __future__ import annotations

from collections import deque
from typing import Callable

import torch

from ddl_tpu_torch.models.transformer import fold_seed
from ddl_tpu_torch.parallel.pipeline import Handoff, schedule_ticks

__all__ = ["SCHEDULES", "BlocksPipeline", "layer_chunks", "mb_layer_seed"]

# the schedules of ddl_tpu/parallel/rules.py's PIPELINE_SCHEDULES; V > 1
# under gpipe or 1f1b is the interleaved one
SCHEDULES = ("gpipe", "1f1b", "zb")


def mb_layer_seed(step_key: int, microbatch: int, layer: int) -> int:
    """The dropout seed of one (step, microbatch, global layer): the one
    derivation every schedule and chunking shares."""
    return fold_seed(step_key, microbatch, layer)


def layer_chunks(n_layers: int, n_stages: int, virtual: int = 1) -> list[list[list[int]]]:
    """``chunks[s][c]``: the global layer indices of chunk ``c`` of rank
    ``s``, global stage ``sigma = c*P + s`` holding layers ``[sigma*k,
    (sigma+1)*k)`` with ``k = n_layers / (P*V)`` (the JAX
    ``stack_block_params`` placement: at V > 1 a rank's chunks are not
    contiguous)."""
    if n_layers % (n_stages * virtual):
        raise ValueError(f"n_layers {n_layers} % (pipe {n_stages} * virtual {virtual}) != 0")
    k = n_layers // (n_stages * virtual)
    return [[list(range((c * n_stages + s) * k, (c * n_stages + s + 1) * k))
             for c in range(virtual)] for s in range(n_stages)]


class BlocksPipeline:
    """This rank's clock loop over its chunks, for one data row.

    ``run_chunk(c, x, m, key) -> y``: chunk ``c``'s blocks on ``x``, the
    input of microbatch ``m`` (``key`` the step's dropout key, or None for
    no dropout); ``chunk_params(c)``: chunk ``c``'s parameters (zb's W
    pass).  Every boundary tensor is of ``dtype``, and of the shape
    ``train`` and ``forward`` are given."""

    def __init__(self, mesh, run_chunk: Callable, chunk_params: Callable, *, schedule: str,
                 num_microbatches: int, virtual: int, dtype: torch.dtype,
                 remat: bool) -> None:
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown pipeline schedule {schedule!r}")
        if schedule == "zb" and virtual > 1:
            raise ValueError(f"virtual_stages={virtual} requires schedule='gpipe' or '1f1b' "
                             "(the zero-bubble B/W-split clock loop is single-chunk)")
        self.P, self.V, self.M = mesh.spec.pipe, virtual, num_microbatches
        self.s = mesh.pipe_index
        self.S = self.P * self.V
        self.zb = schedule == "zb"
        self.run_chunk, self.chunk_params = run_chunk, chunk_params
        self.dtype, self.remat = dtype, remat
        self.boundary = None
        self.n_ticks, self.at = self._units(schedule)
        tf = self.M * self.V + self.P - 1
        _, eval_at = self._units("gpipe")
        self.eval_ticks, self.eval_at = tf, eval_at
        self.handoff = Handoff(mesh)
        # zb: the W deferral capacity, the rank's tail-idle tick count
        self.cap = min(self.s, self.M)

    def _units(self, schedule: str):
        """The clock with every unit a ``(microbatch, chunk)`` pair (zb
        runs 1F1B's F and B clock)."""
        n, raw = schedule_ticks("1f1b" if schedule == "zb" else schedule, self.P, self.M,
                                self.V)
        if self.V > 1:
            return n, raw
        return n, lambda s, t: tuple(None if u is None else (u, 0) for u in raw(s, t))

    def _exchange(self, t: int, sends: list, at) -> dict:
        """The tick's transfers: this rank's sends, and the receives its
        neighbours' units of the same tick imply (their keys name the
        unit the tensor feeds here).  At P = 2 both neighbours are one rank,
        which may send an activation and a cotangent in one tick: each side
        posts the activation first, so the two match in order."""
        P, s = self.P, self.s
        prev, nxt = (s - 1) % P, (s + 1) % P
        recvs, keys = [], []
        f = at(prev, t)[0]
        if f is not None and f[1] * P + prev < self.S - 1:
            recvs.append((prev, self.boundary, self.dtype))
            keys.append(("act", f[0], (f[1] * P + prev + 1) // P))
        b = at(nxt, t)[1]
        if b is not None and b[1] * P + nxt > 0:
            recvs.append((nxt, self.boundary, self.dtype))
            keys.append(("cot", b[0], (b[1] * P + nxt - 1) // P))
        if not sends and not recvs:
            return {}
        return dict(zip(keys, self.handoff.exchange(sends, recvs)))

    def _weight_pass(self, c: int, x, g, m: int, key) -> None:
        """zb's W: chunk ``c``'s forward again from the queued input, then
        the gradients of its weights alone, added to ``.grad``."""
        with torch.enable_grad():
            y = self.run_chunk(c, x, m, key)
        params = list(self.chunk_params(c))
        for p, gp in zip(params, torch.autograd.grad(y, params, g)):
            if p.grad is None:
                p.grad = gp
            else:
                p.grad += gp

    def train(self, boundary: tuple, first: Callable | None, head: Callable | None, key=None):
        """One step's forwards and backwards, the gradients accumulated
        into ``.grad``; every handoff is ``boundary`` shaped (a
        microbatch's activations).  ``first(m)``: the input of global stage
        0 for microbatch ``m`` (rank 0); ``head(y, m) -> (loss term, metrics)``:
        the last global stage's epilogue, whose loss term is backpropagated
        (the last rank).  Returns ``(dx, metrics)``: rank 0's cotangent of
        each ``first(m)`` (a list), and the last rank's metrics summed over
        the microbatches (else None)."""
        P, s, S = self.P, self.s, self.S
        self.boundary = tuple(boundary)
        held, inbox, dx, queue = {}, {}, {}, deque()
        metrics = None
        for t in range(self.n_ticks):
            f, b = self.at(s, t)
            sends = []
            if f is not None:
                m, c = f
                sig = c * P + s
                x = first(m) if sig == 0 else inbox.pop(("act", m, c))
                keep = not self.remat or b == f
                out = None
                if keep or sig < S - 1:
                    x = x.detach().requires_grad_(keep)
                    with torch.set_grad_enabled(keep):
                        out = self.run_chunk(c, x, m, key)
                    if sig < S - 1:
                        sends.append(((s + 1) % P, out))
                held[f] = (x, out if keep else None)
            if b is not None:
                m, c = b
                sig = c * P + s
                x, out = held.pop(b)
                if out is None:
                    x = x.detach().requires_grad_()
                    with torch.enable_grad():
                        out = self.run_chunk(c, x, m, key)
                if sig == S - 1:
                    y = out.detach().requires_grad_()
                    with torch.enable_grad():
                        loss, met = head(y, m)
                    loss.backward()
                    g = y.grad
                    metrics = met.detach() if metrics is None else metrics + met.detach()
                else:
                    g = inbox.pop(("cot", m, c))
                if self.zb:
                    (gx,) = torch.autograd.grad(out, x, g)
                    queue.append((c, x.detach(), g, m))
                else:
                    torch.autograd.backward(out, g)
                    gx = x.grad
                if sig > 0:
                    sends.append(((s - 1) % P, gx))
                else:
                    dx[m] = gx
            if queue and (len(queue) > self.cap or b is None):
                self._weight_pass(*queue.popleft(), key)
            inbox.update(self._exchange(t, sends, self.at))
        if queue:  # the clock drains the queue by its last tick
            raise RuntimeError(f"zb: {len(queue)} W pass(es) left after the last tick")
        return [dx[m] for m in range(self.M)] if dx else None, metrics

    @torch.no_grad()
    def forward(self, boundary: tuple, first: Callable | None,
                tail: Callable | None) -> list | None:
        """GPipe's forward ticks alone: ``tail(y)`` of each microbatch's
        last-global-stage output, on the last rank (a list in microbatch
        order; None elsewhere)."""
        P, s, S = self.P, self.s, self.S
        self.boundary = tuple(boundary)
        inbox, outs = {}, {}
        for t in range(self.eval_ticks):
            f, _ = self.eval_at(s, t)
            sends = []
            if f is not None:
                m, c = f
                sig = c * P + s
                x = first(m) if sig == 0 else inbox.pop(("act", m, c))
                y = self.run_chunk(c, x, m, None)
                if sig == S - 1:
                    outs[m] = tail(y)
                else:
                    sends.append(((s + 1) % P, y))
            inbox.update(self._exchange(t, sends, self.eval_at))
        return [outs[m] for m in range(self.M)] if outs else None
