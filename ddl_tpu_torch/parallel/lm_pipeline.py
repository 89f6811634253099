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
``_mb_stage_key``).  ``PipelinedSteps`` folds the data row (and, with
``seq`` above 1, the sequence block) into the step's key, so the rows and
blocks draw different ones; the ``model`` ranks of a stage share them.

The LM on that engine (the rest of the JAX module, ``:909-1584``):

* the layout: ``split_lm_params`` cuts a ``TransformerLM`` ``state_dict``
  into the stages' (``TransformerLM(cfg, stage=s, stages=P, virtual=V)``:
  ``embed`` on stage 0, chunk ``c`` of rank ``s`` the layers of global
  stage ``c*P + s``, ``norm_f`` and ``lm_head`` on the last), which keep
  the global ``block{l}`` names, so ``merge_lm_params`` is their union in
  the whole model's order; ``saved_pipe_stages`` and
  ``saved_virtual_stages`` read a layout's geometry back from its keys,
  and ``convert_lm_state`` carries a snapshot state (the model and Adam's
  per-parameter moments, indexed in the model's key order) between the
  one-device layout and the stages'.  The JAX ``abstract_lm_state`` is an
  Orbax restore skeleton; ``torch.load`` needs none, so it has no
  counterpart here;
* ``make_lm_pipeline_step_fns``: the train and eval steps of one rank of
  a ``(data, pipe, seq, model)`` world (``parallel.mesh.build_lm_mesh``: the JAX manual
  region ``P(("data", "expert"), "seq", "model", None)``), on
  ``PipelinedSteps``, the step that the ViT's pipeline shares.  With
  ``seq`` above 1 each stage's attention core is the flat step's on the
  stage's ``seq`` group (the ring, the windowed ring, Ulysses, flash
  inside where ``normalize_flash`` resolves it), and each rank takes its
  sequence block of its data row's rows; with ``model`` above 1 each
  stage's blocks are tensor-parallel (``models/transformer.ModelShard``),
  the embedding on stage 0 and the head and loss on the last
  vocab-parallel, and the handoff sends the replicated activation once a
  stage pair, on each model rank's own pipe group.
"""

from __future__ import annotations

from collections import deque
from typing import Callable

import torch

from ddl_tpu_torch.models.transformer import (
    LMConfig,
    TransformerLM,
    apply_final_norm_and_head,
    fold_seed,
    init_lm_weights,
    remat_block,
)
from ddl_tpu_torch.parallel.mesh import (
    SEQ_AXIS,
    build_lm_mesh,
    mean_over_data,
    mean_over_mesh,
)
from ddl_tpu_torch.parallel.pipeline import Handoff, schedule_ticks
from ddl_tpu_torch.parallel.sharding import (
    LMMeshSpec,
    normalize_flash,
    require_lm_train_axes,
    require_model_split,
    require_no_fsdp,
    validate_kv_head_sharding,
    validate_ulysses_kv_heads,
)

__all__ = [
    "SCHEDULES",
    "BlocksPipeline",
    "PipelinedSteps",
    "convert_lm_state",
    "layer_chunks",
    "make_lm_pipeline_step_fns",
    "mb_layer_seed",
    "merge_lm_params",
    "saved_pipe_stages",
    "saved_virtual_stages",
    "split_lm_params",
]

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
        """GPipe's forward ticks alone: ``tail(y, m)`` of each microbatch's
        last-global-stage output ``y``, on the last rank (a list in
        microbatch order; None elsewhere)."""
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
                    outs[m] = tail(y, m)
                else:
                    sends.append(((s + 1) % P, y))
            inbox.update(self._exchange(t, sends, self.eval_at))
        return [outs[m] for m in range(self.M)] if outs else None


class PipelinedSteps:
    """The step around ``BlocksPipeline`` that every pipelined model shares
    (the LM's below, the ViT's in ``train/vit_steps.py``), on this rank's
    stage: the ``block{l}`` layers of its chunks, each run by ``run_block``
    (``models.transformer.remat_block``), ``embed`` on stage 0 and the loss
    on the last.

    ``train``: stage 0 embeds the whole batch and back-propagates the
    microbatches' cotangents through the embedding in one backward (the
    JAX ``embed_vjp``); the last stage backpropagates ``ce / M`` of each
    microbatch, so the sum is the batch's mean (the microbatches are
    equal).  The dropout key is the step's folded with the rank's data
    coordinate (and its sequence block with ``seq`` above 1): every stage,
    model rank and schedule of a row draws the same masks
    (``mb_layer_seed``), and no two rows or blocks draw the same ones, as
    the JAX pipeline draws over the global microbatch.  After the M
    backwards ``nan@grad`` poisons its step's gradients, the gradients and
    the metrics are averaged over ``seq`` (``mean_over_mesh``), then over
    ``data`` (``mean_over_data``), the
    optimizer's clip norm sums its square over the stages
    (``attach``: ``Optimizer.norm_reduce``), and the metrics reach every
    stage of the row from the last.  ``forward`` is the forward-only
    GPipe."""

    def __init__(self, mesh, n_layers: int, run_block: Callable, *, schedule: str,
                 num_microbatches: int, virtual: int, dtype: torch.dtype, remat: bool,
                 seed: int, dropout: bool, nan_grad_step: int | None) -> None:
        self.mesh, self.M = mesh, num_microbatches
        self.s, self.last = mesh.pipe_index, mesh.spec.pipe - 1
        self.chunks = layer_chunks(n_layers, mesh.spec.pipe, virtual)[self.s]
        self.run_block = run_block
        self.seed, self.dropout, self.nan_grad_step = seed, dropout, nan_grad_step
        self.model = None  # the stage the clock runs: the state's, set by each call
        self.engine = BlocksPipeline(mesh, self._run_chunk, self._chunk_params,
                                     schedule=schedule, num_microbatches=num_microbatches,
                                     virtual=virtual, dtype=dtype, remat=remat)

    def _run_chunk(self, c, x, m, key):
        for ell in self.chunks[c]:
            block = getattr(self.model, f"block{ell}")
            layer_seed = None if key is None else mb_layer_seed(key, m, ell)
            x, _aux = self.run_block(block, x, None, None, False, key is None, layer_seed)
        return x

    def _chunk_params(self, c):
        return [p for ell in self.chunks[c] for p in getattr(self.model, f"block{ell}").parameters()]

    def attach(self, optimizer):
        """``optimizer`` with its clip norm summed over the stages."""
        if hasattr(optimizer, "norm_reduce"):
            optimizer.norm_reduce = self.engine.handoff.sum
        return optimizer

    def step_key(self, step: int) -> int:
        """The dropout key of ``step`` on this rank's data row."""
        from ddl_tpu_torch.train.lm_steps import dropout_step_key

        key = dropout_step_key(self.seed, step)
        if self.mesh.spec.seq > 1:
            return fold_seed(key, self.mesh.data_index, self.mesh.seq_index)
        return fold_seed(key, self.mesh.data_index)

    def _boundary(self, inputs, positions: int, width: int) -> tuple:
        if inputs.shape[0] % self.M:
            raise ValueError(f"per-replica batch {inputs.shape[0]} % microbatches {self.M} != 0")
        return (inputs.shape[0] // self.M, positions, width)

    def _first(self, embed: Callable, inputs, rows: int):
        """Stage 0: the embedded rows (with their graph) and each
        microbatch's slice of them."""
        if self.s != 0:
            return None, None
        emb = embed(inputs)
        return emb, emb.detach().split(rows).__getitem__

    def train(self, state, inputs, targets, *, embed: Callable, loss: Callable,
              n_metrics: int, positions: int, width: int):
        """One step of ``state`` (``.model``, ``.optimizer``, ``.step``,
        updated in place): ``embed(inputs)`` on stage 0; ``loss(y,
        targets_m) -> (ce, metrics)`` of each microbatch on the last, the
        metrics a vector of ``n_metrics``.  Returns the metrics, the mean
        over the microbatches and ``data``, on every rank."""
        from ddl_tpu_torch.train.lm_steps import poison_nan_grads

        model, opt = state.model, state.optimizer
        self.model = model
        opt.zero_grad()
        shape = self._boundary(inputs, positions, width)
        emb, first = self._first(embed, inputs, shape[0])
        head = None
        if self.s == self.last:
            tgt = targets.split(shape[0])

            def head(y, m):
                ce, met = loss(y, tgt[m])
                return ce / self.M, met

        key = self.step_key(state.step) if self.dropout else None
        dx, met = self.engine.train(shape, first, head, key)
        if emb is not None:
            emb.backward(torch.cat(dx))
        params = [p for p in model.parameters() if p.grad is not None]
        poison_nan_grads(state.step, params, self.nan_grad_step)
        on_last = self.s == self.last
        met = met / self.M if on_last else torch.zeros(n_metrics, device=self.mesh.device)
        with torch.no_grad():
            self.mean([p.grad for p in params] + ([met] if on_last else []))
        opt.step()
        state.step += 1
        return self.broadcast(met)

    @torch.no_grad()
    def forward(self, model, inputs, *, embed: Callable, tail: Callable, positions: int,
                width: int) -> list | None:
        """The forward-only GPipe: ``tail(y, m)`` of each microbatch on the
        last stage (a list in microbatch order; None elsewhere)."""
        self.model = model
        shape = self._boundary(inputs, positions, width)
        _, first = self._first(embed, inputs, shape[0])
        return self.engine.forward(shape, first, tail if self.s == self.last else None)

    def mean(self, tensors: list) -> None:
        """The tensors' means over ``seq`` (above 1), then over ``data``."""
        if self.mesh.spec.seq > 1:
            mean_over_mesh(tensors, self.mesh, axis=SEQ_AXIS)
        mean_over_data(tensors, self.mesh)

    def broadcast(self, x):
        """The last stage's ``x`` on every stage of the row."""
        return self.engine.handoff.broadcast(x, self.last)


# ---------------------------------------------------------------- layout


def _layer(key: str) -> int | None:
    """The global layer of a ``block{l}.`` key, else None."""
    head = key.split(".", 1)[0]
    return int(head[5:]) if head.startswith("block") and head[5:].isdigit() else None


def _order(key: str) -> tuple:
    """A key's place in the whole model's ``state_dict`` order: ``embed``,
    the blocks by layer, ``norm_f``, ``lm_head`` (a stable sort keeps each
    module's own order inside its group)."""
    layer = _layer(key)
    if layer is not None:
        return (1, layer)
    return ({"embed": 0, "norm_f": 2, "lm_head": 3}[key.split(".", 1)[0]],)


def _stage_keys(keys, n_layers: int, n_stages: int, virtual: int) -> list[list[str]]:
    """The keys of each stage (``TransformerLM(stage=s)``), in order."""
    chunks = layer_chunks(n_layers, n_stages, virtual)
    edges = {"embed": 0, "norm_f": n_stages - 1, "lm_head": n_stages - 1}
    out = []
    for s in range(n_stages):
        layers = set(sum(chunks[s], []))

        def here(key):
            layer = _layer(key)
            return layer in layers if layer is not None else edges[key.split(".", 1)[0]] == s

        out.append([k for k in keys if here(k)])
    return out


def _n_layers(keys) -> int:
    layers = {_layer(k) for k in keys} - {None}
    if not layers or "lm_head.kernel" not in keys:
        raise ValueError(f"unrecognized params layout (keys: {sorted(keys)[:8]}...)")
    return max(layers) + 1


def split_lm_params(full_params: dict, n_stages: int, virtual: int = 1) -> list[dict]:
    """A whole ``TransformerLM`` ``state_dict`` -> the stages' (each
    ``TransformerLM(cfg, stage=s, stages=n_stages, virtual=virtual)``'s
    keys, the same tensors): the JAX ``split_lm_params``, whose stacked
    ``blocks[s, (c,) j]`` is layer ``(c*P + s)*k + j`` here
    (``layer_chunks``)."""
    parts = _stage_keys(list(full_params), _n_layers(full_params), n_stages, virtual)
    return [{k: full_params[k] for k in keys} for keys in parts]


def merge_lm_params(stages: list[dict]) -> dict:
    """The inverse of ``split_lm_params``: the stages' ``state_dict``s ->
    the whole model's, in its key order (any ``virtual``: the layers carry
    their global names)."""
    full = {k: v for part in stages for k, v in part.items()}
    return {k: full[k] for k in sorted(full, key=_order)}


def saved_pipe_stages(params) -> int:
    """The stage count a params layout was written with: 1 for a whole
    model's ``state_dict``, the list's length for the stages'."""
    if isinstance(params, (list, tuple)):
        _n_layers(merge_lm_params(params))  # layout sanity check
        return len(params)
    _n_layers(params)
    return 1


def saved_virtual_stages(params) -> int:
    """The virtual-stage count a params layout was written with (1 for a
    whole model's): the runs of consecutive layers stage 0 holds, since
    global stage ``c*P`` follows ``(c-1)*P + P-1`` there."""
    if saved_pipe_stages(params) == 1:
        return 1
    layers = sorted({_layer(k) for k in params[0]} - {None})
    return 1 + sum(b != a + 1 for a, b in zip(layers, layers[1:]))


def _split_optimizer(opt: dict, keys: list[str], parts: list[list[str]]) -> list[dict]:
    """An ``Optimizer.state_dict()`` over the whole model's parameters
    (indexed in ``keys``' order) -> the stages' (``parts``' keys)."""
    index = {k: i for i, k in enumerate(keys)}
    state, groups = opt["inner"]["state"], opt["inner"].get("param_groups")
    out = []
    for part in parts:
        inner = {"state": {j: state[index[k]] for j, k in enumerate(part)
                           if index[k] in state}}
        if groups is not None:
            inner["param_groups"] = [dict(g, params=list(range(len(part)))) for g in groups]
        out.append({**opt, "inner": inner})
    return out


def _merge_optimizer(opts: list[dict], parts: list[list[str]], keys: list[str]) -> dict:
    """The inverse of ``_split_optimizer``: the stages' optimizer states
    (indexed in ``parts``' orders) -> the whole model's (``keys``')."""
    index = {k: i for i, k in enumerate(keys)}
    state = {}
    for opt, part in zip(opts, parts):
        for j, st in opt["inner"]["state"].items():
            state[index[part[j]]] = st
    inner = {"state": dict(sorted(state.items()))}
    groups = opts[0]["inner"].get("param_groups")
    if groups is not None:
        inner["param_groups"] = [dict(g, params=list(range(len(keys)))) for g in groups]
    return {**opts[0], "inner": inner}


def convert_lm_state(state: dict, *, n_stages: int | None = None, virtual: int = 1) -> dict:
    """Carry a snapshot state between the one-device layout (``{"model":
    state_dict, "optimizer": Optimizer.state_dict(), ...}``) and the
    stages' (``{"stages": [{"model", "optimizer"}, ...], ...}``), the
    other entries (the step) kept: the JAX ``convert_lm_state``.  Adam's
    per-parameter entries (``exp_avg``, ``exp_avg_sq``, ``step``) are
    indexed in their model's key order, which is the parameters' order for
    the trainable LM, and follow their parameter.

    ``n_stages`` (with ``virtual``) converts the one-device layout to the
    stages'; without it, the stages' layout (any ``virtual``) is merged."""
    rest = {k: v for k, v in state.items() if k not in ("model", "optimizer", "stages")}
    if n_stages is None:
        if "stages" not in state:
            raise ValueError("state is not in pipeline layout; pass n_stages to convert "
                             "full -> pipeline")
        parts = [list(st["model"]) for st in state["stages"]]
        model = merge_lm_params([st["model"] for st in state["stages"]])
        opt = _merge_optimizer([st["optimizer"] for st in state["stages"]], parts, list(model))
        return {"model": model, "optimizer": opt, **rest}
    if "model" not in state:
        raise ValueError("state is not in full layout")
    keys = list(state["model"])
    parts = _stage_keys(keys, _n_layers(keys), n_stages, virtual)
    opts = _split_optimizer(state["optimizer"], keys, parts)
    return {"stages": [{"model": {k: state["model"][k] for k in part}, "optimizer": opt}
                       for part, opt in zip(parts, opts)], **rest}


# ------------------------------------------------------------ the steps


def _check_lm_pipeline(cfg, spec, batch: int, seq_len: int, M: int, schedule: str,
                       V: int) -> None:
    """The JAX factory's checks (``ddl_tpu/parallel/lm_pipeline.py:
    1197-1270``), in its order and with its messages; then the port's even
    split over ``model`` (``require_model_split``)."""
    validate_kv_head_sharding(cfg, spec)
    if cfg.ce_vocab_chunk and spec.model > 1:
        raise ValueError(
            f"ce_vocab_chunk={cfg.ce_vocab_chunk} requires mesh model=1 "
            "(the vocab scan slices the head kernel; use ce_chunk, whose "
            "per-chunk matmul shards over 'model')"
        )
    n_stages = spec.pipe
    if n_stages < 2:
        raise ValueError("make_lm_pipeline_step_fns needs spec.pipe >= 2")
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    if cfg.ce_vocab_chunk and schedule in ("1f1b", "zb"):
        raise ValueError(
            f"ce_vocab_chunk is not supported with the {schedule.upper()} "
            "schedule (its per-microbatch head loss runs inside the manual "
            "region, where the vocab-scan custom VJP is unverified); use "
            "the GPipe schedule or ce_chunk"
        )
    if V < 1:
        raise ValueError(f"virtual_stages must be >= 1, got {V}")
    if schedule == "zb" and V > 1:
        raise ValueError(
            f"virtual_stages={V} requires schedule='gpipe' or '1f1b' "
            "(the zero-bubble B/W-split clock loop is single-chunk; "
            "compose virtual stages with 1f1b instead)"
        )
    if V > 1 and M % n_stages:
        raise ValueError(
            f"num_microbatches {M} % pipe {n_stages} != 0 (the interleaved "
            "schedule advances microbatches in groups of pipe)"
        )
    if cfg.attn_impl not in ("dense", "ring", "ulysses"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    if not cfg.causal and (cfg.attn_impl != "dense" or cfg.flash):
        raise ValueError(
            "causal=False is only implemented for the XLA dense attention "
            "path (the nested ring/Ulysses/flash cores are built causal)"
        )
    if cfg.flash and cfg.attn_impl == "dense" and spec.seq > 1:
        raise ValueError(
            "flash=True with attn_impl='dense' requires mesh seq=1 "
            "(the kernel attends within one device's sequence; use "
            "attn_impl='ulysses' to combine flash with sequence parallelism)"
        )
    if cfg.flash and cfg.n_heads % spec.model:
        raise ValueError(
            f"n_heads {cfg.n_heads} % mesh model={spec.model} != 0 (the "
            "flash kernel runs head-local inside a fully-manual region)"
        )
    if cfg.attn_impl == "ulysses":
        if cfg.n_heads % spec.seq:
            raise ValueError(
                f"n_heads {cfg.n_heads} % mesh seq={spec.seq} != 0 (the nested "
                "Ulysses all-to-all splits the global head dim across seq)"
            )
        validate_ulysses_kv_heads(cfg, spec)
    if cfg.n_layers % (n_stages * V):
        raise ValueError(f"n_layers {cfg.n_layers} % (pipe {n_stages} * virtual {V}) != 0")
    if M < 1:
        raise ValueError(f"num_microbatches must be >= 1, got {M}")
    if batch % M:
        raise ValueError(f"batch {batch} % microbatches {M} != 0")
    mb = batch // M
    if mb % (spec.data * spec.expert):
        raise ValueError(
            f"microbatch {mb} must divide by mesh data*expert="
            f"{spec.data * spec.expert} (batch shards over both)"
        )
    if seq_len % spec.seq:
        raise ValueError(f"seq_len {seq_len} % mesh seq={spec.seq} != 0")
    if cfg.num_experts and cfg.num_experts % spec.expert:
        raise ValueError(f"num_experts {cfg.num_experts} % mesh expert={spec.expert} != 0")
    require_model_split(cfg, spec)


def make_lm_pipeline_step_fns(
    cfg: LMConfig,
    spec: LMMeshSpec,
    tx: Callable,
    seed: int,
    batch: int,
    seq_len: int,
    num_microbatches: int,
    device=None,
    schedule: str = "gpipe",
    virtual_stages: int = 1,
    mesh=None,
):
    """Pipeline-parallel LM step functions (``train.lm_steps.LMStepFns``),
    for ``spec.pipe > 1`` over ``data`` x ``pipe`` x ``seq`` x ``model``
    ranks.

    Rank ``(d, s, ...)`` holds stage ``s`` of the model (``TransformerLM(cfg,
    stage=s, ...)``, loaded from ``init_lm_weights(seed)``'s whole model,
    cut over ``model`` where it is above 1, so a pipelined run starts where
    a flat one does) and runs data row ``d``'s rows (its sequence block
    with ``seq`` above 1) through the schedule's clock (``BlocksPipeline``:
    ``gpipe``, ``1f1b``, ``zb``; ``virtual_stages > 1`` the interleaved
    ``gpipe``/``1f1b``) in ``num_microbatches`` microbatches, inside the
    step every pipelined model shares (``PipelinedSteps``: the embedding's
    one backward, the dropout key of each step and data row, the
    averages over ``data``, the clip norm over the stages, ``nan@grad:K``
    from ``faultinject.traced_nan_step``, read here).  The last stage runs
    ``norm_f``, the head and each microbatch's mean cross-entropy (dense,
    or ``ops/losses``' chunked head+CE under
    ``ce_chunk``/``ce_vocab_chunk``): the microbatches are equal, so the
    sum of ``ce / M`` is the batch's mean, under GPipe too (where JAX
    takes the full batch's).  Each stage's blocks take the attention core
    the flat step takes on the stage's ``seq`` group: the ring or Ulysses
    (flash inside where ``normalize_flash`` resolves ``flash`` to it), the
    flash kernels (#4-#6) or the dense core.  Under ``model`` the loss is
    vocab-parallel.  Eval is the forward-only GPipe: ``loss``, ``ce``,
    ``moe_aux`` and ``accuracy`` over the global batch, on every rank.
    Every check of the JAX factory runs first, with its message, before
    any world is needed; ``expert`` above 1 and ``fsdp`` over ``data``
    raise ``NotImplementedError`` naming their ROADMAP items, and so does a
    MoE model (item 11c)."""
    from ddl_tpu_torch.models.convert import shard_lm_state
    from ddl_tpu_torch.ops.flash_attention import require_flash_kernel
    from ddl_tpu_torch.ops.losses import fused_chunked_ce, fused_vocab_chunked_ce
    from ddl_tpu_torch.parallel.rules import lm_rules
    from ddl_tpu_torch.train.lm_steps import (
        LMStepFns,
        LMTrainState,
        _attention_core,
        _token_ce,
        attach_model_norm,
        init_sharded_model,
        model_shard,
        token_accuracy,
    )
    from ddl_tpu_torch.utils import faultinject

    require_lm_train_axes(spec, "make_lm_pipeline_step_fns")
    require_no_fsdp(cfg, spec, "make_lm_pipeline_step_fns")
    if cfg.num_experts:
        raise NotImplementedError(
            f"num_experts={cfg.num_experts} on mesh pipe={spec.pipe}: the pipelined MoE "
            "(the aux loss's cotangent through the stages) is ROADMAP item 11c"
        )
    device_type = (mesh.device.type if mesh is not None
                   else torch.device("cuda" if device is None else device).type)
    cfg = normalize_flash(cfg, spec, seq_len, device_type)
    M, V = num_microbatches, virtual_stages
    _check_lm_pipeline(cfg, spec, batch, seq_len, M, schedule, V)
    require_flash_kernel(cfg, device_type)
    if mesh is None:
        mesh = build_lm_mesh(spec, device)
    device, P, s = mesh.device, spec.pipe, mesh.pipe_index
    # the flat step's core on the stage's seq group
    attn_core = _attention_core(cfg, mesh, spec)
    tp = model_shard(mesh, spec)
    steps = PipelinedSteps(mesh, cfg.n_layers, remat_block(cfg), schedule=schedule,
                           num_microbatches=M, virtual=V, dtype=cfg.dtype, remat=cfg.remat,
                           seed=seed, dropout=cfg.dropout_rate > 0.0,
                           nan_grad_step=faultinject.traced_nan_step())

    def init_state() -> LMTrainState:
        whole = TransformerLM(cfg)
        init_lm_weights(whole, seed)
        model = TransformerLM(cfg, attn_core, stage=s, stages=P, virtual=V,
                              seq_index=mesh.seq_index, tp=tp)
        init_sharded_model(model, whole, tp, shard_lm_state)
        del whole
        model.to(device)
        opt = attach_model_norm(tx(model.parameters()), model, tp, lm_rules())
        return LMTrainState(step=0, model=model, optimizer=steps.attach(opt))

    def head_ce(model, y, tgt, with_accuracy: bool):
        """The last stage's (ce, accuracy or None) of one microbatch."""
        if cfg.ce_vocab_chunk:
            return fused_vocab_chunked_ce(model.norm_f(y), model.lm_head.kernel, tgt,
                                          cfg.ce_vocab_chunk, with_accuracy)
        if cfg.ce_chunk:
            return fused_chunked_ce(model.norm_f(y), model.lm_head.kernel, tgt, cfg.ce_chunk,
                                    with_accuracy=with_accuracy, tp=tp, vocab=cfg.vocab_size)
        logits = apply_final_norm_and_head(model, y)
        acc = token_accuracy(logits, tgt, tp, cfg.vocab_size) if with_accuracy else None
        return _token_ce(logits, tgt, tp, cfg.vocab_size), acc

    def train(state: LMTrainState, inputs, targets):
        model = state.model
        inputs, targets = inputs.to(device), targets.to(device)

        def loss(y, tgt):
            ce, _ = head_ce(model, y, tgt, False)
            return ce, ce.detach()[None]

        met = steps.train(state, inputs, targets, embed=lambda x: model.embed(x), loss=loss,
                          n_metrics=1, positions=inputs.shape[1], width=cfg.d_model)
        # the dense model's aux loss is 0: the loss is the cross-entropy
        return state, {"loss": met[0], "ce": met[0].clone(),
                       "moe_aux": torch.zeros((), device=device)}

    def evaluate(state: LMTrainState, inputs, targets) -> dict:
        model = state.model
        inputs, targets = inputs.to(device), targets.to(device)
        outs = steps.forward(
            model, inputs, embed=lambda x: model.embed(x),
            tail=lambda y, m: torch.stack(head_ce(model, y, targets.chunk(M)[m], True)),
            positions=inputs.shape[1], width=cfg.d_model)
        with torch.no_grad():
            if outs is None:
                met = torch.zeros(2, device=device)
            else:
                met = torch.stack(outs).mean(0)
                steps.mean([met])
            met = steps.broadcast(met)
        return {"loss": met[0], "ce": met[0].clone(),
                "moe_aux": torch.zeros((), device=device), "accuracy": met[1]}

    return LMStepFns(train=train, evaluate=evaluate, init_state=init_state, device=device,
                     mesh=mesh)
