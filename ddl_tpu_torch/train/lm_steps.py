"""Train and eval steps for the transformer LM (counterpart of
``ddl_tpu/train/lm_steps.py``, its non-pipelined path), on one device or
on a ``data`` x ``seq`` x ``model`` mesh of ranks.

The JAX factory builds one jitted SPMD program per step over a 5-axis
mesh; here each rank (one process, one device) runs a plain eager step on
its block of the global batch -- rows ``data_index * B/data ...``,
columns ``seq_index * T/seq ...`` (``local_block``): the forward (dropout
seeded per (seed, step, layer), each block rematerialised per
``cfg.remat_policy``), the mean next-token cross-entropy (dense, or a
chunked head+CE with ``ce_chunk`` or ``ce_vocab_chunk``, ``ops/
losses.py``), plus the MoE aux loss, the backward (through the flash
kernels when ``cfg.flash`` resolves to them), one optimizer update.
Metrics stay on the device as 0-dim tensors (with MoE, the router's drop
fraction and load spread too).

On a mesh (``parallel.mesh.LMMesh``, ``build_lm_mesh``) the attention
core is chosen as the JAX factory chooses it: the ring
(``parallel/ring_attention.py``) or Ulysses (``parallel/ulysses.py``),
with the flash kernels inside under ``flash``; dense with ``seq`` above 1
gathers K/V over the ``seq`` ranks and masks on global positions
(``make_seq_dense_core``: GSPMD's gather in the JAX program); dense with
``flash`` at ``seq`` 1 is the kernel on the rank's rows.  The model rotates
its queries and keys at global positions (``TransformerLM(seq_index=)``),
and each rank's dropout key folds in its (data, seq) coordinate.  Every
rank's loss is its block's token mean over equally many tokens, so the
global token mean is their mean; after the backward (which the sequence
collectives carry across ranks) one all-reduce of the concatenated
gradients and metrics over all ``data * seq`` ranks makes every rank's
gradient the global loss's (``parallel.mesh.mean_over_mesh``).  With
``zero_sharding`` the gradients are first averaged over ``seq``, then
ZeRO-1 (``train/fused_optim.with_zero``, over ``data`` only, as JAX's)
reduce-scatters them over ``data``.  On one device the step is what it
was before the mesh: no collective, the model's own positions and keys.

The ``nan@grad:K`` fault (``utils/faultinject.traced_nan_step``) is read
when the factory builds: the train step it builds replaces every
gradient by NaN at optimizer step K, and a rebuild (a rollback's grace
window) finds it consumed and runs clean.

The ``model`` axis (tensor parallelism, JAX's ``lm_rules`` placement):
every rank of a (data, seq) coordinate's model group holds its part of the
model (``models/transformer.ModelShard``: column-parallel Q/K/V and
``wi``, row-parallel ``out`` and ``wo``, the vocab-parallel embedding and
head), cut from ``init_lm_weights(seed)``'s whole model
(``models/convert.shard_lm_state``), so a sharded run starts where one
device does.  The attention cores run on the rank's heads.  The loss edge
is vocab-parallel (``ops/losses.vocab_parallel_ce``, and in
``fused_chunked_ce``), the accuracy the argmax over the ranks.  The
dropout key folds in (data, seq) alone: the residual stream is replicated
over ``model``, so its masks are too.  The gradients are averaged over the
replicas of the rank's part (``data * seq`` ranks), the clip norm sums the
sharded leaves' squares over ``model`` (``Optimizer.model_norm``), and
ZeRO-1 splits each rank's part over ``data`` on a dimension its spec
leaves whole.

With ``spec.pipe > 1`` the factory hands over to the pipeline's
(``parallel/lm_pipeline.make_lm_pipeline_step_fns``, over ``data`` x
``pipe`` x ``seq`` x ``model``), as the JAX one does.

Not ported here, and refused with the ROADMAP item that brings them
(``NotImplementedError``): the ``expert`` axis and a MoE model on a mesh
of several ranks (item 11c: its load-balance aux loss is nonlinear in the
batch's routing statistics, ``accumulate_grads`` says so, so a rank-local
aux is not JAX's global one; its all-reduced statistics come with expert
parallelism), and ``fsdp`` over a data axis above 1 (item 11b, FSDP).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple

import torch

from ddl_tpu_torch.models.transformer import (
    LMConfig,
    ModelShard,
    MoeMlp,
    TransformerLM,
    fold_seed,
    init_lm_weights,
)
from ddl_tpu_torch.ops.attention import dense_attention
from ddl_tpu_torch.ops.flash_attention import flash_attention, require_flash_kernel
from ddl_tpu_torch.ops.losses import (
    fused_chunked_ce,
    fused_vocab_chunked_ce,
    vocab_parallel_ce,
    vocab_parallel_hits,
)
from ddl_tpu_torch.parallel.mesh import (
    SEQ_AXIS,
    LMMesh,
    all_gather,
    build_lm_mesh,
    mean_over_mesh,
    model_all_reduce,
)
from ddl_tpu_torch.parallel.ring_attention import make_ring_self_attention
from ddl_tpu_torch.parallel.sharding import (
    LMMeshSpec,
    normalize_flash,
    require_lm_train_axes,
    require_model_split,
    require_no_fsdp,
    validate_kv_head_sharding,
    validate_ulysses_kv_heads,
)
from ddl_tpu_torch.parallel.ulysses import make_ulysses_self_attention
from ddl_tpu_torch.utils.device import resolve_device

__all__ = [
    "LMStepFns",
    "LMTrainState",
    "PIPELINE_SCHEDULES",
    "accumulate_grads",
    "chunked_ce_loss",
    "dropout_kwargs",
    "dropout_step_key",
    "init_sharded_model",
    "local_block",
    "make_lm_step_fns",
    "make_seq_dense_core",
    "model_shard",
    "token_accuracy",
    "moe_router_metrics",
    "poison_nan_grads",
]

# ddl_tpu/parallel/rules.py's schedule names (parallel/lm_pipeline.py)
PIPELINE_SCHEDULES = ("gpipe", "1f1b", "zb")


@dataclasses.dataclass
class LMTrainState:
    """The optimizer step count, the model (f32 master weights on the
    device) and its optimizer.  ``train`` updates all three in place and
    returns the same object."""

    step: int
    model: TransformerLM
    optimizer: object


class LMStepFns(NamedTuple):
    """train(state, inputs, targets) -> (state, metrics);
    evaluate(state, inputs, targets) -> metrics, both on this rank's block
    of the global batch (``local_block``) with metrics over the global
    batch; init_state() -> a fresh LMTrainState; device: where it all
    runs; mesh: this rank's ``parallel.mesh.LMMesh`` (a mesh of one rank
    on one device)."""

    train: Callable
    evaluate: Callable
    init_state: Callable
    device: torch.device
    mesh: LMMesh


def _token_ce(logits, targets, tp: ModelShard | None = None, vocab: int = 0):
    """Mean next-token cross-entropy (f32, stable); under ``tp`` over this
    rank's vocab rows of a ``vocab``-long head (``vocab_parallel_ce``)."""
    if tp is not None and tp.on:
        return vocab_parallel_ce(logits, targets, tp, vocab).mean()
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return (lse - picked).mean()


def poison_nan_grads(step: int, params, nan_step: int | None) -> None:
    """The ``nan@grad`` fault: at optimizer step ``nan_step`` (from
    ``faultinject.traced_nan_step()``, read when the factory builds) every
    gradient of ``params`` becomes NaN, a real diverged update inside the
    step.  Nothing happens when unarmed or at another step."""
    if nan_step is None or step != nan_step:
        return
    with torch.no_grad():
        for p in params:
            if p.grad is not None:
                p.grad.fill_(float("nan"))


def token_accuracy(logits, targets, tp: ModelShard | None = None, vocab: int = 0):
    """The share of tokens whose argmax is the target (under ``tp`` the
    argmax over the ranks' vocab rows)."""
    if tp is not None and tp.on:
        return vocab_parallel_hits(logits, targets, tp, vocab).float().mean()
    return (logits.argmax(-1) == targets).float().mean()


def chunked_ce_loss(cfg, hidden, kernel, targets, aux, with_accuracy: bool,
                    tp: ModelShard | None = None):
    """The loss edge of ``ce_chunk`` / ``ce_vocab_chunk``: the chunked
    head+CE over the post-norm hidden states (token-chunked or
    vocab-streamed, per the config) plus the MoE aux loss, as ``(loss,
    (None, metrics))``; the ``None`` logits tell the eval step that the
    accuracy is already in the metrics.  ``tp``: ``kernel`` is this rank's
    vocab rows (``ce_chunk`` only)."""
    if cfg.ce_vocab_chunk:
        ce, acc = fused_vocab_chunked_ce(hidden, kernel, targets, cfg.ce_vocab_chunk,
                                         with_accuracy)
    else:
        ce, acc = fused_chunked_ce(hidden, kernel, targets, cfg.ce_chunk,
                                   with_accuracy=with_accuracy, tp=tp, vocab=cfg.vocab_size)
    loss = ce + cfg.moe_aux_weight * aux
    metrics = {"loss": loss, "ce": ce, "moe_aux": aux}
    if acc is not None:
        metrics["accuracy"] = acc
    return loss, (None, metrics)


def moe_router_metrics(model) -> dict:
    """The router statistics of the last forward, over the MoE blocks:
    the mean dropped share of token-choices (``moe_drop_frac``) and the
    largest and smallest expert share of the kept ones, averaged over the
    blocks (``moe_load_max``, ``moe_load_min``; uniform is 1/E).  Empty
    for a dense model.  Under ``accum_steps > 1`` the step's metrics are
    chunk means, so ``moe_load_max`` is a mean of maxima."""
    stats = [m.router_stats for m in model.modules()
             if isinstance(m, MoeMlp) and m.router_stats is not None]
    if not stats:
        return {}
    load = torch.stack([s[1] for s in stats]).mean(0)
    return {
        "moe_drop_frac": torch.stack([s[0] for s in stats]).mean(),
        "moe_load_max": load.max(),
        "moe_load_min": load.min(),
    }


def dropout_step_key(seed: int, step: int) -> int:
    """Per-step dropout base key, decorrelated from init by the 0x0D0 fold
    (the JAX ``dropout_step_key``; ``models.transformer.fold_seed`` in
    place of ``jax.random.fold_in``)."""
    return fold_seed(seed, 0x0D0, step)


def dropout_kwargs(seed: int, step, rate: float) -> dict:
    """``TransformerLM.forward`` kwargs for optional train-mode dropout:
    active iff a ``step`` is given and ``rate > 0``; the key comes from the
    factory's seed via ``dropout_step_key``."""
    if step is None or rate <= 0.0:
        return {"deterministic": True, "rngs": None}
    return {"deterministic": False, "rngs": {"dropout": dropout_step_key(seed, step)}}


def accumulate_grads(loss_fn, chunked_args, k: int) -> dict:
    """Run ``loss_fn(*chunk) -> (loss, (logits, metrics))`` over the ``k``
    chunks of ``chunked_args`` (parallel sequences), backpropagating each
    ``loss / k`` into the parameters' ``.grad``: the mean gradient of the
    chunks, with one chunk's activations alive at a time.  Returns the
    chunks' mean metrics.  A MoE model routes each chunk on its own, so its
    aux loss (nonlinear in the batch's routing statistics) makes the
    update close to the full batch's, not equal to it."""
    total = None
    for chunk in zip(*chunked_args):
        loss, (_, m) = loss_fn(*chunk)
        (loss / k).backward()
        m = {name: v.detach() for name, v in m.items()}
        total = m if total is None else {name: total[name] + v for name, v in m.items()}
    return {name: v / k for name, v in total.items()}


def local_block(x, mesh: LMMesh | None):
    """This rank's block of a global (B, T) batch ``x`` (numpy or torch):
    rows ``data_index * B/data`` on, columns ``seq_index * T/seq`` on (the
    JAX loader's ``P(("data", "expert"), "seq")`` placement): every stage
    and model rank of a (data, seq) coordinate takes the same block."""
    if mesh is None or mesh.size == 1:
        return x
    rows, d = x.shape[0] // mesh.spec.data, mesh.data_index
    cols, s = x.shape[1] // mesh.spec.seq, mesh.seq_index
    return x[d * rows:(d + 1) * rows, s * cols:(s + 1) * cols]


def make_seq_dense_core(mesh: LMMesh, causal: bool = True, window: int = 0) -> Callable:
    """Dense attention of this rank's query block over the whole sequence:
    K/V all-gathered over the ``seq`` ranks (the backward reduce-scatters
    their cotangents), the causal band on global query positions
    ``seq_index * T_local + arange(T_local)`` -- what GSPMD makes of the JAX
    model's dense attention under a sharded sequence."""
    group, s = mesh.seq_group, mesh.seq_index

    def core(q, k, v):
        k, v = all_gather(k, group, 1), all_gather(v, group, 1)
        if not causal:
            return dense_attention(q, k, v)
        t = q.shape[1]
        q_pos = s * t + torch.arange(t, device=q.device)[:, None]
        k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = k_pos <= q_pos
        if window:
            mask &= k_pos > q_pos - window
        return dense_attention(q, k, v, mask=mask)

    return core


def _attention_core(cfg, mesh: LMMesh, spec: LMMeshSpec):
    """The JAX factory's choice of attention core (``ddl_tpu/train/
    lm_steps.py:547-572``); None is the model's own dense attention."""
    if cfg.attn_impl == "ring":
        return make_ring_self_attention(mesh, causal=True, use_flash=bool(cfg.flash),
                                        window=cfg.attn_window)
    if cfg.attn_impl == "ulysses":
        return make_ulysses_self_attention(mesh, causal=True,
                                           attn_fn=flash_attention if cfg.flash else None,
                                           window=cfg.attn_window)
    if cfg.flash:
        return partial(flash_attention, causal=True, window=cfg.attn_window)
    if spec.seq > 1:
        return make_seq_dense_core(mesh, causal=cfg.causal, window=cfg.attn_window)
    return None


def model_shard(mesh: LMMesh, spec: LMMeshSpec) -> ModelShard | None:
    """This rank's ``ModelShard`` on ``spec``'s mesh, None where its
    ``model`` axis is 1; a ValueError unless ``mesh`` is the ``LMMesh``
    that ``build_lm_mesh(spec)`` lays out."""
    axes = ("data", "pipe", "seq", "model")
    if not isinstance(mesh, LMMesh) or any(
            getattr(mesh.spec, a) != getattr(spec, a) for a in axes):
        raise ValueError(f"{mesh!r} does not lay out the step's mesh {spec}: build it "
                         "with parallel.mesh.build_lm_mesh(spec)")
    if spec.model == 1:
        return None
    return ModelShard(mesh.model_group, spec.model, mesh.model_index)


def init_sharded_model(model, whole, tp: ModelShard | None, shard) -> None:
    """Load ``model`` (this rank's part, possibly a pipeline stage) from
    ``whole`` (the one-device model, initialised): its keys, cut over
    ``model`` by ``shard(state, spec, index)`` under ``tp``."""
    full = whole.state_dict()
    full = {k: full[k] for k in model.state_dict()}
    if tp is not None:
        full = shard({"model": full}, LMMeshSpec(model=tp.size), tp.index)["model"]
    model.load_state_dict(full)


def attach_model_norm(optimizer, model, tp: ModelShard | None, table):
    """``optimizer`` with its clip norm summed over the ``model`` ranks for
    the leaves ``table`` shards over ``model`` (``Optimizer.model_norm``)."""
    if tp is None or not hasattr(optimizer, "model_norm"):
        return optimizer
    specs = table.specs(dict(model.named_parameters()))
    flags = [any(e == "model" or (isinstance(e, tuple) and "model" in e) for e in specs[k])
             for k, _ in model.named_parameters()]
    optimizer.model_norm = (flags, lambda t: model_all_reduce(t, tp.group))
    return optimizer


def zero_specs(model, table, tp: ModelShard) -> list:
    """Per parameter, its one-device shape and its spec under ``table``:
    what ZeRO-1 reads to pick a dimension the spec leaves whole."""
    specs = table.specs(dict(model.named_parameters()))
    out = []
    for k, p in model.named_parameters():
        shape = list(p.shape)
        for i, e in enumerate(specs[k]):
            if e == "model":
                shape[i] *= tp.size
        out.append((tuple(shape), specs[k]))
    return out


def _check_mesh_args(cfg, spec: LMMeshSpec, batch: int, seq_len: int, accum_steps: int):
    """The JAX factory's argument checks at ``expert`` = ``pipe`` = 1,
    message for message (``ddl_tpu/train/lm_steps.py:431-540``)."""
    if cfg.ce_chunk and spec.seq > 1:
        raise ValueError(
            f"ce_chunk={cfg.ce_chunk} requires mesh seq=1 (the chunked CE "
            "scans over sequence positions, which conflicts with sequence "
            "sharding — and under SP the per-device logits are already "
            "T/seq smaller, so use the dense CE there)"
        )
    if accum_steps > 1:
        if batch % accum_steps:
            raise ValueError(f"batch {batch} % accum_steps {accum_steps} != 0")
        if (batch // accum_steps) % (spec.data * spec.expert):
            raise ValueError(
                f"accumulation chunk {batch // accum_steps} must divide by "
                f"mesh data*expert={spec.data * spec.expert} (batch shards "
                "over both)"
            )
    if cfg.attn_impl not in ("dense", "ring", "ulysses"):
        raise ValueError(
            f"unknown attn_impl {cfg.attn_impl!r} (expected 'dense', 'ring', or 'ulysses')"
        )
    if not cfg.causal and (cfg.attn_impl != "dense" or cfg.flash):
        raise ValueError(
            "causal=False (bidirectional encoder) is only implemented for "
            "the dense attention path; the ring/Ulysses/flash cores "
            "are built causal"
        )
    if batch % (spec.data * spec.expert):
        raise ValueError(
            f"batch {batch} must divide by mesh data*expert="
            f"{spec.data * spec.expert} (batch shards over both axes — "
            "outside MoE layers the expert axis is extra data parallelism)"
        )
    if seq_len % spec.seq:
        raise ValueError(f"seq_len {seq_len} must divide by mesh seq={spec.seq}")
    uses_manual_core = cfg.attn_impl in ("ring", "ulysses") or cfg.flash
    if uses_manual_core and cfg.n_heads % spec.model:
        raise ValueError(
            f"n_heads {cfg.n_heads} must divide by mesh model={spec.model} "
            "for the head-parallel manual attention cores"
        )
    if cfg.attn_impl == "ulysses" and (cfg.n_heads // spec.model) % spec.seq:
        raise ValueError(
            f"local head count {cfg.n_heads // spec.model} (n_heads/model) "
            f"must divide by mesh seq={spec.seq} for Ulysses all-to-all "
            "attention (use attn_impl='ring' otherwise)"
        )
    if cfg.attn_impl == "ulysses":
        validate_ulysses_kv_heads(cfg, spec)
    if cfg.flash and cfg.attn_impl == "dense" and spec.seq > 1:
        raise ValueError(
            "flash=True with attn_impl='dense' requires mesh seq=1 "
            "(the kernel attends within one device's sequence; use "
            "attn_impl='ulysses' to combine flash with sequence parallelism)"
        )


def _sync_grads(mesh: LMMesh, model, optimizer, metrics: dict) -> None:
    """The global step's gradients and metrics on every rank: one
    all-reduce (mean) over every rank, or under ZeRO-1 the gradients'
    mean over ``seq`` and then the optimizer's reduce-scatter over
    ``data``."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    with torch.no_grad():
        if getattr(optimizer, "zero", None) is not None:
            mean_over_mesh(grads, mesh, axis=SEQ_AXIS)
            optimizer.reduce_scatter_grads()
            mean_over_mesh(list(metrics.values()), mesh)
        else:
            mean_over_mesh(grads + list(metrics.values()), mesh)


def make_lm_step_fns(
    cfg: LMConfig,
    spec: LMMeshSpec,
    tx: Callable,
    seed: int,
    batch: int,
    seq_len: int,
    device=None,
    num_microbatches: int = 0,
    accum_steps: int = 1,
    pipeline_schedule: str = "gpipe",
    virtual_stages: int = 1,
    zero_sharding: bool = False,
    mesh: LMMesh | None = None,
) -> LMStepFns:
    """The step functions of LM training on this rank of a ``data`` x
    ``seq`` x ``model`` mesh (one device when every axis is 1).

    ``tx(params) -> Optimizer`` builds the optimizer over the model's
    parameters (``train.state.Optimizer`` follows optax; optax's
    ``adamw(lr)`` is ``Optimizer(params, lr, weight_decay=1e-4)``).
    ``seed`` seeds the weights (``init_lm_weights``, every rank the whole
    model) and the dropout streams; ``batch`` and ``seq_len`` are the
    global batch's.  ``device=None`` means CUDA (``cuda:<local rank>`` in a
    world) and raises without it; ``mesh`` defaults to ``build_lm_mesh``
    over the world, which must hold ``spec.num_devices`` ranks.

    ``accum_steps > 1`` splits the batch into that many equal chunks and
    accumulates their gradients (the mean) before one update, with
    distinct dropout streams ``step * k + i``: for the dense model the
    update equals the full-batch step.  The JAX factory's argument checks
    are kept; the ``expert`` axis and ``fsdp`` over ``data`` raise
    ``NotImplementedError``, and a head count, K/V head count or ``d_ff``
    that ``model`` does not divide a ValueError.  ``spec.pipe > 1`` takes
    the pipeline's factory, with ``num_microbatches`` (0: one a stage),
    ``pipeline_schedule`` and ``virtual_stages``.

    ``ce_chunk`` / ``ce_vocab_chunk`` stop the model at the final norm and
    run the head chunk by chunk inside the loss (``chunked_ce_loss``); eval
    then folds the accuracy into that pass."""
    require_lm_train_axes(spec, "make_lm_step_fns")
    require_no_fsdp(cfg, spec, "make_lm_step_fns")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if pipeline_schedule not in PIPELINE_SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {pipeline_schedule!r}")
    device_type = (mesh.device.type if mesh is not None
                   else torch.device("cuda" if device is None else device).type)
    cfg = normalize_flash(cfg, spec, seq_len, device_type)
    validate_kv_head_sharding(cfg, spec)
    if cfg.ce_vocab_chunk and spec.model > 1:
        raise ValueError(
            f"ce_vocab_chunk={cfg.ce_vocab_chunk} requires mesh model=1 "
            "(the vocab scan slices the head kernel; use ce_chunk, whose "
            "per-chunk matmul shards over 'model')"
        )
    if spec.pipe > 1:
        if accum_steps > 1:
            raise ValueError(
                "accum_steps > 1 is the non-pipelined path's microbatching; "
                "with spec.pipe > 1 use num_microbatches instead"
            )
        if zero_sharding:
            raise ValueError(
                "zero_sharding requires the flat (non-pipelined) step: "
                "the pipeline schedule applies its optimizer inside a "
                "manual shard_map region where the ZeRO sharding "
                "constraints cannot be planted"
            )
        from ddl_tpu_torch.parallel.lm_pipeline import make_lm_pipeline_step_fns

        return make_lm_pipeline_step_fns(
            cfg, spec, tx, seed, batch, seq_len, num_microbatches or spec.pipe,
            device=device, schedule=pipeline_schedule, virtual_stages=virtual_stages, mesh=mesh,
        )
    if pipeline_schedule != "gpipe":
        raise ValueError(
            f"pipeline_schedule={pipeline_schedule!r} requires a pipe mesh "
            "axis (spec.pipe > 1)"
        )
    if virtual_stages != 1:
        raise ValueError(
            f"virtual_stages={virtual_stages} requires a pipe mesh axis "
            "(spec.pipe > 1)"
        )
    if num_microbatches > 1:
        raise ValueError(
            f"num_microbatches={num_microbatches} requires a pipe mesh axis "
            "(spec.pipe > 1); the non-pipelined step has no microbatching"
        )
    several = spec.data * spec.seq * spec.model > 1
    if several and cfg.num_experts:
        raise NotImplementedError(
            f"num_experts={cfg.num_experts} on mesh data={spec.data} x seq={spec.seq} x "
            f"model={spec.model}: the MoE aux loss needs the global routing statistics, "
            "which come with expert parallelism (ROADMAP item 11c)"
        )
    _check_mesh_args(cfg, spec, batch, seq_len, accum_steps)
    require_model_split(cfg, spec)
    if mesh is None:
        mesh = build_lm_mesh(spec, device) if several else LMMesh(spec, resolve_device(device))
    device = mesh.device
    require_flash_kernel(cfg, device.type)
    attn_core = _attention_core(cfg, mesh, spec)
    tp = model_shard(mesh, spec)
    # the fault is read (and consumed) here, when the step is built
    from ddl_tpu_torch.utils import faultinject

    nan_grad_step = faultinject.traced_nan_step()

    def init_state() -> LMTrainState:
        from ddl_tpu_torch.models.convert import shard_lm_state
        from ddl_tpu_torch.parallel.rules import lm_rules

        if tp is None:
            model = TransformerLM(cfg, attn_core, seq_index=mesh.seq_index)
            init_lm_weights(model, seed)
        else:
            whole = TransformerLM(cfg)
            init_lm_weights(whole, seed)
            model = TransformerLM(cfg, attn_core, seq_index=mesh.seq_index, tp=tp)
            init_sharded_model(model, whole, tp, shard_lm_state)
            del whole
        model.to(device)
        optimizer = attach_model_norm(tx(model.parameters()), model, tp, lm_rules())
        if zero_sharding:
            from ddl_tpu_torch.train.fused_optim import with_zero

            # over data, a no-op at data 1, as JAX's with_zero
            optimizer = with_zero(optimizer, mesh if several else spec,
                                  specs=zero_specs(model, lm_rules(), tp) if tp else None)
        return LMTrainState(step=0, model=model, optimizer=optimizer)

    def loss_fn(model, inputs, targets, step=None):
        kw = dropout_kwargs(seed, step, cfg.dropout_rate)
        if several and kw["rngs"] is not None:
            # each (data, seq) shard its own masks; the model ranks of one
            # share them, as they share the residual stream
            kw["rngs"] = {"dropout": fold_seed(kw["rngs"]["dropout"], mesh.data_index,
                                               mesh.seq_index)}
        if cfg.ce_chunk or cfg.ce_vocab_chunk:
            hidden, aux = model(inputs, return_hidden=True, **kw)
            loss, (_, metrics) = chunked_ce_loss(cfg, hidden, model.lm_head.kernel, targets,
                                                 aux, with_accuracy=step is None, tp=tp)
            return loss, (None, dict(metrics, **moe_router_metrics(model)))
        logits, aux = model(inputs, **kw)
        ce = _token_ce(logits, targets, tp, cfg.vocab_size)
        loss = ce + cfg.moe_aux_weight * aux
        return loss, (logits, {"loss": loss, "ce": ce, "moe_aux": aux,
                               **moe_router_metrics(model)})

    def train(state: LMTrainState, inputs, targets):
        inputs, targets = inputs.to(device), targets.to(device)
        state.optimizer.zero_grad()
        if accum_steps == 1:
            loss, (_, m) = loss_fn(state.model, inputs, targets, state.step)
            loss.backward()
            metrics = {name: v.detach() for name, v in m.items()}
        else:
            k = accum_steps
            steps = [state.step * k + i for i in range(k)]
            metrics = accumulate_grads(partial(loss_fn, state.model),
                                       (inputs.chunk(k), targets.chunk(k), steps), k)
        poison_nan_grads(state.step, state.model.parameters(), nan_grad_step)
        if several:
            _sync_grads(mesh, state.model, state.optimizer, metrics)
        state.optimizer.step()
        state.step += 1
        return state, metrics

    def evaluate(state: LMTrainState, inputs, targets) -> dict:
        inputs, targets = inputs.to(device), targets.to(device)
        with torch.inference_mode():
            _, (logits, metrics) = loss_fn(state.model, inputs, targets)
            if logits is not None:  # else the chunked loss folded the accuracy in
                metrics = dict(metrics, accuracy=token_accuracy(logits, targets, tp,
                                                                cfg.vocab_size))
            if several:
                metrics = {k: v.clone() for k, v in metrics.items()}
                mean_over_mesh(list(metrics.values()), mesh)
        return metrics

    return LMStepFns(train=train, evaluate=evaluate, init_state=init_state, device=device,
                     mesh=mesh)
