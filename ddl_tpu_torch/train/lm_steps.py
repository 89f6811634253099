"""Train and eval steps for the transformer LM on one device (counterpart
of ``ddl_tpu/train/lm_steps.py``, its non-pipelined path).

The JAX factory builds one jitted SPMD program per step over a 5-axis
mesh; here the mesh is one device and the step is a plain function that
runs eagerly: the forward (dropout seeded per (seed, step, layer), each
block rematerialised per ``cfg.remat_policy``), the mean next-token
cross-entropy (dense, or a chunked head+CE with ``ce_chunk`` or
``ce_vocab_chunk``, ``ops/losses.py``), plus the MoE aux loss, the
backward (through the flash kernels when ``cfg.flash`` resolves to them),
one optimizer update.  Metrics stay on the device as 0-dim tensors (with
MoE, the router's drop fraction and load spread too); nothing
synchronises.

``zero_sharding`` attaches ``train/fused_optim.with_zero`` to the
optimizer, a no-op on the one-device mesh, as in the JAX package at data
1.  The ``nan@grad:K`` fault (``utils/faultinject.traced_nan_step``) is
read when the factory builds: the train step it builds replaces every
gradient by NaN at optimizer step K, and a rebuild (a rollback's grace
window) finds it consumed and runs clean.

Not ported here, and refused with the ROADMAP item that brings them: the
LM meshes and pipeline schedules (``LMMeshSpec`` axes above 1,
``pipeline_schedule``/``virtual_stages`` other than the defaults,
``num_microbatches > 1``, ring and Ulysses attention, expert parallelism:
item 11).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple

import torch

from ddl_tpu_torch.models.transformer import (
    LMConfig,
    MoeMlp,
    TransformerLM,
    fold_seed,
    init_lm_weights,
)
from ddl_tpu_torch.ops.flash_attention import flash_attention, require_flash_kernel
from ddl_tpu_torch.ops.losses import fused_chunked_ce, fused_vocab_chunked_ce
from ddl_tpu_torch.parallel.sharding import LMMeshSpec, normalize_flash, require_lm_one_device
from ddl_tpu_torch.utils.device import resolve_device

__all__ = [
    "LMStepFns",
    "LMTrainState",
    "PIPELINE_SCHEDULES",
    "accumulate_grads",
    "chunked_ce_loss",
    "dropout_kwargs",
    "dropout_step_key",
    "make_lm_step_fns",
    "moe_router_metrics",
    "poison_nan_grads",
]

# ddl_tpu/parallel/rules.py's schedule names (the LM's pipeline is item 11;
# the ViT runs them, parallel/lm_pipeline.py)
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
    evaluate(state, inputs, targets) -> metrics;
    init_state() -> a fresh LMTrainState; device: where it all runs."""

    train: Callable
    evaluate: Callable
    init_state: Callable
    device: torch.device


def _token_ce(logits, targets):
    """Mean next-token cross-entropy (f32, stable)."""
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


def chunked_ce_loss(cfg, hidden, kernel, targets, aux, with_accuracy: bool):
    """The loss edge of ``ce_chunk`` / ``ce_vocab_chunk``: the chunked
    head+CE over the post-norm hidden states (token-chunked or
    vocab-streamed, per the config) plus the MoE aux loss, as ``(loss,
    (None, metrics))``; the ``None`` logits tell the eval step that the
    accuracy is already in the metrics."""
    if cfg.ce_vocab_chunk:
        ce, acc = fused_vocab_chunked_ce(hidden, kernel, targets, cfg.ce_vocab_chunk,
                                         with_accuracy)
    else:
        ce, acc = fused_chunked_ce(hidden, kernel, targets, cfg.ce_chunk,
                                   with_accuracy=with_accuracy)
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
) -> LMStepFns:
    """The step functions of one-device LM training.

    ``tx(params) -> Optimizer`` builds the optimizer over the model's
    parameters (``train.state.Optimizer`` follows optax; optax's
    ``adamw(lr)`` is ``Optimizer(params, lr, weight_decay=1e-4)``).
    ``seed`` seeds the weights (``init_lm_weights``) and the dropout
    streams.  ``device=None`` means CUDA and raises without it.

    ``accum_steps > 1`` splits the batch into that many equal chunks and
    accumulates their gradients (the mean) before one update, with
    distinct dropout streams ``step * k + i``: for the dense model the
    update equals the full-batch step.  The JAX factory's argument checks
    are kept; what needs a mesh raises ``NotImplementedError``.

    ``ce_chunk`` / ``ce_vocab_chunk`` stop the model at the final norm and
    run the head chunk by chunk inside the loss (``chunked_ce_loss``); eval
    then folds the accuracy into that pass."""
    require_lm_one_device(spec, "make_lm_step_fns")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if pipeline_schedule not in PIPELINE_SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {pipeline_schedule!r}")
    device = resolve_device(device)
    cfg = normalize_flash(cfg, spec, seq_len, device.type)
    for name, value, default in (("pipeline_schedule", pipeline_schedule, "gpipe"),
                                 ("virtual_stages", virtual_stages, 1)):
        if value != default:
            raise NotImplementedError(
                f"{name}={value!r} needs a pipe mesh axis: LM parallelism is ROADMAP item 11"
            )
    if num_microbatches > 1:
        raise NotImplementedError(
            f"num_microbatches={num_microbatches} needs a pipe mesh axis: LM parallelism is "
            "ROADMAP item 11"
        )
    if accum_steps > 1 and batch % accum_steps:
        raise ValueError(f"batch {batch} % accum_steps {accum_steps} != 0")
    if cfg.attn_impl not in ("dense", "ring", "ulysses"):
        raise ValueError(
            f"unknown attn_impl {cfg.attn_impl!r} (expected 'dense', 'ring', or 'ulysses')"
        )
    if cfg.attn_impl != "dense":
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} is sequence parallelism: ROADMAP item 11"
        )
    if not cfg.causal and cfg.flash:
        raise ValueError(
            "causal=False (bidirectional encoder) is only implemented for the dense "
            "attention path; the flash core is built causal"
        )
    require_flash_kernel(cfg, device.type)
    attn_core = partial(flash_attention, causal=True, window=cfg.attn_window) if cfg.flash else None
    # the fault is read (and consumed) here, when the step is built
    from ddl_tpu_torch.utils import faultinject

    nan_grad_step = faultinject.traced_nan_step()

    def init_state() -> LMTrainState:
        model = TransformerLM(cfg, attn_core)
        init_lm_weights(model, seed)
        model.to(device)
        optimizer = tx(model.parameters())
        if zero_sharding:
            from ddl_tpu_torch.train.fused_optim import with_zero

            # the one-device mesh: a no-op, as JAX's with_zero at data 1
            optimizer = with_zero(optimizer, spec)
        return LMTrainState(step=0, model=model, optimizer=optimizer)

    def loss_fn(model, inputs, targets, step=None):
        kw = dropout_kwargs(seed, step, cfg.dropout_rate)
        if cfg.ce_chunk or cfg.ce_vocab_chunk:
            hidden, aux = model(inputs, return_hidden=True, **kw)
            loss, (_, metrics) = chunked_ce_loss(cfg, hidden, model.lm_head.kernel, targets,
                                                 aux, with_accuracy=step is None)
            return loss, (None, dict(metrics, **moe_router_metrics(model)))
        logits, aux = model(inputs, **kw)
        ce = _token_ce(logits, targets)
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
        state.optimizer.step()
        state.step += 1
        return state, metrics

    def evaluate(state: LMTrainState, inputs, targets) -> dict:
        inputs, targets = inputs.to(device), targets.to(device)
        with torch.inference_mode():
            _, (logits, metrics) = loss_fn(state.model, inputs, targets)
            if logits is None:  # the chunked loss folded the accuracy in
                return metrics
            accuracy = (logits.argmax(-1) == targets).float().mean()
        return dict(metrics, accuracy=accuracy)

    return LMStepFns(train=train, evaluate=evaluate, init_state=init_state, device=device)
