"""Train and eval steps for the ViT family (counterpart of
``ddl_tpu/train/vit_steps.py``).

The JAX factory builds one jitted SPMD program over a ``(data, model,
pipe)`` mesh.  Here a step is a plain function run by each rank of a
``parallel.mesh`` world (one process: one device), on that rank's rows
of the global batch (rank ``(d, p)`` holds data row ``d``'s contiguous
``batch / data`` rows, on every stage of the row).  The uint8 batch is
normalized with the plain ``normalize_images``, as in the JAX package
(the ViT takes no Pallas normalize), and the blocks take the dense
attention core (no flash: T = N patches, bidirectional).

* Flat (``spec.pipe == 1``): the forward (dropout seeded per (seed, step,
  layer), every block rematerialised per ``cfg.remat_policy``), the mean
  cross-entropy, the backward, then over ``data`` ranks one all-reduce of
  every gradient and the metrics (``parallel.mesh.mean_over_data``: the
  ViT has no BatchNorm, so that is the whole of data parallelism), one
  update.  ``accum_steps`` splits the rows into equal chunks
  (``train/lm_steps.accumulate_grads``, dropout streams ``step * k + i``).
  ``zero_sharding`` attaches ZeRO-1 (``train/fused_optim.with_zero``: one
  reduce-scatter, Adam on this rank's shard, one all-gather; a no-op at
  ``data`` 1); it takes the plain fused Adam only, as the JAX example's
  ``--zero`` does.
* Pipelined (``spec.pipe > 1``): rank ``(d, s)`` holds stage ``s``
  (``models.vit.ViT(cfg, stage=s, ...)``) and runs the schedule's clock
  (``parallel/lm_pipeline.BlocksPipeline``: gpipe, 1f1b, zb, and the
  interleaved ``virtual_stages > 1``) inside the step the LM's pipeline
  shares (``parallel/lm_pipeline.PipelinedSteps``: stage 0 embeds the
  whole batch and backpropagates the microbatches' cotangents in one
  backward, the dropout key of each step and data row, the averages over
  ``data``, the clip norm summed over the stages, the metrics sent to
  every stage of the row).  The last stage runs ``norm_f``, the pool, the
  head and each microbatch's cross-entropy over M.

* Tensor parallel (``spec.model > 1``, flat or pipelined): each rank of
  a ``(data, pipe, model)`` world (``parallel.mesh.build_lm_mesh``) holds
  its part of the blocks (the LM's ``Block``: column-parallel Q/K/V and
  ``wi``, row-parallel ``out`` and ``wo``), cut from the whole model's
  draw (``models/convert.shard_vit_state``); the embeddings and the head
  replicate (``parallel/rules.vit_rules``).  The gradients are averaged
  over ``data`` alone, and the clip norm sums the blocks' squares over
  ``model``.

The ``nan@grad:K`` fault (``faultinject.traced_nan_step``) is read when
the factory builds, as the LM step's.  Every argument check of the JAX
factory is kept with its message; ``fsdp`` over a data axis above 1
raises ``NotImplementedError`` (ROADMAP item 11b, FSDP).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple

import torch

from ddl_tpu_torch.models.transformer import remat_block
from ddl_tpu_torch.models.vit import ViT, ViTConfig, init_vit_weights
from ddl_tpu_torch.ops import cross_entropy_loss, normalize_images
from ddl_tpu_torch.parallel.lm_pipeline import SCHEDULES, PipelinedSteps
from ddl_tpu_torch.parallel.mesh import build_lm_mesh, mean_over_data
from ddl_tpu_torch.parallel.rules import vit_rules
from ddl_tpu_torch.parallel.sharding import (
    LMMeshSpec,
    require_model_split,
    require_no_fsdp,
    validate_kv_head_sharding,
)
from ddl_tpu_torch.train.lm_steps import (
    accumulate_grads,
    attach_model_norm,
    dropout_kwargs,
    init_sharded_model,
    model_shard,
    poison_nan_grads,
    zero_specs,
)

__all__ = ["ViTStepFns", "ViTTrainState", "make_vit_step_fns"]


@dataclasses.dataclass
class ViTTrainState:
    """The optimizer step count, the model (this rank's stage when
    pipelined; f32 master weights on the device) and its optimizer.
    ``train`` updates all three in place and returns the same object."""

    step: int
    model: ViT
    optimizer: object


class ViTStepFns(NamedTuple):
    """train(state, images_u8, labels) -> (state, metrics);
    evaluate(state, images_u8) -> f32 logits (this data row's, on every
    stage); init_state() -> a fresh ViTTrainState; mesh: this rank's
    ``parallel.mesh.Mesh`` (its ``device`` is where it all runs)."""

    train: Callable
    evaluate: Callable
    init_state: Callable
    mesh: object


def _accuracy(logits, labels):
    return (logits.argmax(-1) == labels).float().mean()


def make_vit_step_fns(
    cfg: ViTConfig,
    spec: LMMeshSpec,
    tx: Callable,
    seed: int,
    batch: int,
    device=None,
    num_microbatches: int = 0,
    accum_steps: int = 1,
    pipeline_schedule: str = "gpipe",
    virtual_stages: int = 1,
    zero_sharding: bool = False,
    mesh=None,
) -> ViTStepFns:
    """The step functions of this rank of a ``(data, pipe, model)`` world.

    ``tx(params) -> Optimizer`` builds the optimizer
    (``train.state.Optimizer``); ``seed`` seeds the weights
    (``init_vit_weights``, every rank the whole model's, each stage then
    keeping its part) and the dropout streams; ``batch`` is the global
    batch.  ``device=None`` means CUDA (``cuda:<local rank>`` in a world
    of several ranks) and raises without it; ``mesh`` (the
    ``parallel.mesh.LMMesh`` of ``spec``: a ValueError otherwise) defaults
    to ``build_lm_mesh(spec)`` over the world."""
    if spec.seq > 1 or spec.expert > 1:
        raise ValueError(
            "ViT steps shard over (data, model, pipe); got "
            f"seq={spec.seq} expert={spec.expert}"
        )
    validate_kv_head_sharding(cfg.block_config(), spec)
    require_no_fsdp(cfg, spec, "make_vit_step_fns")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if pipeline_schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {pipeline_schedule!r}")
    if spec.pipe > 1:
        if accum_steps > 1:
            raise ValueError(
                "accum_steps > 1 is the non-pipelined path's microbatching; "
                "with spec.pipe > 1 use num_microbatches instead"
            )
        if zero_sharding:
            raise ValueError(
                "zero_sharding requires the flat (non-pipelined) ViT "
                "step (the pipeline optimizer runs inside a manual "
                "shard_map region)"
            )
        _check_pipeline(cfg, spec, batch, num_microbatches or spec.pipe, pipeline_schedule,
                        virtual_stages)
    else:
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
            raise ValueError("num_microbatches needs spec.pipe > 1")
        if accum_steps > 1 and (batch % accum_steps or (batch // accum_steps) % spec.data):
            raise ValueError(
                f"batch {batch} must split into accum_steps={accum_steps} chunks "
                f"divisible by mesh data={spec.data}"
            )
        if batch % spec.data:
            raise ValueError(f"batch {batch} must divide by mesh data={spec.data}")
    require_model_split(cfg.block_config(), spec)
    if mesh is None:
        mesh = build_lm_mesh(spec, device)
    tp = model_shard(mesh, spec)
    # the fault is read (and consumed) here, when the step is built
    from ddl_tpu_torch.utils import faultinject

    nan_grad_step = faultinject.traced_nan_step()
    if spec.pipe > 1:
        return _pipeline_step_fns(cfg, tx, seed, mesh, tp, num_microbatches or spec.pipe,
                                  pipeline_schedule, virtual_stages, nan_grad_step)
    return _flat_step_fns(cfg, tx, seed, mesh, tp, accum_steps, zero_sharding, nan_grad_step)


def _check_pipeline(cfg, spec, batch, M, schedule, V) -> None:
    """The JAX pipeline factory's checks, with its messages."""
    n_stages = spec.pipe
    if V < 1:
        raise ValueError(f"virtual_stages must be >= 1, got {V}")
    if schedule == "zb" and V > 1:
        raise ValueError(
            f"virtual_stages={V} requires schedule='gpipe' or '1f1b' "
            "(the zero-bubble B/W-split clock loop is single-chunk)"
        )
    if V > 1 and M % n_stages:
        raise ValueError(
            f"num_microbatches {M} % pipe {n_stages} != 0 (the interleaved "
            "schedule advances microbatches in groups of pipe)"
        )
    if M < 1:
        raise ValueError(f"num_microbatches must be >= 1, got {M}")
    if cfg.n_layers % (n_stages * V):
        raise ValueError(f"n_layers {cfg.n_layers} % (pipe {n_stages} * virtual {V}) != 0")
    if batch % M:
        raise ValueError(f"batch {batch} % microbatches {M} != 0")
    if (batch // M) % spec.data:
        raise ValueError(f"microbatch {batch // M} % mesh data={spec.data} != 0")


def _init_model(cfg: ViTConfig, seed: int, mesh, tp, stage: ViT | None = None) -> ViT:
    """The whole model from ``seed``, or ``stage`` (this rank's stage or
    tensor-parallel part) loaded with its part of it; on the mesh's
    device."""
    from ddl_tpu_torch.models.convert import shard_vit_state

    model = ViT(cfg)
    init_vit_weights(model, seed)
    if stage is not None:
        init_sharded_model(stage, model, tp, shard_vit_state)
        model = stage
    return model.to(mesh.device)


def _optimizer(tx, model, tp):
    return attach_model_norm(tx(model.parameters()), model, tp, vit_rules())


def _flat_step_fns(cfg, tx, seed, mesh, tp, accum_steps, zero_sharding, nan_grad_step):
    device, sync = mesh.device, mesh.size > 1

    def init_state() -> ViTTrainState:
        model = _init_model(cfg, seed, mesh, tp, ViT(cfg, tp=tp) if tp else None)
        optimizer = _optimizer(tx, model, tp)
        if zero_sharding:
            from ddl_tpu_torch.train.fused_optim import with_zero

            optimizer = with_zero(optimizer, mesh,
                                  specs=zero_specs(model, vit_rules(), tp) if tp else None)
        return ViTTrainState(step=0, model=model, optimizer=optimizer)

    def loss_fn(model, images, labels, step=None):
        kw = dropout_kwargs(seed, step, cfg.dropout_rate)
        logits = model(normalize_images(images, cfg.dtype), **kw)
        loss = cross_entropy_loss(logits, labels)
        return loss, (logits, {"loss": loss, "accuracy": _accuracy(logits, labels)})

    def train(state: ViTTrainState, images, labels):
        model, opt = state.model, state.optimizer
        images, labels = images.to(device), labels.to(device)
        model.train()
        opt.zero_grad()
        if accum_steps == 1:
            loss, (_, m) = loss_fn(model, images, labels, state.step)
            loss.backward()
            metrics = {k: v.detach() for k, v in m.items()}
        else:
            k = accum_steps
            steps = [state.step * k + i for i in range(k)]
            metrics = accumulate_grads(partial(loss_fn, model),
                                       (images.chunk(k), labels.chunk(k), steps), k)
        params = [p for p in model.parameters() if p.grad is not None]
        poison_nan_grads(state.step, params, nan_grad_step)
        if sync:
            with torch.no_grad():
                if getattr(opt, "zero", None) is not None:
                    opt.reduce_scatter_grads()
                    mean_over_data(list(metrics.values()), mesh)
                else:
                    mean_over_data([p.grad for p in params] + list(metrics.values()), mesh)
        opt.step()
        state.step += 1
        return state, metrics

    def evaluate(state: ViTTrainState, images):
        state.model.eval()
        with torch.inference_mode():
            return state.model(normalize_images(images.to(device), cfg.dtype)).float()

    return ViTStepFns(train=train, evaluate=evaluate, init_state=init_state, mesh=mesh)


def _pipeline_step_fns(cfg, tx, seed, mesh, tp, M, schedule, V, nan_grad_step):
    device, P, s = mesh.device, mesh.spec.pipe, mesh.pipe_index
    steps = PipelinedSteps(mesh, cfg.n_layers, remat_block(cfg.block_config()),
                           schedule=schedule, num_microbatches=M, virtual=V, dtype=cfg.dtype,
                           remat=cfg.remat, seed=seed, dropout=cfg.dropout_rate > 0.0,
                           nan_grad_step=nan_grad_step)
    at = dict(positions=cfg.num_patches, width=cfg.d_model)

    def init_state() -> ViTTrainState:
        model = _init_model(cfg, seed, mesh, tp, ViT(cfg, stage=s, stages=P, virtual=V, tp=tp))
        return ViTTrainState(step=0, model=model,
                             optimizer=steps.attach(_optimizer(tx, model, tp)))

    def embed_of(stage):
        return lambda images: stage.embed(normalize_images(images, cfg.dtype))

    def train(state: ViTTrainState, images, labels):
        stage = state.model
        images, labels = images.to(device), labels.to(device)
        stage.train()

        def loss(y, lab):
            logits = stage.pool_logits(y)
            ce = cross_entropy_loss(logits, lab)
            return ce, torch.stack([ce.detach(), _accuracy(logits, lab)])

        met = steps.train(state, images, labels, embed=embed_of(stage), loss=loss, n_metrics=2,
                          **at)
        return state, {"loss": met[0], "accuracy": met[1]}

    def evaluate(state: ViTTrainState, images):
        stage = state.model
        images = images.to(device)
        stage.eval()
        outs = steps.forward(stage, images, embed=embed_of(stage),
                             tail=lambda y, m: stage.pool_logits(y), **at)
        with torch.no_grad():
            logits = (torch.cat(outs) if outs is not None else
                      torch.empty((images.shape[0], cfg.num_classes), device=device))
            return steps.broadcast(logits)

    return ViTStepFns(train=train, evaluate=evaluate, init_state=init_state, mesh=mesh)
