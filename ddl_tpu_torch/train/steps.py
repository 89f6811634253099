"""Step functions (counterpart of ``ddl_tpu/train/steps.py:69-186``).

PyTorch runs eagerly, so a step is a plain function: no jit, no sharding
annotations.  Both steps leave their results on the device and do not
synchronise.  In a data-parallel world (a ``parallel.mesh.Mesh`` of
several ranks) the train step averages the gradients over the ranks in
one all-reduce after the backward (``parallel.mesh.mean_over_data``),
where the JAX package's partitioner inserts the reduction into its one
SPMD program; the BatchNorm statistics are the global batch's
(``models/densenet._batch_stats``), so a DP step equals a one-device step
on the global batch.  Under ZeRO-1 (an ``Optimizer`` with a ZeRO placement,
``train/fused_optim.with_zero``) the gradients' collective is one
reduce-scatter plus the small leaves' all-reduce, and the update ends in
one all-gather of the new parameters.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ddl_tpu_torch.models.convert import jax_param_names
from ddl_tpu_torch.ops import cross_entropy_loss, normalize_images

__all__ = ["make_eval_step", "make_grad_stats_fn", "make_train_step"]


def make_train_step(model: torch.nn.Module, optimizer, compute_dtype: torch.dtype,
                    normalizer: Callable = normalize_images,
                    on_grads: Callable[[], None] | None = None,
                    mesh=None) -> Callable:
    """``train_step(images, labels) -> (loss, preds)``, the JAX package's
    ``train_step``: uint8 (B, H, W, 3) and int labels on the model's
    device -> normalize in the compute dtype -> forward with batch
    statistics (the model must be in training mode) -> mean softmax
    cross-entropy -> backward -> one optimizer update.  The parameters
    and running statistics are updated in place; the f32 loss and the
    argmax predictions stay on the device.  ``on_grads`` (optional) runs
    between the backward and the update, with every ``.grad`` set and not
    yet clipped.

    With a ``mesh`` of several ranks the images and labels are this rank's
    share of the global batch, the model's BatchNorm takes the global
    batch's statistics (``model.data_group = mesh.group``), and the
    gradients are averaged over ``mesh.group`` after the backward, in one
    all-reduce of their concatenation (``mean_over_data``).  The loss is
    this rank's mean; the mean of the ranks' gradients over batches of
    equal size is the gradient of the global batch's mean loss, and
    ``on_grads`` reads the averaged gradients.  Rank 0's parameters and
    buffers are broadcast once, here; no buffer is synchronised again: the
    running statistics move by global batch statistics, which are the same
    on every rank, so they stay equal without it.  The all-reduce's layout
    is the same in every step, so a resumed run is bit-equal to the
    uninterrupted one at any number of ranks (``DistributedDataParallel``,
    which the port used before, rebuilds its buckets after a run's first
    step, so at three ranks or more a resumed run's first step summed some
    gradients in another order).

    Under ZeRO-1 (``optimizer.zero`` set) the gradients are reduced by
    ``optimizer.reduce_scatter_grads`` instead: one reduce-scatter of the
    eligible leaves, the small leaves by ``mean_over_data``; with
    ``on_grads`` the mean shards are all-gathered back into every leaf's
    ``.grad`` first, so it reads whole averaged gradients here too."""
    params = [p for p in model.parameters() if p.requires_grad]
    sync = mesh if mesh is not None and mesh.size > 1 else None
    if sync is not None:
        from ddl_tpu_torch.parallel.mesh import broadcast_from_first, mean_over_data

        model.data_group = mesh.group
        with torch.no_grad():
            broadcast_from_first([*model.parameters(), *model.buffers()], mesh)

    def train_step(images: torch.Tensor, labels: torch.Tensor):
        logits = model(normalizer(images, compute_dtype))
        loss = cross_entropy_loss(logits, labels)
        optimizer.zero_grad()
        loss.backward()
        if sync is not None:
            if getattr(optimizer, "zero", None) is not None:
                optimizer.reduce_scatter_grads(gather=on_grads is not None)
            else:
                with torch.no_grad():
                    mean_over_data([p.grad for p in params], mesh)
        if on_grads is not None:
            on_grads()
        optimizer.step()
        return loss.detach(), logits.detach().argmax(-1)

    return train_step


def make_eval_step(model: torch.nn.Module, compute_dtype: torch.dtype,
                   normalizer: Callable = normalize_images) -> Callable:
    """``eval_step(images) -> logits``: uint8 (B, H, W, 3) on the model's
    device -> normalize in the compute dtype -> forward under
    ``torch.inference_mode()`` -> f32 logits (B, classes), left on the
    device (no synchronisation)."""

    def eval_step(images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(normalizer(images, compute_dtype)).float()

    return eval_step


def make_grad_stats_fn(model: torch.nn.Module, stages: Sequence) -> Callable[[], dict]:
    """``grad_stats() -> {name: (7,) float32}``: min, mean, max, 25th
    percentile, median, 75th percentile and std of |grad| for every
    parameter, computed on the device (the JAX package's
    ``make_grad_stats_fn``, observability parity with the reference's
    ``_log_gradient``, ``ddp.py:310-326``).  Names and order are the JAX
    package's (``models.convert.jax_param_names``).

    It reads the ``.grad`` of the parameters, so it runs as the train
    step's ``on_grads``: the gradients of the step's own loss at the
    state before the update.  The JAX package runs a separate gradient
    pass and drops its batch-statistics update; a second train-mode
    forward here would move the BatchNorm running statistics twice.  Only
    the 7 numbers per parameter are copied to the host (one copy)."""
    names = jax_param_names(model.named_parameters(), stages)
    params = dict(model.named_parameters())

    def grad_stats() -> dict[str, np.ndarray]:
        rows = []
        for key in names:
            a = params[key].grad.detach().float().abs().flatten()
            q = torch.quantile(a, torch.tensor([0.25, 0.5, 0.75], device=a.device))
            rows.append(torch.stack([a.min(), a.mean(), a.max(), q[0], q[1], q[2],
                                     a.std(correction=0)]))
        return dict(zip(names.values(), torch.stack(rows).cpu().numpy()))

    return grad_stats
