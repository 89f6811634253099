"""Step functions (counterpart of ``ddl_tpu/train/steps.py:69-186``).

PyTorch runs eagerly, so a step is a plain function: no jit, no sharding
annotations (one device).  Both steps leave their results on the device
and do not synchronise.
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
                    on_grads: Callable[[], None] | None = None) -> Callable:
    """``train_step(images, labels) -> (loss, preds)``, the JAX package's
    ``train_step``: uint8 (B, H, W, 3) and int labels on the model's
    device -> normalize in the compute dtype -> forward with batch
    statistics (the model must be in training mode) -> mean softmax
    cross-entropy -> backward -> one optimizer update.  The parameters
    and running statistics are updated in place; the f32 loss and the
    argmax predictions stay on the device.  ``on_grads`` (optional) runs
    between the backward and the update, with every ``.grad`` set and not
    yet clipped."""

    def train_step(images: torch.Tensor, labels: torch.Tensor):
        logits = model(normalizer(images, compute_dtype))
        loss = cross_entropy_loss(logits, labels)
        optimizer.zero_grad()
        loss.backward()
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
