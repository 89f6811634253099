"""Step functions (counterpart of ``ddl_tpu/train/steps.py:69-101``).

PyTorch runs eagerly, so a step is a plain function: no jit, no sharding
annotations (one device).  Both steps leave their results on the device
and do not synchronise.
"""

from __future__ import annotations

from typing import Callable

import torch

from ddl_tpu_torch.ops import cross_entropy_loss, normalize_images

__all__ = ["make_eval_step", "make_train_step"]


def make_train_step(model: torch.nn.Module, optimizer, compute_dtype: torch.dtype,
                    normalizer: Callable = normalize_images) -> Callable:
    """``train_step(images, labels) -> (loss, preds)``, the JAX package's
    ``train_step``: uint8 (B, H, W, 3) and int labels on the model's
    device -> normalize in the compute dtype -> forward with batch
    statistics (the model must be in training mode) -> mean softmax
    cross-entropy -> backward -> one optimizer update.  The parameters
    and running statistics are updated in place; the f32 loss and the
    argmax predictions stay on the device."""

    def train_step(images: torch.Tensor, labels: torch.Tensor):
        logits = model(normalizer(images, compute_dtype))
        loss = cross_entropy_loss(logits, labels)
        optimizer.zero_grad()
        loss.backward()
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
