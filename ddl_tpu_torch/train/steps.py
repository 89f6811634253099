"""Step functions (counterpart of ``ddl_tpu/train/steps.py:96-101``).

Only the eval step is ported; the train step comes with the training
slice.  PyTorch runs eagerly, so the step is a plain function: no jit, no
sharding annotations (one device).
"""

from __future__ import annotations

from typing import Callable

import torch

from ddl_tpu_torch.ops import normalize_images

__all__ = ["make_eval_step"]


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
