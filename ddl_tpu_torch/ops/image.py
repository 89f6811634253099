"""On-device image preprocessing (counterpart of ``ddl_tpu/ops/image.py``).

Batches travel host -> device as raw uint8 NHWC and are normalised on the
device, so the link carries 4x fewer bytes than float32.
"""

from __future__ import annotations

import torch

__all__ = ["normalize_images"]


def normalize_images(images: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 HWC images -> [0,1] float in the compute dtype (divides by 255
    in that dtype, as the JAX default path does)."""
    return images.to(dtype) / torch.tensor(255.0, dtype=dtype, device=images.device)
