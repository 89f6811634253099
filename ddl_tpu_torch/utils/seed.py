"""Reproducibility helper (counterpart of ``ddl_tpu/utils/seed.py``).

The reference defines (but leaves commented out) a ``set_seed`` touching
python/numpy/torch RNGs (``single.py:28-35``).  The JAX package seeds the
host RNGs and returns its root ``jax.random`` key; here the root generator
is torch's own, seeded on the host and on every CUDA device.
"""

from __future__ import annotations

import random

import numpy as np
import torch

__all__ = ["set_seed"]


def set_seed(seed: int) -> torch.Generator:
    """Seed the python, numpy and torch RNGs; returns torch's default
    generator (``torch.manual_seed`` also seeds every CUDA device)."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.manual_seed(seed)
