"""The device fence timings stand on (counterpart of
``ddl_tpu/utils/timing.py``).

PyTorch returns from a CUDA call before the card has run it, so a host
clock around eager calls measures the enqueue; ``fence`` waits for the
card.  On the CPU every call has finished when it returns, and ``fence``
does nothing.
"""

from __future__ import annotations

import torch

__all__ = ["fence"]


def fence(device=None) -> None:
    """Wait until the work queued on ``device`` (default: the current
    CUDA device) has run; a no-op for a CPU device or without CUDA."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type == "cuda" and torch.cuda.is_available():
        torch.cuda.synchronize(device)
