"""Device-memory observability (counterpart of ``ddl_tpu/utils/memory.py``).

``hbm_stats`` gives the JAX package's keys from the CUDA caching
allocator's counters, so the period events and CSV rows of both packages
carry the same fields.  Off a GPU it gives None, as the JAX package does
on a backend without memory stats.
"""

from __future__ import annotations

__all__ = ["hbm_stats"]


def hbm_stats(device=None) -> dict | None:
    """``{bytes_in_use, peak_bytes_in_use, bytes_limit}`` for ``device``
    (default: the current CUDA device), or None off a GPU.  In use and
    peak are the allocator's allocated bytes (``allocated_bytes.all``);
    the limit is the card's total memory."""
    # imported here: the supervisor process writes obs events without torch
    import torch

    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(device).total_memory),
    }
