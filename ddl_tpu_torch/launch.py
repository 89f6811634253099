"""Launch helpers for one process (the one-process half of
``ddl_tpu/launch.py``).

The port trains on one GPU in one process, so ``bootstrap()`` has no world
to join: it returns at once, and refuses a launch that asks for several
processes (``DDL_COORDINATOR``, ``DDL_NUM_PROCESSES`` above 1 or
``DDL_MULTIHOST=1``), since the multi-process launcher is ROADMAP item 7.
``world_info`` gives the JAX package's keys, filled from torch.
"""

from __future__ import annotations

import os

import torch

from ddl_tpu_torch.obs.events import host_id

__all__ = ["bootstrap", "host_id", "restart_epoch", "world_info"]


def restart_epoch() -> int:
    """The pod restart epoch this process was launched under
    (``DDL_RESTART_EPOCH``; 0 for the first launch and every run outside
    a pod)."""
    try:
        return int(os.environ.get("DDL_RESTART_EPOCH") or 0)
    except ValueError:
        return 0


def bootstrap() -> None:
    """A no-op for one process; raises ``NotImplementedError`` when the
    environment asks for a multi-process world.  Set-but-empty variables
    count as unset, as in the JAX package."""
    asks = []
    if os.environ.get("DDL_COORDINATOR"):
        asks.append(f"DDL_COORDINATOR={os.environ['DDL_COORDINATOR']}")
    if int(os.environ.get("DDL_NUM_PROCESSES") or 1) > 1:
        asks.append(f"DDL_NUM_PROCESSES={os.environ['DDL_NUM_PROCESSES']}")
    if os.environ.get("DDL_MULTIHOST") == "1":
        asks.append("DDL_MULTIHOST=1")
    if asks:
        raise NotImplementedError(
            f"{', '.join(asks)}: the port runs one process; the multi-process "
            "launcher is ROADMAP item 7"
        )


def world_info(device=None) -> dict:
    """Rank, world and device of this process, under the JAX package's
    keys; ``device`` is the torch device the run uses (default CUDA)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        index = torch.cuda.current_device() if device.index is None else device.index
        local = [f"cuda:{index} ({torch.cuda.get_device_name(index)})"]
        platform, count = "gpu", torch.cuda.device_count()
    else:
        local, platform, count = [str(device)], "cpu", 1
    return {
        "process_index": 0,
        "process_count": 1,
        "host_id": host_id(),
        "restart_epoch": restart_epoch(),
        "local_devices": local,
        "global_device_count": count,
        "platform": platform,
    }
