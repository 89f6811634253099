"""The LM mesh spec and the flash dispatch rule (own copy of what the
single-device path needs from ``ddl_tpu/parallel/sharding.py``).

The port trains on one device: ``LMMeshSpec`` keeps the JAX fields and
defaults so a run's settings carry over, and any axis above 1 raises (the
meshes -- tensor, sequence, expert and pipeline parallelism -- are ROADMAP
item 11).  ``resolve_auto_flash`` and ``normalize_flash`` resolve
``LMConfig.flash == "auto"`` for one device against the port's one
``FLASH_AUTO_MIN_T`` (``ops/flash_attention.py``), which serves training,
the decode prefill and serving alike, as the JAX package's one threshold
does.
"""

from __future__ import annotations

import dataclasses

from ddl_tpu_torch.ops.flash_attention import FLASH_AUTO_MIN_T, flash_kernel_takes

__all__ = ["FLASH_AUTO_MIN_T", "LMMeshSpec", "normalize_flash", "resolve_auto_flash"]


@dataclasses.dataclass(frozen=True)
class LMMeshSpec:
    """The JAX 5-axis mesh spec (fields ``data, seq, model, expert, pipe``,
    all 1 by default).  One device only: an axis above 1 raises."""

    data: int = 1
    seq: int = 1
    model: int = 1
    expert: int = 1
    pipe: int = 1

    def __post_init__(self):
        for f in dataclasses.fields(self):
            n = getattr(self, f.name)
            if n < 1:
                raise ValueError(f"mesh axis {f.name} must be >= 1, got {n}")
            if n > 1:
                raise NotImplementedError(
                    f"mesh axis {f.name}={n}: the port trains on one device; LM "
                    "parallelism is ROADMAP item 11"
                )


def resolve_auto_flash(cfg, spec: LMMeshSpec, seq_len: int,
                       device_type: str | None = None) -> bool:
    """``flash="auto"`` on one device: the kernel for a causal model from
    ``FLASH_AUTO_MIN_T`` positions on, where the kernel takes the config's
    head_dim and dtype on ``device_type`` (``flash_kernel_takes``; the JAX
    rule's "supported").  (The JAX rule's mesh cases -- a sharded
    sequence, heads over ``model``, ring and Ulysses -- all reduce to this
    with every axis at 1.)"""
    if not cfg.causal:
        return False
    return seq_len >= FLASH_AUTO_MIN_T and flash_kernel_takes(cfg.head_dim, cfg.dtype,
                                                              device_type)


def normalize_flash(cfg, spec: LMMeshSpec, seq_len: int, device_type: str | None = None):
    """``cfg`` with ``flash`` resolved to a bool for ``device_type``, so no
    later check sees ``"auto"``, and a stray string like ``flash='off'``
    fails loudly instead of being truthy."""
    if cfg.flash == "auto":
        return dataclasses.replace(cfg, flash=resolve_auto_flash(cfg, spec, seq_len,
                                                                 device_type))
    if isinstance(cfg.flash, str):
        raise ValueError(f"flash must be True, False, or 'auto'; got {cfg.flash!r}")
    return cfg
