"""The LM mesh spec and the flash dispatch rule (own copy of what the
single-device path needs from ``ddl_tpu/parallel/sharding.py``).

``LMMeshSpec`` keeps the JAX fields and defaults so a run's settings
carry over.  The ViT family (``train/vit_steps.py``) takes ``data`` and
``pipe`` above 1; every LM consumer (the step factory, the trainer, the
generator, the serving engine and their entry points) refuses any axis
above 1 through ``require_lm_one_device``: the LM meshes -- tensor,
sequence, expert and pipeline parallelism -- are ROADMAP item 11.
``resolve_auto_flash`` and ``normalize_flash`` resolve
``LMConfig.flash == "auto"`` for one device against the port's one
``FLASH_AUTO_MIN_T`` (``ops/flash_attention.py``), which serves training,
the decode prefill and serving alike, as the JAX package's one threshold
does.
"""

from __future__ import annotations

import dataclasses

from ddl_tpu_torch.ops.flash_attention import FLASH_AUTO_MIN_T, flash_kernel_takes

__all__ = ["FLASH_AUTO_MIN_T", "LMMeshSpec", "normalize_flash", "require_lm_one_device",
           "resolve_auto_flash"]


@dataclasses.dataclass(frozen=True)
class LMMeshSpec:
    """The JAX 5-axis mesh spec (fields ``data, seq, model, expert, pipe``,
    all 1 by default); an axis below 1 raises.  Which axes above 1 a
    consumer takes is the consumer's to say."""

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


def require_lm_one_device(spec: LMMeshSpec | None, what: str) -> None:
    """Refuse, for the LM consumer ``what``, a ``spec`` with any axis above
    1 (None is the one-device spec): LM parallelism is ROADMAP item 11."""
    for f in dataclasses.fields(LMMeshSpec):
        n = 1 if spec is None else getattr(spec, f.name)
        if n > 1:
            raise NotImplementedError(
                f"{what}: mesh axis {f.name}={n}: the port runs the LM on one device; LM "
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
