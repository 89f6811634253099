"""The LM mesh spec, its checks and the flash dispatch rule (own copy of
what the port needs from ``ddl_tpu/parallel/sharding.py``).

``LMMeshSpec`` keeps the JAX fields, defaults, ``num_devices`` and
``axis_names`` so a run's settings carry over.  The ViT family
(``train/vit_steps.py``) takes ``data``, ``pipe`` and ``model`` above 1;
the LM's training consumers (the step factory, the trainer, ``train_lm``)
take ``data``, ``pipe``, ``seq`` and ``model`` in any combination and
refuse ``expert`` through ``require_lm_train_axes``, naming ROADMAP item
11c; the decode and serving consumers (the generator, the serving engine
and their entry points) refuse any axis above 1 through
``require_lm_one_device``: the sharded decode is the rest of ROADMAP item
11b.

``resolve_auto_flash`` and ``normalize_flash`` resolve ``LMConfig.flash
== "auto"`` against the port's ``FLASH_AUTO_MIN_T`` (``ops/
flash_attention.py``; training, the decode prefill and serving alike, as
the JAX package's one threshold) and, for the ring's per-device blocks,
``FLASH_AUTO_MIN_T_LOCAL_RING``.
"""

from __future__ import annotations

import dataclasses

from ddl_tpu_torch.ops.flash_attention import FLASH_AUTO_MIN_T, flash_kernel_takes

__all__ = [
    "FLASH_AUTO_MIN_T",
    "FLASH_AUTO_MIN_T_LOCAL_RING",
    "LMMeshSpec",
    "normalize_flash",
    "require_lm_one_device",
    "require_lm_train_axes",
    "require_model_split",
    "require_no_fsdp",
    "resolve_auto_flash",
    "validate_kv_head_sharding",
    "validate_ulysses_kv_heads",
]

# The ring's crossover on the per-device shard: each hop is one T_local x
# T_local block, and flash="auto" takes the kernels inside the ring from
# this T_local on.  Set from chip_smoke.py phase 15's per-hop sweep on one
# H100 80GB HBM3 (700 W): one hop's forward and backward through kernels
# #4-#6 (causal=False, the 124M's 12 heads over 4 K/V heads, batch 1)
# against the dense block of ``parallel/ring_attention._block_attention``
# and its autograd backward, T_local 256-4096; the kernels' device time is
# below the dense block's at every T_local of the sweep, so the threshold
# is the sweep's first, as ``FLASH_AUTO_MIN_T``'s is.  Shorter blocks were
# not measured and stay dense.
FLASH_AUTO_MIN_T_LOCAL_RING = 256



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

    @property
    def num_devices(self) -> int:
        return self.data * self.pipe * self.seq * self.model * self.expert

    @property
    def axis_names(self) -> tuple[str, ...]:
        return ("data", "pipe", "seq", "model", "expert")


def require_lm_one_device(spec: LMMeshSpec | None, what: str) -> None:
    """Refuse, for the LM decode or serving consumer ``what``, a ``spec``
    with any axis above 1 (None is the one-device spec): the sharded
    decode and serving are the rest of ROADMAP item 11b."""
    for f in dataclasses.fields(LMMeshSpec):
        n = 1 if spec is None else getattr(spec, f.name)
        if n > 1:
            raise NotImplementedError(
                f"{what}: mesh axis {f.name}={n}: the port decodes and serves the LM on one "
                "device; the sharded decode is ROADMAP item 11b (its decode and serving "
                "half)")


def require_lm_train_axes(spec: LMMeshSpec | None, what: str) -> None:
    """Refuse, for the LM training consumer ``what``, a ``spec`` the port
    cannot train over: it takes ``data``, ``pipe``, ``seq`` and ``model``;
    ``expert`` above 1 raises ``NotImplementedError`` (ROADMAP item
    11c)."""
    if spec is not None and spec.expert > 1:
        raise NotImplementedError(
            f"{what}: mesh axis expert={spec.expert}: the port trains the LM over data x "
            "pipe x seq x model; expert is ROADMAP item 11c (expert parallelism)")


def require_no_fsdp(cfg, spec, what: str) -> None:
    """Refuse ``cfg.fsdp`` over a data axis above 1 (``NotImplementedError``):
    the port does not shard the embed dimension over ``data`` yet (ROADMAP
    item 11b, FSDP), and a replicated run in its place would hide that.  On
    one data rank it is a no-op, as a size-1 axis shards nothing in JAX."""
    if getattr(cfg, "fsdp", False) and spec is not None and spec.data > 1:
        raise NotImplementedError(
            f"{what}: fsdp=True over mesh data={spec.data}: the port does not shard the "
            "embed dimension over data yet; FSDP is ROADMAP item 11b (FSDP)")


def require_model_split(cfg, spec: LMMeshSpec) -> None:
    """The port's tensor parallelism splits heads, K/V heads and the MLP
    hidden evenly over ``model`` (JAX's GSPMD pads an uneven split; the
    port does not: ROADMAP lists it)."""
    if spec.model <= 1:
        return
    for name, n in (("n_heads", cfg.n_heads), ("n_kv_heads", cfg.kv_heads), ("d_ff", cfg.d_ff)):
        if n % spec.model:
            raise ValueError(
                f"{name} {n} must divide by mesh model={spec.model}: the port's tensor "
                "parallelism splits it evenly (JAX pads the split; ROADMAP lists the gap)")


def validate_ulysses_kv_heads(cfg, spec: LMMeshSpec) -> None:
    """Grouped-query Ulysses: the head/sequence all-to-all exchanges K/V at
    Hkv heads, so the model-local K/V head count must split over ``seq``."""
    if cfg.kv_heads != cfg.n_heads and (cfg.kv_heads // spec.model) % spec.seq:
        raise ValueError(
            f"local K/V head count {cfg.kv_heads // spec.model} "
            f"(n_kv_heads/model) must divide by mesh seq={spec.seq} for "
            "grouped-query Ulysses (the all-to-all exchanges K/V at Hkv "
            "heads; use attn_impl='ring' otherwise)"
        )


def validate_kv_head_sharding(cfg, spec: LMMeshSpec) -> None:
    """Grouped-query attention under tensor parallelism: every model-axis
    shard must hold whole K/V heads."""
    if spec.model > 1 and cfg.kv_heads % spec.model:
        raise ValueError(
            f"n_kv_heads {cfg.kv_heads} must divide by mesh "
            f"model={spec.model} (each shard must hold whole K/V heads)"
        )


def resolve_auto_flash(cfg, spec: LMMeshSpec, seq_len: int,
                       device_type: str | None = None) -> bool:
    """``flash="auto"``: the kernels for a causal model where they can see
    what they attend and were measured faster, and where they take the
    config's head_dim and dtype on ``device_type`` (``flash_kernel_takes``;
    the JAX rule's "supported").  Dense with a sharded sequence stays dense
    (the kernel would see one shard's keys), as do Ulysses' local heads
    that do not split over ``seq``; Ulysses attends the whole sequence per
    head group, so the global ``seq_len`` is its scale; the ring attends
    ``seq_len / seq``-long blocks per hop, against
    ``FLASH_AUTO_MIN_T_LOCAL_RING`` (a one-rank ring is one diagonal hop,
    the dense path's regime)."""
    if not cfg.causal or not flash_kernel_takes(cfg.head_dim, cfg.dtype, device_type):
        return False
    if cfg.attn_impl == "dense" and spec.seq > 1:
        return False
    if cfg.n_heads % spec.model:
        return False
    if cfg.attn_impl == "ulysses" and (cfg.n_heads // spec.model) % spec.seq:
        return False
    if cfg.attn_impl == "ring" and spec.seq > 1:
        return seq_len // spec.seq >= FLASH_AUTO_MIN_T_LOCAL_RING
    return seq_len >= FLASH_AUTO_MIN_T


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
