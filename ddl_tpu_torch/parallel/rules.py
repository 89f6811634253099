"""Partition rule tables, ZeRO-1 eligibility and the optimizer's per-device
bytes (own copy of what the port needs from ``ddl_tpu/parallel/rules.py``:
``UnmatchedLeafError``, ``RuleTable``, ``match_partition_rules``,
``match_with_provenance`` (``:131-285``), the four family tables,
``spec_axes``, ``spec_num_shards`` (``:288-405``), ``ZERO_THRESHOLD``
(``:94``), ``zero_shard_spec`` (``:405-436``) and ``optimizer_hbm_bytes``
(``:499-533``)).

A table is an ordered list of ``(regex, PartitionSpec)`` rules matched
against each leaf's name, first match wins; a leaf of one element
replicates without consulting it, and a leaf no rule matches raises
``UnmatchedLeafError`` under ``strict``.  The port's names are its own
``state_dict`` keys, ``.``-joined (``block0.attn.q.kernel``), and its
layouts: the transformer's ``QDense`` kernels keep flax's ``(in, out)``
layout and the embedding and head kernels flax's ``(vocab, d_model)``, so
their rules shard the same dimension as JAX's; where a layout differs,
the rule names the port's dimension (the ViT's patchify convolution is a
torch ``(O, I, kh, kw)`` kernel, JAX's an ``(kh, kw, I, O)`` one, so its
embed dimension is the first here).  ``re.search`` matches anywhere in a
name, so a whole state tree whose Adam moments are named after their
parameter (``exp_avg.block0.attn.q.kernel``) takes the parameters'
placement under ``strict=False``, its counts replicating.

``PartitionSpec`` is the port's own: one entry per leading dimension, an
axis name, a tuple of names, or None (unsharded).

ZeRO-1 (``train/fused_optim.py``): a parameter leaf at or above
``ZERO_THRESHOLD`` elements keeps its moments on a 1/dp shard of the first
dimension its spec leaves unsharded and the data axis divides.  torch's
conv kernel holds the dimensions of JAX's, permuted, so the same leaves
are eligible; the dimension chosen may differ, which changes nothing, as
Adam is elementwise and snapshots keep the full layout.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Iterable, Mapping, Sequence

__all__ = [
    "PartitionSpec",
    "RuleTable",
    "UnmatchedLeafError",
    "ZERO_THRESHOLD",
    "cnn_rules",
    "decode_rules",
    "lm_rules",
    "match_partition_rules",
    "match_with_provenance",
    "optimizer_hbm_bytes",
    "spec_axes",
    "spec_num_shards",
    "vit_rules",
    "zero_shard_spec",
]

# Parameter leaves at or above this many elements get their optimizer
# state ZeRO-sharded over 'data' (below it the all-gather latency costs
# more than the replicated bytes).
ZERO_THRESHOLD = 8192


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: per leading dimension an axis name,
    a tuple of axis names, or None; trailing dimensions unsharded."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


class UnmatchedLeafError(ValueError):
    """A leaf of more than one element matched no rule; carries the names."""

    def __init__(self, family: str, paths: list[str]) -> None:
        self.family = family
        self.paths = list(paths)
        listed = ", ".join(self.paths[:8])
        more = f" (+{len(self.paths) - 8} more)" if len(self.paths) > 8 else ""
        super().__init__(
            f"no partition rule in the {family!r} table matches leaf path(s) "
            f"{listed}{more}; every parameter must be placed explicitly "
            "(add a rule to parallel/rules.py — P() for deliberate "
            "replication)"
        )


@dataclasses.dataclass(frozen=True)
class RuleTable:
    """One model family's parameter placement, as data."""

    family: str
    rules: tuple[tuple[str, PartitionSpec], ...]

    def specs(self, tree: Mapping, *, strict: bool = True) -> dict:
        return match_partition_rules(self, tree, strict=strict)

    def provenance(self, tree: Mapping, *, strict: bool = True) -> list:
        return match_with_provenance(self, tree, strict=strict)


def _leaf_size(leaf) -> int:
    shape = getattr(leaf, "shape", None)
    if shape is None:
        return 1
    return math.prod(shape) if len(shape) else 1


def match_with_provenance(rules, tree: Mapping, *, strict: bool = True) -> list:
    """``[(name, leaf, spec, pattern), ...]`` over the flat ``tree`` (a
    ``state_dict``-like mapping of names to tensors or arrays), in its
    order; ``pattern`` is the matched rule's regex, None for a leaf of one
    element or an unmatched one under ``strict=False``."""
    family = getattr(rules, "family", "<anonymous>")
    rules = getattr(rules, "rules", rules)
    out, unmatched = [], []
    for name, leaf in tree.items():
        if _leaf_size(leaf) <= 1:
            out.append((name, leaf, P(), None))
            continue
        for pattern, spec in rules:
            if re.search(pattern, name) is not None:
                out.append((name, leaf, spec, pattern))
                break
        else:
            unmatched.append(name)
            out.append((name, leaf, P(), None))
    if strict and unmatched:
        raise UnmatchedLeafError(family, unmatched)
    return out


def match_partition_rules(rules, tree: Mapping, *, strict: bool = True) -> dict:
    """``{name: PartitionSpec}`` for the flat ``tree`` under first-match-wins
    ``rules`` (a ``RuleTable`` or ``[(regex, spec), ...]``)."""
    return {name: spec for name, _, spec, _ in match_with_provenance(rules, tree,
                                                                       strict=strict)}


def _transformer_block_rules(E) -> tuple[tuple[str, PartitionSpec], ...]:
    """The block the LM and the ViT share: attention Q/K/V column-parallel
    and its out projection row-parallel over 'model' (Megatron's split),
    the MLP the same, MoE experts over 'expert'; ``E`` the embed dimension's
    axis ('data' under FSDP)."""
    return (
        (r"attn\.(q|k|v)\.kernel$", P(E, "model")),
        (r"attn\.out\.kernel$", P("model", E)),
        (r"mlp\.wi\.kernel$", P(E, "model")),
        (r"mlp\.wo\.kernel$", P("model", E)),
        (r"moe\.router\.kernel$", P(E, "expert")),
        (r"moe\.wi$", P("expert", E, "model")),
        (r"moe\.wo$", P("expert", "model", E)),
        (r"norm\w*\.scale$", P()),
    )


def lm_rules(fsdp: bool = False) -> RuleTable:
    """The transformer LM: tensor parallelism over 'model' (vocabulary,
    heads, MLP hidden), experts over 'expert', the embed dimension over
    'data' with ``fsdp``."""
    E = "data" if fsdp else None
    return RuleTable("lm", _transformer_block_rules(E) + (
        (r"embed\.embedding$", P("model", E)),
        (r"lm_head\.kernel$", P("model", E)),
    ))


def vit_rules(fsdp: bool = False) -> RuleTable:
    """The ViT: the LM's blocks; the patch and position embeddings and the
    classifier head replicate by explicit rule (their embed dimension, the
    only one to shard, over 'data' with ``fsdp``).  The patch kernel is
    torch's (O, I, kh, kw): its embed dimension is the first."""
    E = "data" if fsdp else None
    return RuleTable("vit", _transformer_block_rules(E) + (
        (r"patch_embed\.weight$", P(E, None, None, None)),
        (r"patch_embed\.bias$", P()),
        (r"pos_embed$", P(None, None, E)),
        (r"head\.kernel$", P(E, None)),
        (r"head\.bias$", P()),
    ))


def cnn_rules() -> RuleTable:
    """The DenseNet: every parameter replicated (data parallelism only)."""
    return RuleTable("cnn", ((r".", P()),))


def decode_rules() -> RuleTable:
    """The LM's decode and serving: the training placement, so a training
    snapshot decodes as it is."""
    return RuleTable("decode", lm_rules(fsdp=False).rules)


def _norm_entries(spec, ndim: int) -> tuple:
    entries = tuple(spec) if spec is not None else ()
    return entries + (None,) * (ndim - len(entries))


def spec_axes(spec) -> set[str]:
    """The mesh axes a spec draws on (tuples flattened)."""
    axes: set[str] = set()
    for e in tuple(spec or ()):
        if e is None:
            continue
        axes.update(e if isinstance(e, tuple) else (e,))
    return axes


def spec_num_shards(spec, mesh_shape: Mapping[str, int]) -> int:
    """The devices one leaf is split across under ``spec`` on a mesh of
    ``mesh_shape`` (axis name -> size): its per-device byte divisor."""
    return math.prod(mesh_shape.get(a, 1) for a in spec_axes(spec))


def zero_shard_spec(shape: Sequence[int], dp: int, threshold: int = ZERO_THRESHOLD,
                    spec=None) -> int | None:
    """The dimension of a leaf of ``shape`` that ZeRO-1 splits over a data
    axis of ``dp`` ranks: the first one ``spec`` leaves unsharded (every
    one without a spec) and ``dp`` divides; None when the leaf stays
    replicated: under ``threshold`` elements, a trivial axis, a spec that
    already uses 'data' (FSDP), or no dimension divides.  ``shape`` is the
    leaf's global shape; a dimension ``spec`` leaves unsharded has the same
    size in a rank's shard."""
    size = math.prod(shape) if shape else 1
    if size < threshold or dp <= 1:
        return None
    entries = _norm_entries(spec, len(shape))
    if "data" in spec_axes(entries):
        return None
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim % dp == 0:
            return i
    return None


def optimizer_hbm_bytes(shapes: Iterable[Sequence[int]], dp: int,
                        threshold: int = ZERO_THRESHOLD,
                        moment_bytes_per_param: int = 8, specs=None,
                        mesh_shape: Mapping[str, int] | None = None) -> dict:
    """Per-device Adam-state bytes of parameter leaves of (global)
    ``shapes``: mu and nu per leaf (f32, ``moment_bytes_per_param`` = 2 x 4
    bytes), divided by each leaf's shard count under its spec (``specs``,
    one per shape, on a mesh of ``mesh_shape``; none: replicated),
    replicated over the data axis against ZeRO-sharded (an eligible leaf's
    bytes divided by ``dp`` too).  Pure accounting, shapes in, bytes out."""
    mesh_shape = dict(mesh_shape or {}, data=dp)
    replicated = zero = 0.0
    leaves = sharded = 0
    shapes = list(shapes)
    specs = list(specs) if specs is not None else [P()] * len(shapes)
    for shape, spec in zip(shapes, specs):
        size = math.prod(shape) if shape else 1
        bytes_ = size * moment_bytes_per_param / spec_num_shards(spec, mesh_shape)
        leaves += 1
        replicated += bytes_
        if zero_shard_spec(shape, dp, threshold, spec) is not None:
            sharded += 1
            zero += bytes_ / dp
        else:
            zero += bytes_
    return {
        "replicated_bytes": int(replicated),
        "zero_bytes": int(zero),
        "dp": dp,
        "leaves": leaves,
        "zero_sharded_leaves": sharded,
    }
