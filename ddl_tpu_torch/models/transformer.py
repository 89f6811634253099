"""Decoder-only transformer LM (counterpart of ``ddl_tpu/models/transformer.py``).

Pre-RMSNorm blocks, rotary position embeddings, causal attention
(grouped-query when ``n_kv_heads`` is set, sliding-window when
``attn_window`` is), a GELU MLP, f32 master weights with the matmuls in
``compute_dtype`` and f32 logits.  Module and parameter names mirror the
Flax tree (``embed.embedding``, ``block{i}.norm_attn.scale``,
``block{i}.attn.{q,k,v,out}.kernel``, ``block{i}.norm_mlp.scale``,
``block{i}.mlp.{wi,wo}.kernel`` or ``block{i}.moe.{router.kernel,wi,wo}``,
``norm_f.scale``, ``lm_head.kernel``) and so
do the layouts — dense kernels are (in, out), the head kernel (vocab,
d_model) — so ``models/convert.py`` maps the JAX tree by name alone.

``Attention`` carries the incremental-decode modes of the JAX module (a
linear or a rolling KV cache), which ``infer/decode.LMDecode`` drives.  Three
functions are injected, none by a global switch: ``attn_core`` (the
full-sequence attention: ``ops.attention.dense_attention`` by default, the
flash kernel for the decode prefill), ``decode_attend`` (the T=1 attention
over the whole cache: ``ops.quant.kv_decode``, the decode kernels, by
default; ``kv_decode_plain`` runs their plain versions) and ``int8_matmul``
(the product of at most 8 activation rows with an int8 weight:
``ops.int8_matvec.int8_matmul_small_m``, the kernel, by default).

Weight-only int8: ``QDense`` and ``LMHead`` take an int8 ``kernel`` with a
sibling ``scale`` (``ops.quant.quantize_lm_params``) under a strict
``load_state_dict`` and apply it as the JAX modules do, through
``int8_matmul`` at <= 8 rows.

Training: residual dropout after the attention and MLP sublayers
(``Block``, a mask drawn from an explicit ``torch.Generator`` seeded per
(seed, step, layer), so a recomputed block draws the same mask) and
per-block rematerialisation (``remat_block``: full, or selective
checkpointing that saves matmul outputs, ``REMAT_POLICIES``).

Mixture-of-experts (``num_experts > 0``): every block's MLP is a top-k
``MoeMlp`` (an f32 router, expert banks ``wi`` (E, D, F) and ``wo`` (E, F,
D), per-group token capacity, the one-hot einsum or the sort-and-gather
dispatch of ``moe_routing_plan``, the load-balancing aux loss, which each
block returns and ``TransformerLM`` sums).  One device only: the expert
axis and its all-to-all are LM parallelism (ROADMAP item 11).

Sequence parallelism: a rank holding sequence block ``seq_index`` of a
``seq``-sharded batch (``TransformerLM(..., seq_index=s)``) rotates its
queries and keys at their global positions ``s * T_local + arange(T_local)``,
as the JAX model's global arrays are; the sharded attention cores (ring,
Ulysses, the dense core over gathered K/V) come in as ``attn_core``
(``train/lm_steps.py``).  The step factory folds each rank's (data, seq)
coordinate into its dropout key, so no two shards draw the same mask.

Tensor parallelism (``tp``, a ``ModelShard``: the ``model`` group, its
size and this rank's index; Megatron's split, JAX's ``lm_rules``): each
rank holds its part of every block -- ``q``, ``k``, ``v`` and ``mlp.wi``
column-parallel (``n_heads/model`` query heads, ``kv_heads/model`` K/V
heads, ``d_ff/model`` hidden), ``out`` and ``mlp.wo`` row-parallel --
under the global names, so a rank's ``state_dict`` keys are the
one-device keys (``models/convert.shard_lm_state`` cuts them).
``parallel.mesh.copy_to_model`` enters the column-parallel products and
``reduce_from_model`` sums the row-parallel ones, whose partial sums are
taken in f32 and rounded to the compute dtype once, as one device's
product is.  The embedding is vocab-parallel (each rank its
``ceil(vocab/model)`` rows, the last shard padded with zero rows: a masked
lookup, then the sum over the ranks) and so is the f32 head (each rank
the logits of its rows; the loss edge masks the padded ones out:
``ops/losses.vocab_parallel_ce``).  The residual stream and its dropout
masks are replicated over ``model``: the masks' keys never hold the
``model`` coordinate.  The attention cores see the rank's heads only.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Callable, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ddl_tpu_torch.ops.attention import dense_attention
from ddl_tpu_torch.ops.int8_matvec import (
    Int8MatmulLaunch,
    int8_kernel_takes,
    int8_matmul_small_m,
)
from ddl_tpu_torch.parallel.mesh import copy_to_model, reduce_from_model
from ddl_tpu_torch.ops.quant import (
    QuantKV,
    kv_attend,
    kv_decode,
    kv_set_slots,
    kv_slice,
    kv_write,
)

__all__ = [
    "Attention",
    "Block",
    "LMConfig",
    "LMHead",
    "Mlp",
    "ModelShard",
    "MoeMlp",
    "QDense",
    "REMAT_POLICIES",
    "RMSNorm",
    "TokenEmbed",
    "TransformerLM",
    "apply_final_norm_and_head",
    "count_lm_params",
    "dense_kernel_names",
    "fold_seed",
    "init_lm_weights",
    "moe_routing_plan",
    "remat_block",
    "set_capacity_factor",
]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The JAX ``LMConfig``'s fields, defaults and checks (the field notes
    are there).  Fields this port does not act on yet are kept so a JAX
    config carries over unchanged: ``moe_ep`` (one device: ``"alltoall"``
    warns and takes the one-device dispatch) and ``fsdp`` (a no-op on one
    data rank; the step factories refuse it over more, ROADMAP item 11b).
    ``attn_impl`` picks the step factory's attention core
    (``train.lm_steps``)."""

    vocab_size: int = 256
    d_model: int = 256
    n_layers: int = 4
    n_heads: int = 8
    head_dim: int = 32
    n_kv_heads: int = 0
    d_ff: int = 1024
    num_experts: int = 0
    expert_top_k: int = 2
    capacity_factor: float = 1.5
    capacity_factor_min: float = 1.0
    capacity_anneal_drop: float = 0.02
    capacity_anneal_step: int = 0
    moe_ep: str = "auto"
    moe_dispatch: str = "auto"
    moe_group: int = 256
    moe_aux_weight: float = 0.01
    rope_theta: float = 10000.0
    compute_dtype: str = "bfloat16"
    attn_impl: str = "dense"
    # False | True | "auto": "auto" takes the flash kernel from
    # ops.flash_attention.FLASH_AUTO_MIN_T positions on (use_flash)
    flash: bool | str = False
    attn_window: int = 0
    remat: bool = True
    remat_policy: str = "full"
    fsdp: bool = False
    causal: bool = True
    dropout_rate: float = 0.0
    ce_chunk: int = 0
    ce_vocab_chunk: int = 0

    def __post_init__(self):
        if self.moe_ep not in ("auto", "gspmd", "alltoall"):
            raise ValueError(
                f"moe_ep must be 'auto', 'gspmd' or 'alltoall', got {self.moe_ep!r}"
            )
        if self.num_experts and self.capacity_factor_min <= 0:
            raise ValueError(
                f"capacity_factor_min must be > 0, got {self.capacity_factor_min}"
            )
        if self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"n_heads {self.n_heads} must divide by n_kv_heads "
                f"{self.n_kv_heads} (grouped-query attention)"
            )
        if self.attn_window < 0:
            raise ValueError(
                f"attn_window must be >= 0, got {self.attn_window} "
                "(0 = full causal history)"
            )
        if self.attn_window and not self.causal:
            raise ValueError(
                "attn_window > 0 requires causal=True (sliding causal window); "
                "bidirectional encoders have no decode order to window over"
            )
        if self.ce_vocab_chunk < 0:
            raise ValueError(f"ce_vocab_chunk must be >= 0, got {self.ce_vocab_chunk}")
        if self.ce_chunk and self.ce_vocab_chunk:
            raise ValueError(
                "ce_chunk and ce_vocab_chunk are mutually exclusive "
                "(token-chunked vs vocab-streamed loss edge)"
            )
        if self.ce_chunk < 0:
            raise ValueError(f"ce_chunk must be >= 0, got {self.ce_chunk} (0 = dense CE)")

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """This rank's place on the ``model`` axis: its process ``group`` (None
    on one rank), the axis ``size`` and the rank's ``index``.  A dimension
    of ``n`` splits into ``ceil(n / size)``-long parts, the last padded."""

    group: object = None
    size: int = 1
    index: int = 0

    @property
    def on(self) -> bool:
        return self.size > 1

    def part(self, n: int) -> int:
        return -(-n // self.size)

    def offset(self, n: int) -> int:
        return self.index * self.part(n)

    def valid(self, n: int) -> int:
        """The rows of this rank's part of a dimension of ``n`` that are
        real (the rest is padding)."""
        return max(0, min(self.part(n), n - self.offset(n)))


def _tp(tp) -> ModelShard:
    return tp if tp is not None else ModelShard()


REMAT_POLICIES = ("full", "dots", "dots_no_batch")

# What each selective policy saves instead of recomputing: the outputs of
# the matrix products (``jax.checkpoint_policies.checkpoint_dots``), or of
# those without a batch dimension (``dots_with_no_batch_dims_saveable``):
# aten.mm is the QDense/LMHead products, aten.bmm the batched einsums of
# dense attention.
_SAVED_OPS = {
    "dots": (torch.ops.aten.mm.default, torch.ops.aten.bmm.default),
    "dots_no_batch": (torch.ops.aten.mm.default,),
}


def _policy(saved):
    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def remat_block(cfg) -> Callable:
    """``run(block, x, *args)``: the block under this config's remat
    settings -- the one construction every caller uses, so remat semantics
    cannot drift between paths.  ``remat=False`` calls the block; ``"full"``
    recomputes the whole block in the backward pass
    (``torch.utils.checkpoint``, non-reentrant); ``"dots"`` and
    ``"dots_no_batch"`` save the matmul outputs named in ``_SAVED_OPS`` and
    recompute the rest (selective activation checkpointing).  Outside
    autograd (eval, decode) the block runs as it is."""
    if cfg.remat and cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(
            f"unknown remat_policy {cfg.remat_policy!r} "
            f"(expected one of {sorted(REMAT_POLICIES)})"
        )
    if not cfg.remat:
        return lambda block, *args: block(*args)
    kw = {}
    if cfg.remat_policy != "full":
        kw["context_fn"] = partial(create_selective_checkpoint_contexts,
                                   _policy(_SAVED_OPS[cfg.remat_policy]))

    def run(block, *args):
        if not torch.is_grad_enabled():
            return block(*args)
        return checkpoint(block, *args, use_reentrant=False, **kw)

    return run


def fold_seed(*parts: int) -> int:
    """A 63-bit generator seed from integer parts (seed, step, layer, ...):
    distinct parts give unrelated streams, the same parts the same one
    (the port's ``jax.random.fold_in``; its bits are not JAX's)."""
    state = np.random.SeedSequence([int(p) % (1 << 64) for p in parts]).generate_state(
        1, np.uint64)
    return int(state[0] >> np.uint64(1))


def _dropout(x, rate: float, g: torch.Generator):
    """flax's ``nn.Dropout``: ``keep ~ bernoulli(1 - rate)``, ``where(keep,
    x / (1 - rate), 0)``, the mask from ``g``."""
    keep = torch.rand(x.shape, generator=g, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def _rope(x, theta: float, positions=None):
    """Rotary embeddings, half-split. x: (B, T, H, D); ``positions`` (T,)
    shared by the batch or (B, T) per row, default 0..T-1.  Frequencies and
    angles in f32; cos/sin cast to ``x.dtype`` before the multiply."""
    _, t, _, d = x.shape
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    if positions is None:
        positions = torch.arange(t, dtype=torch.float32, device=x.device)
    angles = positions.float()[..., None] * freqs  # (..., T, half)
    if angles.dim() == 2:  # shared row broadcasts over the batch
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class RMSNorm(nn.Module):
    """f32 RMS normalisation (eps 1e-6), f32 scale, cast to ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x32 = x.float()
        y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + 1e-6)
        return (y * self.scale).to(self.dtype)


class _Int8Weight(nn.Module):
    """A module whose f32 ``kernel`` parameter may arrive int8 with a
    sibling ``scale`` (``ops.quant.quantize_lm_params``).  Loading such a
    ``state_dict`` turns ``kernel`` into an int8 buffer (an int8 tensor
    cannot require a gradient) and registers ``scale`` beside it, so a
    strict load demands the scale; loading an f32 kernel turns it back.

    ``int8_matmul`` computes the products of at most ``MATVEC_MAX_ROWS``
    rows: ``(x, w8, scale, contract_last=...) -> y``.  When it is the
    kernel's wrapper (the default), the module keeps the weight's
    ``Int8MatmulLaunch`` (checked and planned once) and calls that; a new
    one is built after a load or a device move, or whenever ``kernel`` or
    ``scale`` is not the tensor, at the memory, it was built for.  While it
    holds, a decode step's product is ``_take(x)``: the launch state's own
    row, dtype and device test stands in for ``int8_kernel_takes``, with
    no reshape."""

    def __init__(self, shape: tuple, scale_shape: tuple, int8_matmul: Callable) -> None:
        super().__init__()
        self.scale_shape = scale_shape
        self.int8_matmul = int8_matmul
        self.kernel = nn.Parameter(torch.empty(shape))
        self._launch = None

    @property
    def quantized(self) -> bool:
        return "scale" in self._buffers

    def _int8_product(self, x, large: Callable, contract_last: bool = False):
        """The product with the int8 kernel over x's rows flattened: through
        ``int8_matmul`` where ``int8_kernel_takes`` the shape (at most
        ``MATVEC_MAX_ROWS`` rows, and on CUDA what the kernel can stage),
        otherwise through ``large``."""
        x2 = x.reshape(-1, x.shape[-1])
        if not int8_kernel_takes(*x2.shape, contract_last, x2.dtype, x2.device.type):
            y = large(x2)
        elif self.int8_matmul is int8_matmul_small_m:
            launch = self._launch
            if launch is None or not launch.matches(self.kernel, self.scale):
                launch = self._launch = Int8MatmulLaunch(self.kernel, self.scale,
                                                         contract_last=contract_last)
            y = launch(x2)
        else:
            y = self.int8_matmul(x2, self.kernel, self.scale, contract_last=contract_last)
        return y.reshape(*x.shape[:-1], -1)

    def _take(self, x):
        """The product through the held launch state, or None where there
        is none, it no longer holds this module's tensors, or it does not
        take x."""
        launch = self._launch
        if launch is not None and launch.matches(self._buffers["kernel"], self._buffers["scale"]):
            return launch.take(x)
        return None

    def _apply(self, fn, *args, **kwargs):
        self._launch = None  # a device move or cast replaces the tensors
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        self._launch = None
        kernel = state_dict.get(prefix + "kernel")
        if kernel is not None and (not kernel.is_floating_point()) != self.quantized:
            old = self.kernel
            del self.kernel
            if self.quantized:
                del self.scale
                self.kernel = nn.Parameter(torch.empty(old.shape, device=old.device))
            else:
                self.register_buffer(
                    "kernel", torch.empty(old.shape, dtype=torch.int8, device=old.device))
                self.register_buffer("scale", torch.empty(self.scale_shape, device=old.device))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class QDense(_Int8Weight):
    """``nn.Dense(use_bias=False)``: an f32 (in, out) ``kernel`` cast to the
    compute dtype, one product with ``x`` in that dtype.

    With an int8 kernel and its (1, out) ``scale``: at most
    ``MATVEC_MAX_ROWS`` rows (B*T) go through ``int8_matmul`` (f32 sums,
    one rounding); more rows take the JAX module's product and rounding
    points, ``((x @ w8.to(dtype)).float() * scale).to(dtype)``."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype,
                 int8_matmul: Callable = int8_matmul_small_m) -> None:
        super().__init__((in_features, features), (1, features), int8_matmul)
        self.dtype = dtype

    def forward(self, x):
        x = x.to(self.dtype)
        if not self.quantized:
            return x @ self.kernel.to(self.dtype)
        y = self._take(x)
        return y if y is not None else self._int8_product(x, lambda x2: (
            (x2 @ self.kernel.to(self.dtype)).float() * self.scale).to(self.dtype))

    def partial_sum(self, x):
        """A row-parallel part: ``x`` and the kernel in the compute dtype,
        their product summed in f32 and left there (``_F32Product``), for
        ``reduce_from_model`` to add up before the one rounding."""
        if self.quantized:
            raise NotImplementedError("a row-parallel product takes an f32 kernel: the "
                                      "sharded int8 decode is ROADMAP item 11b")
        return _F32Product.apply(x.to(self.dtype), self.kernel.to(self.dtype))


class _F32Product(torch.autograd.Function):
    """``x @ w`` summed and returned in f32 from operands in their own
    (compute) dtype: on the card one bf16 GEMM with an f32 output
    (``torch.mm(..., out_dtype=torch.float32)``, which has no autograd
    formula), on the CPU the same sums over f32 copies (the bf16 products
    are exact in f32).  The backward's products take the operands' dtype,
    as one card's ``x @ w`` does; the incoming f32 cotangent holds bf16
    values (the rounding after the all-reduce cast it up)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        if x.dtype == torch.float32:
            y = x2 @ w
        elif x.is_cuda:
            y = torch.mm(x2, w, out_dtype=torch.float32)
        else:
            y = x2.float() @ w.float()
        return y.reshape(*x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        g2 = g.reshape(-1, g.shape[-1])
        dx = (g2 @ w.t()).reshape(x.shape)
        dw = x.reshape(-1, x.shape[-1]).t() @ g2
        return dx, dw


def _cache_len(cache) -> int:
    return (cache.kq if isinstance(cache, QuantKV) else cache[0]).shape[1]


class Attention(nn.Module):
    """Causal self-attention; the JAX module's four branches:

    * ``kv_cache=None``: full-sequence attention through ``attn_core``;
    * ``rolling=True``: a ring cache of capacity ``attn_window`` (slot ``p %
      cap`` holds position p): prefill attends its fresh K/V and keeps the
      last ``min(cap, t)`` keys; a single-token step writes one slot and
      reads the ring under the positions the slots derive;
    * ``t > 1`` at ``offset == 0``: prefill into a linear cache, attending
      the fresh K/V through ``attn_core``;
    * otherwise cached attention at ``offset``, over an O(window) slice when
      a window is set and smaller than the cache.

    A single-token step over the whole cache goes through
    ``decode_attend``.  With a cache the return is ``(out, cache)``; the
    cache tensors are written in place.  ``fused_prefill=False`` sends a
    multi-token pass at offset 0 to the masked cached branch too, as the
    JAX serving engine's chunk program (whose offset is traced) does."""

    def __init__(self, cfg: LMConfig, attn_core: Optional[Callable] = None,
                 decode_attend: Callable = kv_decode,
                 int8_matmul: Callable = int8_matmul_small_m,
                 tp: Optional[ModelShard] = None) -> None:
        super().__init__()
        self.cfg = cfg
        self.attn_core = attn_core
        self.decode_attend = decode_attend
        self.fused_prefill = True
        # this rank's block of a seq-sharded sequence (rope's global offset)
        self.seq_index = 0
        self.tp = tp = _tp(tp)
        # this rank's query and K/V heads
        self.heads, self.kv_heads = cfg.n_heads // tp.size, cfg.kv_heads // tp.size
        hd, dt = cfg.head_dim, cfg.dtype
        self.q = QDense(cfg.d_model, self.heads * hd, dt, int8_matmul)
        self.k = QDense(cfg.d_model, self.kv_heads * hd, dt, int8_matmul)
        self.v = QDense(cfg.d_model, self.kv_heads * hd, dt, int8_matmul)
        self.out = QDense(self.heads * hd, cfg.d_model, dt, int8_matmul)

    def _core(self, causal: bool = True):
        return self.attn_core or partial(dense_attention, causal=causal,
                                         window=self.cfg.attn_window)

    def forward(self, x, kv_cache=None, offset: Optional[int] = None, rolling: bool = False):
        cfg, tp = self.cfg, self.tp
        b, t, _ = x.shape
        if tp.on:
            if kv_cache is not None:
                raise NotImplementedError("a KV cache under tensor parallelism: the sharded "
                                          "decode is ROADMAP item 11b")
            x = copy_to_model(x, tp.group)
        q = self.q(x).reshape(b, t, self.heads, cfg.head_dim)
        k = self.k(x).reshape(b, t, self.kv_heads, cfg.head_dim)
        v = self.v(x).reshape(b, t, self.kv_heads, cfg.head_dim)
        positions = None
        if kv_cache is not None:
            positions = torch.arange(offset, offset + t, device=x.device)
        elif self.seq_index:
            positions = torch.arange(self.seq_index * t, (self.seq_index + 1) * t,
                                     device=x.device)
        q = _rope(q, cfg.rope_theta, positions)
        k = _rope(k, cfg.rope_theta, positions)
        if kv_cache is None:
            o = self._core(cfg.causal)(q, k, v)
        elif rolling:
            if not cfg.attn_window:
                raise ValueError("rolling decode cache requires attn_window")
            cap = _cache_len(kv_cache)
            if t > 1:
                o = self._core()(q, k, v)
                keep = min(cap, t)
                slots = (offset + t - keep + torch.arange(keep, device=x.device)) % cap
                kv_set_slots(kv_cache, k[:, -keep:], v[:, -keep:], slots)
            else:
                kv_write(kv_cache, k, v, offset % cap)
                # slot s holds the newest position congruent to s (mod cap);
                # never-written slots derive negative positions
                key_pos = offset - ((offset - torch.arange(cap, device=x.device)) % cap)
                mask = ((key_pos <= offset) & (key_pos > offset - cfg.attn_window)
                        & (key_pos >= 0))[None, :]
                o = kv_attend(q, kv_cache, mask, use_kernel=True, decode=self.decode_attend)
        elif t > 1 and offset == 0 and self.fused_prefill:
            kv_write(kv_cache, k, v, 0)
            o = self._core()(q, k, v)
        else:
            kv_write(kv_cache, k, v, offset)
            cap = _cache_len(kv_cache)
            span, start, att_cache = cap, 0, kv_cache
            if cfg.attn_window and cfg.attn_window + t - 1 < cap:
                span = cfg.attn_window + t - 1
                start = min(max(offset + t - span, 0), cap - span)
                att_cache = kv_slice(kv_cache, start, span)
            q_pos = torch.arange(offset, offset + t, device=x.device)[:, None]
            key_pos = torch.arange(start, start + span, device=x.device)[None, :]
            mask = key_pos <= q_pos
            if cfg.attn_window:
                mask &= key_pos > q_pos - cfg.attn_window
            o = kv_attend(q, att_cache, mask, use_kernel=t == 1 and span == cap,
                          decode=self.decode_attend)
        o = o.reshape(b, t, self.heads * cfg.head_dim)
        if tp.on:
            return reduce_from_model(self.out.partial_sum(o), tp.group).to(cfg.dtype)
        out = self.out(o)
        return out if kv_cache is None else (out, kv_cache)


class Mlp(nn.Module):
    """wi -> GELU (flax's ``nn.gelu``: the tanh approximation) -> wo."""

    def __init__(self, cfg: LMConfig, int8_matmul: Callable = int8_matmul_small_m,
                 tp: Optional[ModelShard] = None) -> None:
        super().__init__()
        self.tp = tp = _tp(tp)
        self.dtype = cfg.dtype
        self.wi = QDense(cfg.d_model, cfg.d_ff // tp.size, cfg.dtype, int8_matmul)
        self.wo = QDense(cfg.d_ff // tp.size, cfg.d_model, cfg.dtype, int8_matmul)

    def forward(self, x):
        if not self.tp.on:
            return self.wo(F.gelu(self.wi(x), approximate="tanh"))
        h = F.gelu(self.wi(copy_to_model(x, self.tp.group)), approximate="tanh")
        return reduce_from_model(self.wo.partial_sum(h), self.tp.group).to(self.dtype)


def moe_routing_plan(cfg, seq_len: int) -> tuple[str, int]:
    """The (dispatch, group size) a MoE layer uses at this sequence length:
    the group is the largest divisor of ``seq_len`` at or under
    ``cfg.moe_group`` (the whole sequence when that divisor is under half
    the request, or ``moe_group`` is 0); ``moe_dispatch="auto"`` takes the
    one-hot einsum up to 2048-token groups and the sort beyond."""
    g = min(cfg.moe_group, seq_len) if cfg.moe_group else seq_len
    while seq_len % g:
        g -= 1
    if cfg.moe_group and g < min(cfg.moe_group, seq_len) / 2:
        g = seq_len
    impl = cfg.moe_dispatch
    if impl == "auto":
        impl = "einsum" if g <= 2048 else "sort"
    if impl not in ("sort", "einsum"):
        raise ValueError(
            f"moe_dispatch must be 'auto', 'sort' or 'einsum', got {cfg.moe_dispatch!r}"
        )
    return impl, g


def _top_k_dispatch(gates, k: int, capacity: int):
    """GShard top-k routing with per-group capacity.  gates: (B, S, E)
    router probabilities.  Returns (dispatch, combine), both (B, S, E, C):
    0/1 slots and the slots' renormalised gate weights.  Tokens claim slots
    by choice rank, then position (``argmax`` takes the lowest expert on a
    tie); a token past an expert's capacity is dropped."""
    b, s, e = gates.shape
    g = gates
    dispatch = gates.new_zeros((b, s, e, capacity))
    combine = gates.new_zeros((b, s, e, capacity))
    counts = gates.new_zeros((b, e))
    selected_mass = gates.new_zeros((b, s))
    slots = torch.arange(capacity, device=gates.device)
    for _ in range(k):
        onehot = F.one_hot(g.argmax(-1), e).to(gates.dtype)
        gate_j = (g * onehot).sum(-1)
        pos = onehot.cumsum(1) - 1 + counts[:, None, :]
        counts = counts + onehot.sum(1)
        pos_tok = (pos * onehot).sum(-1)
        keep = (pos_tok < capacity).to(gates.dtype)
        # a position past the capacity matches no slot (jax.nn.one_hot's zeros)
        pos_oh = (pos_tok.long()[..., None] == slots).to(gates.dtype)
        d = onehot[..., None] * pos_oh[:, :, None, :] * keep[..., None, None]
        dispatch = dispatch + d
        combine = combine + d * gate_j[..., None, None]
        selected_mass = selected_mass + gate_j * keep
        g = g * (1.0 - onehot)
    combine = combine / selected_mass.clamp(min=1e-9)[..., None, None]
    return dispatch, combine


def _sort_dispatch(gates, k: int, capacity: int):
    """The slot assignment of ``_top_k_dispatch`` without (B, S, E, C)
    tensors: token-choices flattened choice-rank-major and stably sorted by
    expert.  Returns ``(slot_token, slot_valid, slot_choice, choice_slot,
    choice_keep, choice_weight, frac, kept)`` as the JAX function does:
    per slot (B, E*C) its token, whether it is filled and the flat choice
    that fills it; per choice (B, K, S) its slot (clamped), whether it was
    kept and its renormalised weight; the kept choices per token for each
    expert (E,) and the kept share of all choices."""
    b, s, e = gates.shape
    n = k * s
    dev = gates.device
    # a stable descending sort puts the lowest expert first on a tie, as
    # jax.lax.top_k does
    expert_idx = torch.sort(gates, dim=-1, descending=True, stable=True).indices[..., :k]
    gate_vals = torch.gather(gates, -1, expert_idx)  # (B, S, K)
    expert_flat = expert_idx.transpose(1, 2).reshape(b, n)  # k-major
    sort_ord = torch.argsort(expert_flat, dim=-1, stable=True)
    sorted_expert = torch.gather(expert_flat, -1, sort_ord)
    is_expert = expert_flat[..., None] == torch.arange(e, device=dev)  # (B, N, E)
    counts = is_expert.sum(1)
    starts = counts.cumsum(-1) - counts
    pos_in_e = torch.arange(n, device=dev)[None] - torch.gather(starts, -1, sorted_expert)
    keep_sorted = pos_in_e < capacity
    # an overflowing choice targets slot E*C, one past the end, which is cut off
    slot_sorted = torch.where(keep_sorted, sorted_expert * capacity + pos_in_e, e * capacity)

    def by_slot(values, dtype):
        out = torch.zeros((b, e * capacity + 1), dtype=dtype, device=dev)
        return out.scatter_(-1, slot_sorted, values.to(dtype))[:, :-1]

    slot_token = by_slot(sort_ord % s, torch.long)  # k-major: flat = rank * s + pos
    slot_valid = by_slot(torch.ones_like(sort_ord), gates.dtype)
    slot_choice = by_slot(sort_ord, torch.long)
    inv = torch.argsort(sort_ord, dim=-1)
    choice_slot = torch.gather(slot_sorted, -1, inv)
    choice_keep = torch.gather(keep_sorted, -1, inv)
    gate_r = gate_vals.transpose(1, 2)  # (B, K, S)
    keep_r = choice_keep.reshape(b, k, s).to(gates.dtype)
    mass = (gate_r * keep_r).sum(1)
    choice_weight = gate_r * keep_r / mass.clamp(min=1e-9)[:, None, :]
    frac = (is_expert & choice_keep[..., None]).sum((0, 1)).to(gates.dtype) / (b * s)
    # the mean as XLA computes it: the sum times the reciprocal of the count
    kept = choice_keep.sum().to(gates.dtype) * (1.0 / choice_keep.numel())
    choice_slot = choice_slot.clamp(max=e * capacity - 1).reshape(b, k, s)
    return (slot_token, slot_valid, slot_choice, choice_slot, choice_keep.reshape(b, k, s),
            choice_weight, frac, kept)


def _rows(index, d: int):
    return index[..., None].expand(*index.shape, d)


class _DispatchGather(torch.autograd.Function):
    """``xe[b, slot] = x[b, slot_token[b, slot]] * valid``.  The backward is
    a gather too: token t's gradient is the sum over its k choices' slots,
    read through ``choice_slot`` (a scatter-add, the gather's own backward,
    never runs)."""

    @staticmethod
    def forward(ctx, x, slot_token, slot_valid, choice_slot, choice_keep):
        ctx.save_for_backward(slot_valid, choice_slot, choice_keep)
        xe = torch.gather(x, 1, _rows(slot_token, x.shape[-1]))
        return xe * slot_valid[..., None].to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        sv, cs, ck = ctx.saved_tensors
        b, k, s = cs.shape
        g = g * sv[..., None].to(g.dtype)
        contrib = torch.gather(g, 1, _rows(cs.reshape(b, k * s), g.shape[-1]))
        dx = (contrib.reshape(b, k, s, -1) * ck[..., None].to(g.dtype)).sum(1)
        return dx, None, None, None, None


class _CombineGather(torch.autograd.Function):
    """``yc[b, choice] = ye[b, choice_slot[b, choice]]``, (B, K, S, D).
    Slots and kept choices correspond one to one, so the backward gathers
    through the inverse map ``slot_choice``, masked by slot validity."""

    @staticmethod
    def forward(ctx, ye, choice_slot, slot_choice, slot_valid):
        ctx.save_for_backward(slot_choice, slot_valid)
        b, k, s = choice_slot.shape
        yc = torch.gather(ye, 1, _rows(choice_slot.reshape(b, k * s), ye.shape[-1]))
        return yc.reshape(b, k, s, ye.shape[-1])

    @staticmethod
    def backward(ctx, g):
        sc, sv = ctx.saved_tensors
        gf = g.reshape(g.shape[0], -1, g.shape[-1])
        d_ye = torch.gather(gf, 1, _rows(sc, g.shape[-1]))
        return d_ye * sv[..., None].to(g.dtype), None, None, None


class Router(nn.Module):
    """The MoE router: an f32 (d_model, E) ``kernel``, f32 logits (never
    quantized, never cast: the softmax and the expert choice stay exact)."""

    def __init__(self, d_model: int, num_experts: int) -> None:
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(d_model, num_experts))

    def forward(self, x):
        return x.float() @ self.kernel


class MoeMlp(nn.Module):
    """Top-k mixture-of-experts MLP on one device: ``x`` (B, S, D) ->
    ``(y, aux_loss)``.

    The sequence splits into routing groups (``moe_routing_plan``), each
    with ``max(1, int(k * group * capacity_factor / E))`` slots per expert;
    the f32 router's softmax gates pick each token's top-k experts; the
    tokens reach the expert banks (f32 masters ``wi`` (E, D, F), ``wo`` (E,
    F, D), cast to the compute dtype; tanh GELU between) by the one-hot
    einsum or the sort's gathers and return weighted by their renormalised
    gates.  The aux loss is ``E * sum(frac / k * mean_gate)``.

    ``router_stats`` holds the last forward's ``(drop_frac, load)`` (the
    dropped share of token-choices; each expert's share of the kept ones):
    a block recomputed under remat overwrites them with the same values,
    so they are read once per forward (``train.lm_steps.moe_router_metrics``).
    ``capacity_factor`` starts at the config's and is what the forward
    reads, so the trainer's anneal (``set_capacity_factor``) reaches a
    checkpointed block's recompute too.

    Weight-only int8 banks: loading a ``state_dict`` whose ``wi``/``wo`` are
    int8 (``ops.quant.quantize_lm_params``) turns them into buffers beside
    ``wi_scale``/``wo_scale`` (E, 1, out), which scale the einsum outputs.

    ``moe_ep="alltoall"`` warns once, at construction, with JAX's message
    and takes the one-device dispatch."""

    def __init__(self, cfg: LMConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.capacity_factor = cfg.capacity_factor
        e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
        self.router = Router(d, e)
        self.wi = nn.Parameter(torch.empty(e, d, f))
        self.wo = nn.Parameter(torch.empty(e, f, d))
        self.router_stats = None
        if cfg.moe_ep == "alltoall":
            warnings.warn(
                "moe_ep='alltoall' requested but no expert mesh axis (>1) is visible at trace "
                "time (expert axis size 1); falling back to the GSPMD dispatch",
                stacklevel=2,
            )

    @property
    def quantized(self) -> bool:
        return "wi_scale" in self._buffers

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        wi = state_dict.get(prefix + "wi")
        if wi is not None and (not wi.is_floating_point()) != self.quantized:
            to_int8 = not wi.is_floating_point()
            for name in ("wi", "wo"):
                old = getattr(self, name)
                delattr(self, name)
                if to_int8:
                    self.register_buffer(
                        name, torch.empty(old.shape, dtype=torch.int8, device=old.device))
                    self.register_buffer(f"{name}_scale", torch.empty(
                        (old.shape[0], 1, old.shape[2]), device=old.device))
                else:
                    delattr(self, f"{name}_scale")
                    setattr(self, name, nn.Parameter(torch.empty(old.shape, device=old.device)))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x):
        cfg = self.cfg
        b0, s0, d = x.shape
        impl, group = moe_routing_plan(cfg, s0)
        x = x.reshape(b0 * (s0 // group), group, d)  # groups fold into the batch
        b, s, _ = x.shape
        e, k = cfg.num_experts, cfg.expert_top_k
        capacity = max(1, int(k * s * self.capacity_factor / e))
        gates = torch.softmax(self.router(x), dim=-1)  # (B, S, E) f32
        if impl == "sort":
            (slot_token, slot_valid, slot_choice, choice_slot, choice_keep, choice_weight,
             frac, kept) = _sort_dispatch(gates, k, capacity)
        else:
            dispatch, combine = _top_k_dispatch(gates, k, capacity)
            frac = dispatch.sum(-1).mean((0, 1))
            kept = dispatch.sum() / (b * s * k)
        aux = e * torch.sum(frac / k * gates.mean((0, 1)))
        self.router_stats = ((1.0 - kept).detach(),
                             (frac / frac.sum().clamp(min=1e-9)).detach())
        dt = cfg.dtype
        xd = x.to(dt)
        if impl == "sort":
            xe = _DispatchGather.apply(xd, slot_token, slot_valid, choice_slot, choice_keep)
            xe = xe.reshape(b, e, capacity, d).transpose(0, 1)  # (E, B, C, D)
        else:
            xe = torch.einsum("bsec,bsd->ebcd", dispatch.to(dt), xd)
        h = torch.einsum("ebcd,edf->ebcf", xe, self.wi.to(dt))
        if self.quantized:
            h = h * self.wi_scale[:, None].to(dt)
        h = F.gelu(h, approximate="tanh")
        ye = torch.einsum("ebcf,efd->ebcd", h, self.wo.to(dt))
        if self.quantized:
            ye = ye * self.wo_scale[:, None].to(dt)
        if impl == "sort":
            ye_flat = ye.transpose(0, 1).reshape(b, e * capacity, d)
            yc = _CombineGather.apply(ye_flat, choice_slot, slot_choice, slot_valid)
            y = (yc * choice_weight[..., None].to(dt)).sum(1)
        else:
            y = torch.einsum("bsec,ebcd->bsd", combine.to(dt), ye)
        return y.reshape(b0, s0, d), aux


def set_capacity_factor(model: nn.Module, capacity_factor: float) -> None:
    """Set the capacity factor of every ``MoeMlp`` in ``model`` (the
    trainer's anneal; the weights and the optimizer state do not depend on
    it)."""
    for m in model.modules():
        if isinstance(m, MoeMlp):
            m.capacity_factor = capacity_factor


class Block(nn.Module):
    """Pre-norm decoder block: ``(x, aux)``, or ``(x, aux, cache)`` with a
    KV cache, ``aux`` being the MoE block's load-balancing loss (0 for the
    dense MLP).  The MLP is ``moe`` (``MoeMlp``) when ``cfg.num_experts > 0``,
    else ``mlp``.

    ``dropout_seed`` (an int, with ``deterministic=False`` and
    ``cfg.dropout_rate > 0``) turns on residual dropout after the attention
    and the MLP, both masks drawn from a generator seeded with it here, in
    the forward: a checkpointed block recomputed in the backward pass
    re-seeds it and draws the same masks (checkpointing restores only the
    default generators, not an explicit one)."""

    def __init__(self, cfg: LMConfig, attn_core: Optional[Callable] = None,
                 decode_attend: Callable = kv_decode,
                 int8_matmul: Callable = int8_matmul_small_m,
                 tp: Optional[ModelShard] = None) -> None:
        super().__init__()
        self.rate = cfg.dropout_rate
        self.norm_attn = RMSNorm(cfg.d_model, cfg.dtype)
        self.attn = Attention(cfg, attn_core, decode_attend, int8_matmul, tp)
        self.norm_mlp = RMSNorm(cfg.d_model, cfg.dtype)
        self.is_moe = cfg.num_experts > 0
        if self.is_moe:
            if _tp(tp).on:
                raise NotImplementedError("a MoE block under tensor parallelism: the expert "
                                          "axis is ROADMAP item 11c")
            self.moe = MoeMlp(cfg)
        else:
            self.mlp = Mlp(cfg, int8_matmul, tp)

    def forward(self, x, kv_cache=None, offset: Optional[int] = None, rolling: bool = False,
                deterministic: bool = True, dropout_seed: Optional[int] = None):
        drop = lambda y: y  # noqa: E731
        if not deterministic and self.rate > 0.0:
            if dropout_seed is None:
                raise ValueError("deterministic=False with dropout needs a dropout_seed")
            g = torch.Generator(device=x.device).manual_seed(dropout_seed)
            drop = partial(_dropout, rate=self.rate, g=g)
        h = self.norm_attn(x)
        if kv_cache is None:
            x = x + drop(self.attn(h))
        else:
            a, kv_cache = self.attn(h, kv_cache, offset, rolling=rolling)
            x = x + drop(a)
        h = self.norm_mlp(x)
        if self.is_moe:
            y, aux = self.moe(h)
        else:
            y, aux = self.mlp(h), 0.0
        x = x + drop(y)
        return (x, aux) if kv_cache is None else (x, aux, kv_cache)


class TokenEmbed(nn.Module):
    """f32 (vocab, d_model) table; gather, then cast to the compute dtype.
    Under ``tp`` the table is this rank's ``ceil(vocab/model)`` rows: the
    tokens outside them look up zeros, and ``reduce_from_model`` sums the
    ranks' rows (one is not zero) before the cast."""

    def __init__(self, cfg: LMConfig, tp: Optional[ModelShard] = None) -> None:
        super().__init__()
        self.dtype = cfg.dtype
        self.tp = tp = _tp(tp)
        self.vocab = cfg.vocab_size
        self.embedding = nn.Parameter(torch.empty(tp.part(cfg.vocab_size), cfg.d_model))

    def forward(self, tokens):
        tp = self.tp
        if not tp.on:
            return self.embedding[tokens].to(self.dtype)
        local = tokens - tp.offset(self.vocab)
        mine = (local >= 0) & (local < tp.valid(self.vocab))
        rows = self.embedding[torch.where(mine, local, torch.zeros_like(local))]
        rows = rows * mine[..., None].to(rows.dtype)
        return reduce_from_model(rows, tp.group).to(self.dtype)


class LMHead(_Int8Weight):
    """The vocab projection: an f32 (vocab, d_model) kernel, x cast to f32,
    f32 logits (a float32 product on the card needs TF32 off).

    With an int8 kernel and its (vocab, 1) ``scale``: the f32 product with
    the int8 kernel widened to f32, times the per-row scale; at most
    ``MATVEC_MAX_ROWS`` rows go through ``int8_matmul`` (vocab-major)."""

    def __init__(self, cfg: LMConfig, int8_matmul: Callable = int8_matmul_small_m,
                 tp: Optional[ModelShard] = None) -> None:
        self_tp = _tp(tp)
        rows = self_tp.part(cfg.vocab_size)
        super().__init__((rows, cfg.d_model), (rows, 1), int8_matmul)
        self.tp = self_tp

    def forward(self, x):
        x = x.float()
        if self.tp.on:
            # this rank's rows of the f32 logits (the padded rows' too)
            return copy_to_model(x, self.tp.group) @ self.kernel.t()
        if not self.quantized:
            return x @ self.kernel.t()
        y = self._take(x)
        return y if y is not None else self._int8_product(
            x, lambda x2: (x2 @ self.kernel.float().t()) * self.scale[:, 0], contract_last=True)


def apply_final_norm_and_head(model: "TransformerLM", x):
    """Final RMSNorm (``norm_f``) and ``lm_head`` -> f32 logits."""
    return model.lm_head(model.norm_f(x).float())


class TransformerLM(nn.Module):
    """tokens (B, T) -> (logits (B, T, V) f32, aux loss scalar).
    ``seq_index`` is this rank's block of a ``seq``-sharded sequence (0:
    the whole sequence, or the first block).

    ``TransformerLM(cfg, attn_core, stage=s, stages=P, virtual=V)`` is rank
    ``s``'s part of the pipelined model (``parallel/lm_pipeline.
    layer_chunks``; the JAX ``_Embed``/``_Head``/``_HeadNorm``): ``embed``
    on stage 0, the blocks of its chunks under their global names, and
    ``norm_f`` and ``lm_head`` on stage P-1, so its ``state_dict`` is the
    whole model's restricted to them and the stages' merge by key.

    ``tp`` (a ``ModelShard``) makes it this rank's tensor-parallel part:
    its logits are then the rank's vocab rows (``(B, T, ceil(V/model))``),
    for the vocab-parallel loss edge."""

    def __init__(self, cfg: LMConfig, attn_core: Optional[Callable] = None,
                 decode_attend: Callable = kv_decode,
                 int8_matmul: Callable = int8_matmul_small_m, seq_index: int = 0,
                 stage: Optional[int] = None, stages: int = 1, virtual: int = 1,
                 tp: Optional[ModelShard] = None) -> None:
        super().__init__()
        self.cfg = cfg
        self.tp = _tp(tp)
        if stage is None:
            self.layers = list(range(cfg.n_layers))
        else:
            from ddl_tpu_torch.parallel.lm_pipeline import layer_chunks

            self.layers = sum(layer_chunks(cfg.n_layers, stages, virtual)[stage], [])
        if stage in (None, 0):
            self.embed = TokenEmbed(cfg, tp)
        for i in self.layers:
            self.add_module(f"block{i}", Block(cfg, attn_core, decode_attend, int8_matmul, tp))
            getattr(self, f"block{i}").attn.seq_index = seq_index
        if stage in (None, stages - 1):
            self.norm_f = RMSNorm(cfg.d_model, cfg.dtype)
            self.lm_head = LMHead(cfg, int8_matmul, tp)

    def blocks(self):
        return [getattr(self, f"block{i}") for i in self.layers]

    def forward(self, tokens, deterministic: bool = True, return_hidden: bool = False,
                rngs: Optional[Mapping[str, int]] = None):
        """``deterministic=False`` with ``rngs={"dropout": key}`` (an int,
        ``train.lm_steps.dropout_kwargs``) trains with dropout, block i's
        masks seeded by ``fold_seed(key, i)``.  ``return_hidden`` stops
        after the final RMSNorm: ((B, T, D) activations, aux)."""
        x = self.embed(tokens)
        aux_total = torch.zeros((), device=x.device)
        run = remat_block(self.cfg)
        key = None if rngs is None else rngs.get("dropout")
        for i, block in enumerate(self.blocks()):
            seed = None if key is None else fold_seed(key, i)
            x, aux = run(block, x, None, None, False, deterministic, seed)
            aux_total = aux_total + aux
        if return_hidden:
            return self.norm_f(x), aux_total
        return apply_final_norm_and_head(self, x), aux_total


def dense_kernel_names(model: nn.Module) -> list[str]:
    """``state_dict`` keys of every weight the compute dtype multiplies:
    each ``QDense`` kernel and each MoE expert bank (a caller casting them
    leaves an int8 weight as it is)."""
    names = []
    for name, m in model.named_modules():
        if isinstance(m, QDense):
            names.append(f"{name}.kernel")
        elif isinstance(m, MoeMlp):
            names += [f"{name}.wi", f"{name}.wo"]
    return names


def count_lm_params(params) -> int:
    """Parameter count of a module or a ``state_dict``."""
    tensors = params.values() if isinstance(params, Mapping) else params.parameters()
    return sum(int(t.numel()) for t in tensors)


def _lecun_normal_(w, fan_in: int, generator: torch.Generator) -> None:
    """flax's ``lecun_normal``: a normal truncated at 2 sigma, with
    std sqrt(1/fan_in) / 0.87962566103423978 (the truncation's std)."""
    nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=generator)
    w.mul_((1.0 / fan_in) ** 0.5 / 0.87962566103423978)


# Each initialised tensor is drawn in blocks of this many elements, each
# block from a ``torch.Generator`` of its own: the blocks fill in a thread
# pool, so a 124M model's ~1.5e8 draws take the host's cores, not one.
_DRAW_BLOCK = 1 << 21


def _block_generator(seed: int, tensor: int, block: int) -> torch.Generator:
    """The generator of element block ``block`` of the ``tensor``-th
    tensor that ``init_lm_weights`` draws, seeded from (seed, tensor,
    block)."""
    words = np.random.SeedSequence([seed, tensor, block]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed((int(words[0]) << 31) ^ int(words[1]))


def init_lm_weights(model: TransformerLM, seed: int) -> None:
    """The Flax initialisers' distributions from ``seed`` (not the JAX
    key's bits): dense kernels ``lecun_normal`` over their (in, out)
    fan-in (the MoE router too), the expert banks per expert over their
    input axis (``lecun_normal(batch_axis=(0,))``), the head kernel over
    its d_model axis, the embedding ``normal(0.02)``, the norm scales ones.
    The i-th drawn tensor (module order) fills block j of its elements
    (``_DRAW_BLOCK``) from ``_block_generator(seed, i, j)``, the blocks in
    a thread pool."""
    draws = []
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (QDense, Router)):
                draws.append((m.kernel, partial(_lecun_normal_, fan_in=m.kernel.shape[0])))
            elif isinstance(m, MoeMlp):
                draws.append((m.wi, partial(_lecun_normal_, fan_in=m.wi.shape[1])))
                draws.append((m.wo, partial(_lecun_normal_, fan_in=m.wo.shape[1])))
            elif isinstance(m, LMHead):
                draws.append((m.kernel, partial(_lecun_normal_, fan_in=m.kernel.shape[1])))
            elif isinstance(m, TokenEmbed):
                draws.append((m.embedding, partial(nn.init.normal_, mean=0.0, std=0.02)))
            elif isinstance(m, RMSNorm):
                nn.init.ones_(m.scale)
        blocks = [(t.view(-1)[a:a + _DRAW_BLOCK], draw, (i, a // _DRAW_BLOCK))
                  for i, (t, draw) in enumerate(draws) for a in range(0, t.numel(), _DRAW_BLOCK)]

        def fill(block) -> None:
            view, draw, (i, j) = block
            with torch.no_grad():
                draw(view, generator=_block_generator(seed, i, j))

        with ThreadPoolExecutor(max(1, min(len(blocks), os.cpu_count() or 1))) as pool:
            list(pool.map(fill, blocks))
