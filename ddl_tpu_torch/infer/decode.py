"""KV-cached autoregressive generation for the transformer LM (counterpart
of ``ddl_tpu/infer/decode.py``, one device).

``LMDecode`` is ``TransformerLM`` with an incremental forward: the same
parameter names, so a ``TransformerLM`` ``state_dict`` (or a JAX tree
through ``models.convert.lm_params_from_jax``) decodes as it is.  The KV
cache is a static (B, L, Hkv*Dh) buffer per layer (int8 plus f32 scales
with ``kv_quant``), written in place.  The JAX generator is one jitted
program; here the same steps run eagerly, in the same order: the prompt
pass (through the flash kernel when ``cfg.flash`` resolves to it), then
``max_new`` single-token steps, each of which samples from the last
logits and feeds the token back, so a run calls the decode attention
``n_layers * max_new`` times.

Weight-only int8: pass ``ops.quant.quantize_lm_params(params)`` as the
params, as with the JAX generator; no generator flag is needed (``QDense``
and ``LMHead`` load the int8 kernels with their scales, and every product
of at most 8 rows goes through the int8 matmul kernel).

Not ported here (ROADMAP.md): the mesh arguments (``spec``/``devices``/
``mesh``: tensor- and sequence-sharded decode), and the ``obs`` telemetry
and its two-program TTFT split.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Mapping, Optional

import torch

from ddl_tpu_torch.models.transformer import (
    LMConfig,
    TransformerLM,
    apply_final_norm_and_head,
    dense_kernel_names,
)
from ddl_tpu_torch.ops.flash_attention import (
    flash_attention,
    require_flash_kernel,
    use_flash,
)
from ddl_tpu_torch.ops.int8_matvec import int8_matmul_small_m
from ddl_tpu_torch.ops.quant import QuantKV, kv_decode
from ddl_tpu_torch.utils.device import resolve_device

__all__ = ["LMDecode", "init_kv_cache", "make_lm_generator"]


class LMDecode(TransformerLM):
    """One incremental forward over the full layer stack.

    ``tokens`` (B, T): the prompt at prefill or the last sampled token;
    ``caches``: per-layer ``(k, v)`` tuples or ``QuantKV``s; ``offset``:
    positions already in the cache.  Returns (logits (B, T, V) f32, the
    caches, written in place).  ``attn_core`` serves the prefill (e.g. the
    flash kernel); single-token steps over the whole cache go through
    ``decode_attend`` (the decode kernels by default), and an int8 weight's
    products of at most 8 rows through ``int8_matmul`` (the kernel by
    default)."""

    def __init__(self, cfg: LMConfig, rolling: bool = False,
                 attn_core: Optional[Callable] = None,
                 decode_attend: Callable = kv_decode,
                 int8_matmul: Callable = int8_matmul_small_m) -> None:
        super().__init__(cfg, attn_core, decode_attend, int8_matmul)
        self.rolling = rolling

    def forward(self, tokens, caches, offset: int, last_only: bool = False,
                last_index: Optional[int] = None):
        x = self.embed(tokens)
        new_caches = []
        for block, cache in zip(self.blocks(), caches):
            x, _, c = block(x, cache, offset, rolling=self.rolling)
            new_caches.append(c)
        if last_index is not None:
            # a right-padded prefill's next-token logits sit at the true
            # prompt end; slicing before the head keeps the (B, 1, D) shape
            x = x[:, last_index:last_index + 1]
        elif last_only:
            x = x[:, -1:]
        return apply_final_norm_and_head(self, x), tuple(new_caches)


def init_kv_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
                  rolling: bool = False, quant: bool = False, device=None) -> tuple:
    """Per-layer zeroed ``(k, v)`` buffers of shape (B, L, Hkv*Dh), each
    its own tensor (they are written in place).

    ``L`` is ``max_len``, or ``min(max_len, attn_window)`` with
    ``rolling=True`` (the ring holds only the window).  ``quant=True``
    allocates ``QuantKV`` tensors instead: int8 K/V and (B, Hkv, L) f32
    scales."""
    if rolling and not cfg.attn_window:
        raise ValueError("rolling cache requires cfg.attn_window > 0")
    if quant and dtype is not None:
        raise ValueError(
            "quant=True fixes the cache layout (int8 + f32 scales); "
            "dtype cannot be combined with it"
        )
    dtype = dtype or cfg.dtype
    length = min(max_len, cfg.attn_window) if rolling else max_len
    shape = (batch, length, cfg.kv_heads * cfg.head_dim)
    if quant:
        def zq():
            return torch.zeros(shape, dtype=torch.int8, device=device)

        def zs():
            return torch.zeros((batch, cfg.kv_heads, length), device=device)

        return tuple(QuantKV(zq(), zs(), zq(), zs()) for _ in range(cfg.n_layers))
    return tuple((torch.zeros(shape, dtype=dtype, device=device),
                  torch.zeros(shape, dtype=dtype, device=device))
                 for _ in range(cfg.n_layers))


def make_lm_generator(
    cfg: LMConfig,
    *,
    prompt_len: int,
    max_new: int,
    batch: int = 1,
    temperature: float = 0.0,
    top_k: int | None = None,
    max_len: int | None = None,
    rolling: bool | None = None,
    kv_quant: bool = False,
    device=None,
):
    """Build ``generate(params, prompt, generator=None) -> tokens``.

    ``params`` is a ``TransformerLM`` ``state_dict`` (f32 masters, or the
    weight-only int8 dict of ``ops.quant.quantize_lm_params``);
    ``prompt`` (B, prompt_len) integer tokens; the result is (B, max_new)
    int64.  ``temperature=0`` decodes greedily (``argmax``: the first
    maximum); otherwise tokens are drawn from ``softmax(logits /
    temperature)`` by the Gumbel-max rule with noise from ``generator``
    (a ``torch.Generator`` on the device; default seeded 0), optionally
    restricted to the logits at or above the ``top_k``-th largest.

    ``max_len`` is the KV-cache capacity (default ``prompt_len +
    max_new``); without a window every step reads the whole capacity under
    a mask, so its cost follows the capacity, not the position.
    ``rolling`` selects the O(window) ring cache (None: on when
    ``cfg.attn_window`` is set and below ``max_len``).  ``kv_quant=True``
    stores the cache int8 with per-(token, head) scales.

    ``device`` None means CUDA and raises without it; the tests pass
    ``"cpu"``, where every kernel wrapper runs its plain version.  The
    dense kernels' f32 masters are cast to the compute dtype once per
    call (the cast every step would repeat is deterministic; int8 kernels
    stay int8), and the cache tensors are written in place."""
    if max_len is None:
        max_len = prompt_len + max_new
    elif max_len < prompt_len + max_new:
        raise ValueError(
            f"max_len {max_len} < prompt_len + max_new ({prompt_len} + {max_new})"
        )
    if rolling is None:
        rolling = bool(cfg.attn_window) and cfg.attn_window < max_len
    if rolling and not cfg.attn_window:
        raise ValueError("rolling=True requires cfg.attn_window > 0")
    if not cfg.causal:
        raise ValueError(
            "autoregressive decode requires a causal LM (cfg.causal=True); "
            "bidirectional-encoder configs (e.g. ViT's) have no decode order"
        )
    if top_k is not None:
        if temperature == 0.0:
            raise ValueError(
                "top_k has no effect with temperature=0 (greedy decoding); "
                "set a temperature or drop top_k"
            )
        if not 1 <= top_k <= cfg.vocab_size:
            raise ValueError(f"top_k {top_k} out of range [1, vocab_size={cfg.vocab_size}]")
    device = resolve_device(device)
    require_flash_kernel(cfg, device.type)
    attn_core = None
    if use_flash(cfg, prompt_len, device.type):
        attn_core = partial(flash_attention, causal=True, window=cfg.attn_window)
    with torch.device("meta"):
        model = LMDecode(cfg, rolling=rolling, attn_core=attn_core)
    cast_names = set(dense_kernel_names(model))

    def sample(logits, gen):
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        if top_k is not None:
            kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
            logits = logits.masked_fill(logits < kth, float("-inf"))
        gumbel = -torch.empty_like(logits).exponential_(generator=gen).log()
        return torch.argmax(logits / temperature + gumbel, dim=-1)

    def generate(params: Mapping[str, torch.Tensor], prompt, generator=None):
        weights = {k: v.to(device=device, dtype=cfg.dtype if k in cast_names
                           and v.is_floating_point() else v.dtype)
                   for k, v in params.items()}
        model.load_state_dict(weights, assign=True)
        if generator is None and temperature != 0.0:
            generator = torch.Generator(device).manual_seed(0)
        with torch.inference_mode():
            caches = init_kv_cache(cfg, batch, max_len, rolling=rolling, quant=kv_quant,
                                   device=device)
            logits, caches = model(prompt.to(device=device, dtype=torch.long), caches, 0,
                                   last_only=True)
            last = logits[:, -1]
            toks = []
            for i in range(max_new):
                tok = sample(last, generator)
                toks.append(tok)
                logits, caches = model(tok[:, None], caches, prompt_len + i)
                last = logits[:, 0]
            return torch.stack(toks, dim=1)

    generate.model = model
    return generate
