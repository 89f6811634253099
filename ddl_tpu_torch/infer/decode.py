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

``obs`` (an ``obs.events.EventWriter``) turns on the JAX generator's
per-request telemetry: each call emits a ``decode_request`` span, one
``decode`` event (lengths, latency, queue delay, time to first token,
tokens/s, warm) and the ``trace_span`` chain (request, queue, prefill,
decode) that ``obs/serving.py`` and the serving engine's streams share.
The first token is fenced (read back) for a real TTFT, so a request with
``obs`` is synchronous, as a serving caller is anyway.

Not ported here (ROADMAP.md item 11): the mesh (``spec`` above one
device raises; ``devices``/``mesh``: tensor- and sequence-sharded decode).
"""

from __future__ import annotations

import os
import time
from functools import partial
from time import perf_counter
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
from ddl_tpu_torch.parallel.sharding import require_lm_one_device
from ddl_tpu_torch.utils.device import resolve_device

__all__ = ["LMDecode", "init_kv_cache", "make_lm_generator", "sample_tokens"]


class LMDecode(TransformerLM):
    """One incremental forward over the full layer stack.

    ``tokens`` (B, T): the prompt at prefill or the last sampled token;
    ``caches``: per-layer ``(k, v)`` tuples or ``QuantKV``s; ``offset``:
    positions already in the cache.  Returns (logits (B, T, V) f32, the
    caches, written in place).  ``attn_core`` serves the prefill (e.g. the
    flash kernel); single-token steps over the whole cache go through
    ``decode_attend`` (the decode kernels by default), and an int8 weight's
    products of at most 8 rows through ``int8_matmul`` (the kernel by
    default).  ``masked_prefill=True`` sends every multi-token pass, at
    offset 0 too, through the masked cached-attention branch (the serving
    engine's chunk prefill over a gathered pool view)."""

    def __init__(self, cfg: LMConfig, rolling: bool = False,
                 attn_core: Optional[Callable] = None,
                 decode_attend: Callable = kv_decode,
                 int8_matmul: Callable = int8_matmul_small_m,
                 masked_prefill: bool = False) -> None:
        super().__init__(cfg, attn_core, decode_attend, int8_matmul)
        self.rolling = rolling
        for block in self.blocks():
            block.attn.fused_prefill = not masked_prefill

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


def sample_tokens(logits, temperature: float = 0.0, top_k: int | None = None,
                  generator: Optional[torch.Generator] = None):
    """The next token of each row of ``logits`` (..., V): ``argmax`` (the
    first maximum) at ``temperature=0``; otherwise the Gumbel-max draw from
    ``softmax(logits / temperature)`` with noise from ``generator``,
    optionally restricted to the logits at or above the ``top_k``-th
    largest.  A (1, V) row draws V exponentials, so a request that owns its
    generator draws the same noise in a batch-1 generator and in a serving
    lane."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    gumbel = -torch.empty_like(logits).exponential_(generator=generator).log()
    return torch.argmax(logits / temperature + gumbel, dim=-1)


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
    obs=None,
    spec=None,
):
    """Build ``generate(params, prompt, generator=None, submitted_at=None)
    -> tokens``.

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
    stay int8), and the cache tensors are written in place.

    ``obs``: per-request telemetry (module docstring); ``submitted_at`` (a
    ``perf_counter`` value) is the request's enqueue time, whose gap to
    the call is its ``queue_delay`` (0.0 without it).  The first request
    of a generator is flagged cold (``warm=False``): it builds the
    kernels and warms the allocator and cuBLAS.  ``DDL_OBS_TRACE_SAMPLE=N``
    traces one request in N, by sequence number.

    ``spec`` (an ``LMMeshSpec``; None is one device): any axis above 1
    raises ``NotImplementedError``, sharded decode being ROADMAP item 11."""
    require_lm_one_device(spec, "make_lm_generator")
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

    def decode(prompt, generator, first_token=None):
        with torch.inference_mode():
            caches = init_kv_cache(cfg, batch, max_len, rolling=rolling, quant=kv_quant,
                                   device=device)
            logits, caches = model(prompt.to(device=device, dtype=torch.long), caches, 0,
                                   last_only=True)
            last = logits[:, -1]
            toks = []
            for i in range(max_new):
                tok = sample_tokens(last, temperature, top_k, generator)
                toks.append(tok)
                if i == 0 and first_token is not None:
                    first_token(tok)
                logits, caches = model(tok[:, None], caches, prompt_len + i)
                last = logits[:, 0]
            return torch.stack(toks, dim=1)

    state = {"warm": False, "seq": 0}
    try:
        trace_sample = max(1, int(os.environ.get("DDL_OBS_TRACE_SAMPLE") or 1))
    except ValueError:
        trace_sample = 1

    def trace_span(name, t0_pc, t1_pc, *, trace, span, parent, **args):
        wall, pc = time.time(), perf_counter()
        obs.emit("trace_span", trace=trace, span=span, parent=parent, name=name,
                 cat="decode", t0=wall - (pc - t0_pc), t1=wall - (pc - t1_pc), **args)

    def observed(prompt, generator, submitted_at):
        warm, state["warm"] = state["warm"], True
        req_id = f"{obs.run_id[:8]}-d{state['seq']}"
        traced = state["seq"] % trace_sample == 0
        state["seq"] += 1
        t0 = perf_counter()
        queue_delay = max(0.0, t0 - submitted_at) if submitted_at is not None else 0.0
        first = {}

        def first_token(tok):
            with obs.span("first_token"):
                tok.cpu()  # fences the first token: a real TTFT
            first["t"] = perf_counter()

        with obs.span("decode_request", prompt_len=prompt_len, max_new=max_new, batch=batch):
            with obs.span("dispatch"):
                toks = decode(prompt, generator, first_token)
            with obs.span("wait"):
                toks.cpu()  # fences the last token
        end = perf_counter()
        dur, ttft = end - t0, first["t"] - t0
        if traced:
            root_t0 = submitted_at if submitted_at is not None else t0
            trace_span("request", root_t0, end, trace=req_id, span=f"{req_id}/req", parent=None,
                       request_id=req_id, prompt_len=prompt_len, new_tokens=max_new,
                       outcome="ok", dispatches=1)
            if submitted_at is not None and submitted_at < t0:
                trace_span("queue", submitted_at, t0, trace=req_id, span=f"{req_id}/queue",
                           parent=f"{req_id}/req", request_id=req_id)
            trace_span("prefill", t0, first["t"], trace=req_id, span=f"{req_id}/prefill",
                       parent=f"{req_id}/req", tokens=prompt_len)
            trace_span("decode", first["t"], end, trace=req_id, span=f"{req_id}/d0",
                       parent=f"{req_id}/req", dispatch=0, new_tokens=max_new)
        obs.emit(
            "decode", request_id=req_id, prompt_len=prompt_len, new_tokens=max_new,
            batch=batch, dur=dur, queue_delay=queue_delay, ttft=ttft,
            tok_per_s=batch * max_new / dur if dur > 0 else None,
            decode_tok_per_s=(batch * (max_new - 1) / (dur - ttft)
                              if max_new > 1 and dur > ttft else None),
            warm=warm,
        )
        return toks

    def generate(params: Mapping[str, torch.Tensor], prompt, generator=None,
                 submitted_at: float | None = None):
        weights = {k: v.to(device=device, dtype=cfg.dtype if k in cast_names
                           and v.is_floating_point() else v.dtype)
                   for k, v in params.items()}
        model.load_state_dict(weights, assign=True)
        if generator is None and temperature != 0.0:
            generator = torch.Generator(device).manual_seed(0)
        if obs is None:
            return decode(prompt, generator)
        return observed(prompt, generator, submitted_at)

    generate.model = model
    return generate
