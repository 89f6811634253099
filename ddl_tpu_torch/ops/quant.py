"""Int8 KV cache and weight-only int8 trees for decode (counterpart of
``ddl_tpu/ops/quant.py``).

``QuantKV`` stores K/V int8 with a per-(token, head) f32 absmax scale over
``head_dim``; attention never dequantises the cache into a buffer — the
key scales multiply the scores and the value scales the probabilities.
Quantization is symmetric absmax: ``s = max(amax, 1e-12) / 127``, ``q =
clip(round(x / s), -127, 127)``, rounding half to even as ``jnp.round``.

Cache storage fuses the (Hkv, Dh) axes: a layer's K or V is (B, L,
Hkv*Dh), the scales (B, Hkv, L).  Unlike the JAX functions, which return
new arrays, ``kv_write`` and ``kv_set_slots`` write the cache tensors IN
PLACE and return the same tensors (a decode step then moves one token's
bytes, not the cache).

The weight-only int8 half works on a flat ``state_dict`` instead of a
nested tree, with the same names and layouts: ``quantize_lm_params`` turns
every matmul kernel int8 beside a sibling ``scale`` (``models/transformer``'s
``QDense`` and ``LMHead`` load and apply such a dict), and ``head_kernel``
dequantizes the head back to f32 for the loss-edge paths that read it
directly.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ddl_tpu_torch.ops.attention import dense_attention
from ddl_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_plain,
    decode_kernel_takes,
    quant_decode_attention,
    quant_decode_attention_plain,
)

__all__ = [
    "QuantKV",
    "dequantize_q8",
    "head_kernel",
    "kv_attend",
    "kv_decode",
    "kv_decode_plain",
    "kv_fuse",
    "kv_map",
    "kv_set_slots",
    "kv_slice",
    "kv_unfuse",
    "kv_write",
    "quant_dense_attention",
    "quantize_lm_params",
    "quantize_q8",
]


def quantize_q8(x, axis: int = -1):
    """Symmetric absmax int8: ``(q int8, scale f32)`` with ``scale`` kept
    along ``axis`` so ``q * scale ~ x``."""
    x32 = x.float()
    amax = x32.abs().amax(dim=axis, keepdim=True)
    scale = amax.clamp(min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_q8(q, scale, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


class QuantKV(NamedTuple):
    """Int8 KV-cache tensors of one layer: kq/vq (B, L, Hkv*Dh) int8,
    ks/vs (B, Hkv, L) f32 per-(token, head) scales, L minor so the decode
    kernel reads one contiguous row of scales per head."""

    kq: torch.Tensor
    ks: torch.Tensor
    vq: torch.Tensor
    vs: torch.Tensor


def kv_fuse(x):
    """(B, T, H, D) -> (B, T, H*D): the cache storage layout."""
    b, t = x.shape[:2]
    return x.reshape(b, t, -1)


def kv_unfuse(x, hkv: int):
    """(B, T, H*D) -> (B, T, H, D) view for the attention cores."""
    b, t, hd = x.shape
    return x.reshape(b, t, hkv, hd // hkv)


def kv_map(fn, cache):
    """Apply ``fn`` to every tensor of a cache (bf16 tuple or QuantKV),
    keeping the container type."""
    if isinstance(cache, QuantKV):
        return QuantKV(*(fn(a) for a in cache))
    return tuple(fn(a) for a in cache)


def _scale_rows(s):
    """(B, t, Hkv, 1) scales -> the (B, Hkv, t) storage layout."""
    return s[..., 0].transpose(1, 2)


def kv_write(cache, k, v, offset: int):
    """Write ``(B, t, Hkv, Dh)`` k/v at sequence positions ``offset ..
    offset + t - 1``, in place, quantizing on the way in for a
    ``QuantKV``; returns ``cache``."""
    t = k.shape[1]
    if isinstance(cache, QuantKV):
        kq, ks = quantize_q8(k)
        vq, vs = quantize_q8(v)
        cache.kq[:, offset:offset + t] = kv_fuse(kq)
        cache.ks[:, :, offset:offset + t] = _scale_rows(ks)
        cache.vq[:, offset:offset + t] = kv_fuse(vq)
        cache.vs[:, :, offset:offset + t] = _scale_rows(vs)
        return cache
    ck, cv = cache
    ck[:, offset:offset + t] = kv_fuse(k)
    cv[:, offset:offset + t] = kv_fuse(v)
    return cache


def kv_set_slots(cache, k, v, slots):
    """Write k/v rows into the (possibly non-contiguous) ring ``slots``
    along the sequence axis, in place: the rolling cache's prefill write."""
    if isinstance(cache, QuantKV):
        kq, ks = quantize_q8(k)
        vq, vs = quantize_q8(v)
        cache.kq[:, slots] = kv_fuse(kq)
        cache.ks[:, :, slots] = _scale_rows(ks)
        cache.vq[:, slots] = kv_fuse(vq)
        cache.vs[:, :, slots] = _scale_rows(vs)
        return cache
    ck, cv = cache
    ck[:, slots] = kv_fuse(k).to(ck.dtype)
    cv[:, slots] = kv_fuse(v).to(cv.dtype)
    return cache


def kv_slice(cache, start: int, span: int):
    """O(span) view of the cache along the sequence axis (the scales'
    sequence axis is their last)."""
    if isinstance(cache, QuantKV):
        return QuantKV(cache.kq.narrow(1, start, span), cache.ks.narrow(2, start, span),
                       cache.vq.narrow(1, start, span), cache.vs.narrow(2, start, span))
    return tuple(a.narrow(1, start, span) for a in cache)


def kv_decode(q, cache, bias):
    """T=1 attention over a whole cache through the decode kernels
    (``ops/decode_attention.py``); ``bias`` is (1, L) or (B, L) f32."""
    d = q.shape[-1]
    if isinstance(cache, QuantKV):
        return quant_decode_attention(q, cache.kq, cache.ks, cache.vq, cache.vs, bias,
                                      hkv=cache.kq.shape[-1] // d)
    return decode_attention(q, cache[0], cache[1], bias, hkv=cache[0].shape[-1] // d)


def kv_decode_plain(q, cache, bias):
    """``kv_decode`` through the kernels' plain versions."""
    d = q.shape[-1]
    if isinstance(cache, QuantKV):
        return quant_decode_attention_plain(q, cache.kq, cache.ks, cache.vq, cache.vs, bias,
                                            hkv=cache.kq.shape[-1] // d)
    return decode_attention_plain(q, cache[0], cache[1], bias, hkv=cache[0].shape[-1] // d)


def kv_attend(q, cache, mask, use_kernel: bool = False, decode=kv_decode):
    """Cached attention over a fused bf16 tuple or QuantKV cache.  q:
    (B, Tq, H, Dh); mask: (Tq, L) bool (True = attend), or (B, Tq, L) per
    batch row.

    ``use_kernel=True`` with a single-token query takes ``decode``
    (default ``kv_decode``, the decode kernels; ``kv_decode_plain`` runs
    their plain versions) for any L, with the mask as an additive f32 bias
    row, where ``decode_kernel_takes`` the head_dim, grouping and dtypes on
    q's device; otherwise the dense cores read the cache."""
    d = q.shape[-1]
    ck = cache.kq if isinstance(cache, QuantKV) else cache[0]
    hkv = ck.shape[-1] // d
    if use_kernel and q.shape[1] == 1 and decode_kernel_takes(
            d, q.shape[2] // hkv, q.dtype, ck.dtype, q.device.type):
        mrow = mask[:1] if mask.dim() == 2 else mask[:, 0]
        bias = torch.where(mrow, 0.0, -1e30).to(torch.float32)
        return decode(q, cache, bias)
    if isinstance(cache, QuantKV):
        return quant_dense_attention(q, kv_unfuse(cache.kq, hkv), cache.ks,
                                     kv_unfuse(cache.vq, hkv), cache.vs, mask=mask)
    return dense_attention(q, kv_unfuse(cache[0], hkv), kv_unfuse(cache[1], hkv), mask=mask)


def quant_dense_attention(q, kq, ks, vq, vs, mask):
    """Softmax attention reading an int8 K/V cache without dequantizing it.

    q: (B, Tq, H, D); kq/vq: (B, L, Hkv, D) int8; ks/vs: (B, Hkv, L).
    ``mask`` is (Tq, L) shared or (B, Tq, L) per row.  The key scales (with
    ``1/sqrt(d)``) multiply the f32 scores and the value scales the softmax
    probabilities; grouped-query by query reshape."""
    b, tq, h, d = q.shape
    hkv = kq.shape[2]
    if h % hkv:
        raise ValueError(f"q heads {h} must divide by kv heads {hkv}")
    g = h // hkv
    qg = q.reshape(b, tq, hkv, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, kq.to(q.dtype))
    scores = scores.float() * (ks[:, :, None, None, :] / math.sqrt(d))
    m = mask[None, None, None] if mask.dim() == 2 else mask[:, None, None]
    scores = scores.masked_fill(~m, -1e30)
    probs = torch.softmax(scores, -1)
    pv = (probs * vs[:, :, None, None, :]).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", pv, vq.to(q.dtype))
    return out.reshape(b, tq, h, d)


def head_kernel(state_dict, prefix: str = "lm_head."):
    """The lm_head kernel ready for a loss-edge product: dequantized back to
    f32 when the ``state_dict`` is weight-only int8, as it is otherwise."""
    k = state_dict[prefix + "kernel"]
    if prefix + "scale" in state_dict:
        return dequantize_q8(k, state_dict[prefix + "scale"])
    return k


# --- weight-only int8 ---------------------------------------------------

# leaves quantized per output channel: 2-D (in, out) matmul kernels
_DENSE_KERNELS = ("kernel",)
# MoE expert banks: (E, in, out), a scale per (expert, out-channel)
_EXPERT_KERNELS = ("wi", "wo")
_SKIP_MODULES = ("router",)  # f32 routing stays exact


def quantize_lm_params(state_dict):
    """Weight-only int8 transform of an LM ``state_dict`` for decode.

    Returns a dict with the same keys, where every matmul kernel is int8
    with a sibling scale:

    * ``<module>.kernel`` (in, out) -> int8 + ``<module>.scale`` (1, out),
      per output channel;
    * ``lm_head.kernel`` (V, D) -> int8 + ``lm_head.scale`` (V, 1), per
      vocab row (the head kernel is stored vocab-major);
    * MoE ``wi``/``wo`` (E, in, out) -> int8 + ``wi_scale``/``wo_scale``
      (E, 1, out).

    Norm scales, the router and the embedding table pass through unchanged
    (the embedding is a gather of B rows a step, not a streamed read).
    Raises ``ValueError`` when it finds no matmul kernel: a silent no-op
    would serve full-width weights while reporting int8."""
    out = {}
    n_quantized = 0
    for key, val in state_dict.items():
        *modules, leaf = key.split(".")
        parent = modules[-1] if modules else ""
        if leaf in _DENSE_KERNELS and val.dim() == 2 and parent not in _SKIP_MODULES:
            q, s = quantize_q8(val, axis=1 if parent == "lm_head" else 0)
            out[key] = q
            out[".".join([*modules, "scale"])] = s
            n_quantized += 1
        elif leaf in _EXPERT_KERNELS and val.dim() == 3:
            q, s = quantize_q8(val, axis=1)
            out[key] = q
            out[".".join([*modules, f"{leaf}_scale"])] = s
            n_quantized += 1
        else:
            out[key] = val
    if not n_quantized:
        raise ValueError(
            "quantize_lm_params found no matmul kernel to quantize: not an LM state_dict?"
        )
    return out
