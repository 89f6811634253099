"""Single-token decode attention over the fused KV cache: the CUDA kernels
and their plain versions.

Counterpart of ``ddl_tpu/ops/decode_attention.py``.  The CUDA source
``ddl_tpu_torch/csrc/decode_attention.cu`` replaces the TPU kernels
``ddl_tpu/ops/decode_attention.py:67`` (``_kernel``, bf16 cache, reached
through ``decode_attention``) and ``:105`` (``_quant_kernel``, int8 cache
with per-(token, head) f32 scales, reached through
``quant_decode_attention``).

Bound on the H100: bytes.  A step reads the whole cache once (variant A
of the 124M decode, B=8 and a 2176-row cache of 12 heads: 53.5 MB of K and
V per layer, ~16 us at 3.35 TB/s) for a few operations per element.
Design: one CTA per (K/V head, batch row) whose eight warps each walk
their own chunks of L with their own online softmax, 16-byte (bf16) or
8-byte (int8) loads with several in flight per thread, one combine of the
warps through shared memory at the end (``decode_attention.cu`` has the
full note).  The grid is B x Hkv CTAs, small at small batch: a split over
L with a second combine pass is the first later optimisation.  The
TPU-only tiling (``block_l``, ``pick_block_l``: Mosaic's VMEM budget and
128-lane rule) is gone; the kernel takes any L.

Numerics follow the TPU kernels: scores ``(q . k) * scale + bias`` in f32
(int8: ``(q . kq) * (ks * scale) + bias``), ``scale = 1/sqrt(D)`` as a
multiply, an online softmax whose masked scores (``s <= -1e29``) give
``p = 0``, the value scale folded into the probabilities after the sum,
and ``out = acc / max(l, 1e-30)`` in the query dtype.  ``bias`` is an
additive f32 mask, (1, L) shared by the batch or (B, L) one row per lane.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ddl_tpu_torch.ops import _build

__all__ = [
    "decode_attention",
    "decode_attention_plain",
    "decode_kernel_takes",
    "quant_decode_attention",
    "quant_decode_attention_plain",
]

# the (head_dim, query heads per K/V head) the kernel is built for (every
# grouping the decode bench's --sweep picks is in 1-8), each pair checked
# on the card by chip_smoke.py
_HEAD_DIMS = (64, 128)
_GROUPS = tuple(range(1, 9))
_SIGNATURES = {
    "ddl_decode_attention": [
        ctypes.c_int, *[ctypes.c_void_p] * 4, ctypes.c_longlong, ctypes.c_void_p,
        *[ctypes.c_int] * 5, ctypes.c_float, ctypes.c_void_p,
    ],
    "ddl_quant_decode_attention": [
        ctypes.c_int, *[ctypes.c_void_p] * 6, ctypes.c_longlong, ctypes.c_void_p,
        *[ctypes.c_int] * 5, ctypes.c_float, ctypes.c_void_p,
    ],
}


def decode_kernel_takes(head_dim: int, groups: int, dtype, cache_dtype, device_type: str) -> bool:
    """Whether a single-token step with ``groups`` query heads per K/V head
    of ``head_dim``, a ``dtype`` query and a ``cache_dtype`` cache launches
    a decode kernel.  Off CUDA the wrappers run their plain versions, which
    take every shape; on CUDA the kernels take what ``_check_kernel_args``
    accepts: a bf16 query, a bf16 or int8 cache, the built head dims and
    groupings.  Call sites route what this refuses to the dense attention
    cores, as the JAX package keeps its einsum path where
    ``pick_block_l`` finds no tile."""
    if device_type != "cuda":
        return True
    return (head_dim in _HEAD_DIMS and groups in _GROUPS and dtype == torch.bfloat16
            and cache_dtype in (torch.bfloat16, torch.int8))


def _check_args(q, ck, cv, bias, hkv: int) -> None:
    """Shapes both paths require: q (B, 1, H, D), cache (B, L, Hkv*D),
    bias (1, L) or (B, L)."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"decode attention takes q of shape (B, 1, H, D), got {tuple(q.shape)}")
    b, _, h, d = q.shape
    if h % hkv:
        raise ValueError(f"q heads {h} must divide by kv heads {hkv}")
    if ck.dim() != 3 or ck.shape[0] != b or ck.shape[2] != hkv * d or cv.shape != ck.shape:
        raise ValueError(
            f"decode attention: cache {tuple(ck.shape)} / {tuple(cv.shape)} is not "
            f"(B={b}, L, Hkv*D={hkv * d})"
        )
    if bias.dim() != 2 or bias.shape[1] != ck.shape[1] or bias.shape[0] not in (1, b):
        raise ValueError(
            f"bias {tuple(bias.shape)} must be (1, L) (shared) or (B, L) (per-lane) "
            f"with B={b}, L={ck.shape[1]}"
        )


def _attend_plain(q, k, v, bias, hkv, ks=None, vs=None):
    b, _, h, d = q.shape
    L = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qg = q[:, 0].float().reshape(b, hkv, h // hkv, d)
    dots = torch.einsum("bhgd,blhd->bhgl", qg, k.float().reshape(b, L, hkv, d))
    if ks is None:
        s = dots * scale + bias[:, None, None, :]
    else:
        s = dots * (ks[:, :, None, :] * scale) + bias[:, None, None, :]
    m = s.amax(-1, keepdim=True).clamp(min=-1e30)
    p = torch.where(s > -1e29, torch.exp(s - m), 0.0)
    denom = p.sum(-1, keepdim=True).clamp(min=1e-30)
    if vs is not None:
        p = p * vs[:, :, None, :]
    acc = torch.einsum("bhgl,blhd->bhgd", p, v.float().reshape(b, L, hkv, d))
    return (acc / denom).reshape(b, 1, h, d).to(q.dtype)


def decode_attention_plain(q, ck, cv, bias, *, hkv: int):
    """The TPU kernel's arithmetic over the whole cache as one tile."""
    _check_args(q, ck, cv, bias, hkv)
    return _attend_plain(q, ck, cv, bias, hkv)


def quant_decode_attention_plain(q, ck, ks, cv, vs, bias, *, hkv: int):
    """The int8 TPU kernel's arithmetic over the whole cache as one tile."""
    _check_args(q, ck, cv, bias, hkv)
    return _attend_plain(q, ck, cv, bias, hkv, ks, vs)


def _check_kernel_args(q, ck, cv, bias, hkv, cache_dtype, scales=()) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"decode attention kernel: unsupported device {q.device}")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"decode attention kernel takes a bf16 query, got {q.dtype}")
    for name, x, dt in (("ck", ck, cache_dtype), ("cv", cv, cache_dtype),
                        ("bias", bias, torch.float32),
                        *((n, s, torch.float32) for n, s in scales)):
        if x.dtype != dt:
            raise ValueError(f"decode attention kernel: {name} must be {dt}, got {x.dtype}")
    for name, x in (("q", q), ("ck", ck), ("cv", cv), ("bias", bias), *scales):
        if x.device != q.device:
            raise ValueError(f"decode attention kernel: {name} on {x.device}, q on {q.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"decode attention kernel: {name} must be contiguous and 16-byte aligned")
    b, _, h, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"decode attention kernel takes head_dim in {_HEAD_DIMS}, got {d}")
    if h // hkv not in _GROUPS:
        raise ValueError(
            f"decode attention kernel takes {_GROUPS} query heads per K/V head, got {h // hkv}"
        )
    for name, s in scales:
        if s.shape != (b, hkv, ck.shape[1]):
            raise ValueError(f"{name} {tuple(s.shape)} is not (B, Hkv, L) = {(b, hkv, ck.shape[1])}")


def _bias_stride(bias) -> int:
    return 0 if bias.shape[0] == 1 else bias.shape[1]


def decode_attention(q, ck, cv, bias, *, hkv: int):
    """q: (B, 1, H, D); ck/cv: (B, L, Hkv*D) bf16 fused cache; bias: (1, L)
    f32 additive mask shared across the batch, or (B, L) per lane.
    Returns (B, 1, H, D) in ``q.dtype``.

    A CPU tensor goes through ``decode_attention_plain``; a CUDA tensor
    launches the kernel on the current stream (no synchronisation) or
    raises."""
    _check_args(q, ck, cv, bias, hkv)
    if q.device.type == "cpu":
        return decode_attention_plain(q, ck, cv, bias, hkv=hkv)
    _check_kernel_args(q, ck, cv, bias, hkv, torch.bfloat16)
    b, _, h, d = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.load("decode_attention", _SIGNATURES)
    err = lib.ddl_decode_attention(
        q.device.index or 0, q.data_ptr(), ck.data_ptr(), cv.data_ptr(), bias.data_ptr(),
        _bias_stride(bias), out.data_ptr(), b, ck.shape[1], hkv, h // hkv, d,
        ctypes.c_float(1.0 / math.sqrt(d)), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "decode attention kernel")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def quant_decode_attention(q, ck, ks, cv, vs, bias, *, hkv: int):
    """q: (B, 1, H, D); ck/cv: (B, L, Hkv*D) int8 fused cache; ks/vs:
    (B, Hkv, L) f32 per-(token, head) scales; bias as ``decode_attention``.
    The key scale multiplies the scores and the value scale the
    probabilities; the cache is never dequantised into a buffer.

    A CPU tensor goes through ``quant_decode_attention_plain``; a CUDA
    tensor launches the kernel on the current stream or raises."""
    _check_args(q, ck, cv, bias, hkv)
    if q.device.type == "cpu":
        return quant_decode_attention_plain(q, ck, ks, cv, vs, bias, hkv=hkv)
    _check_kernel_args(q, ck, cv, bias, hkv, torch.int8, (("ks", ks), ("vs", vs)))
    b, _, h, d = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.load("decode_attention", _SIGNATURES)
    err = lib.ddl_quant_decode_attention(
        q.device.index or 0, q.data_ptr(), ck.data_ptr(), ks.data_ptr(), cv.data_ptr(),
        vs.data_ptr(), bias.data_ptr(), _bias_stride(bias), out.data_ptr(), b, ck.shape[1],
        hkv, h // hkv, d, ctypes.c_float(1.0 / math.sqrt(d)),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "quant decode attention kernel")
    quant_decode_attention.launches += 1
    return out


quant_decode_attention.launches = 0
