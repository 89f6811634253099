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
V per layer, ~16 us at 3.35 TB/s) for a few operations per element.  The
bf16 kernel (#7): one CTA per (K/V head, batch row) whose eight warps each
walk their own chunks of L with their own online softmax, met once through
shared memory.  The int8 kernel (#8) splits the keys across CTAs so that
the grid fills the card at any batch: ``decode_split_plan`` (cached per
shape) picks a CTA per (key range, block of K/V heads, batch row), whose K
and V rows arrive by bulk copies; scores on the tensor cores, the softmax
and P.V in f32; each range's (acc, m, l) goes to an f32 workspace that a
second launch combines in range order (``decode_split_combine_plain`` is
the same arithmetic in PyTorch; ``decode_attention.cu`` has the full
note).  The TPU-only tiling (``block_l``, ``pick_block_l``: Mosaic's VMEM
budget and 128-lane rule) is gone; the kernels take any L.

Numerics follow the TPU kernels: scores ``(q . k) * scale + bias`` in f32
(int8: ``(q . kq) * (ks * scale) + bias``), ``scale = 1/sqrt(D)`` as a
multiply, an online softmax whose masked scores (``s <= -1e29``) give
``p = 0``, the value scale folded into the probabilities after the sum,
and ``out = acc / max(l, 1e-30)`` in the query dtype.  ``bias`` is an
additive f32 mask, (1, L) shared by the batch or (B, L) one row per lane.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from ddl_tpu_torch.ops import _build
from ddl_tpu_torch.ops._build import H100_SMS

__all__ = [
    "DecodeSplitPlan",
    "decode_attention",
    "decode_attention_plain",
    "decode_kernel_takes",
    "decode_split_combine_plain",
    "decode_split_plan",
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
        *[ctypes.c_int] * 5, ctypes.c_float, *[ctypes.c_int] * 3, ctypes.c_void_p,
        ctypes.c_void_p,
    ],
    "ddl_quant_decode_smem": [ctypes.c_int] * 5,
}
# The int8 kernel's split (csrc/decode_attention.cu): the shared memory a
# split CTA may take, 64 KB so that three share an SM (the copies of one
# CTA wait on device memory; the others compute).
_SPLIT_SMEM = 65536
_CHUNK = 32


def _round16(v: int) -> int:
    return -(-v // 16) * 16


def split_smem(hkv: int, heads: int, keys: int, d: int, g: int) -> int:
    """Shared memory of a split CTA of ``heads`` of the ``hkv`` K/V heads
    and ``keys`` keys (the C side's ``split_smem``): K and V staged as whole
    cache rows (16-key rounded), the scores [heads][G][keys] f32, the two
    scales, the bias, the queries in bf16, one mbarrier per 32 keys."""
    k16 = _round16(keys)
    return (2 * k16 * hkv * d + 4 * heads * g * k16 + 8 * heads * k16 + 4 * k16
            + 2 * heads * g * d + 8 * -(-keys // _CHUNK))


@dataclasses.dataclass(frozen=True)
class DecodeSplitPlan:
    """The int8 kernel's grid: ``splits`` ranges of ``keys`` keys (the last
    may be shorter) per batch row, over blocks of ``heads`` K/V heads."""

    heads: int
    keys: int
    splits: int
    smem: int

    def ctas(self, b: int, hkv: int) -> int:
        return self.splits * (hkv // self.heads) * b

    def ranges(self, L: int) -> list[tuple[int, int]]:
        """(first key, number of keys) of each split."""
        return [(s * self.keys, max(0, min(self.keys, L - s * self.keys)))
                for s in range(self.splits)]


@functools.lru_cache(maxsize=None)
def decode_split_plan(b: int, L: int, hkv: int, g: int, d: int,
                      sms: int = H100_SMS) -> DecodeSplitPlan:
    """How the int8 decode kernel splits a (B, L, Hkv*D) cache with G query
    heads per K/V head over a card of ``sms`` SMs.  A CTA takes every K/V
    head and as many keys as 64 KB of shared memory holds, when the batch
    rows alone then give every SM a CTA; otherwise one head and ``L //
    ceil(sms / (B * Hkv))`` keys (at most as many as fit), so that at least
    ``sms`` CTAs run.  Either way a CTA stages whole cache rows of its keys
    (one bulk copy per 32 keys and cache), so ranges cover each key once
    and every copy starts on a 16-byte boundary (rows of Hkv*D int8 bytes,
    D a multiple of 16)."""
    L = max(L, 1)

    def most_keys(heads: int) -> int:
        keys = 16
        while split_smem(hkv, heads, keys + 16, d, g) <= _SPLIT_SMEM:
            keys += 16
        return keys

    keys = min(most_keys(hkv), _round16(L))
    if b * -(-L // keys) >= sms:
        heads = hkv
    else:
        heads = 1
        keys = max(1, min(most_keys(1), L // -(-sms // (b * hkv))))
    return DecodeSplitPlan(heads, keys, -(-L // keys), split_smem(hkv, heads, keys, d, g))


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


def decode_split_combine_plain(q, ck, cv, bias, *, hkv: int, keys: int, splits: int,
                               ks=None, vs=None):
    """The int8 kernel's arithmetic in PyTorch (f32): the keys cut into
    ``splits`` ranges of ``keys`` (ranges past L are empty), each range's
    (m, l, acc) as a split CTA leaves them (m from -1e30, p = 0 where s <=
    -1e29, the value scale after the sum), then the fixed-order combine
    ``sum e^(m_s - M) acc_s / max(sum e^(m_s - M) l_s, 1e-30)``.  A bf16
    cache without scales takes the same path."""
    _check_args(q, ck, cv, bias, hkv)
    b, _, h, d = q.shape
    L = ck.shape[1]
    scale = 1.0 / math.sqrt(d)
    qg = q[:, 0].float().reshape(b, hkv, h // hkv, d)
    k = ck.float().reshape(b, L, hkv, d)
    v = cv.float().reshape(b, L, hkv, d)
    parts = []
    for s in range(splits):
        lo, hi = min(s * keys, L), min((s + 1) * keys, L)
        dots = torch.einsum("bhgd,blhd->bhgl", qg, k[:, lo:hi])
        kscale = scale if ks is None else ks[:, :, None, lo:hi] * scale
        sc = dots * kscale + bias[:, None, None, lo:hi]
        m = torch.cat([sc, sc.new_full((*sc.shape[:-1], 1), -1e30)], -1).amax(-1, keepdim=True)
        p = torch.where(sc > -1e29, torch.exp(sc - m), 0.0)
        lsum = p.sum(-1, keepdim=True)
        if vs is not None:
            p = p * vs[:, :, None, lo:hi]
        parts.append((m, lsum, torch.einsum("bhgl,blhd->bhgd", p, v[:, lo:hi])))
    top = parts[0][0]
    for m, _, _ in parts[1:]:
        top = torch.maximum(top, m)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for m, lsum, acc in parts:
        f = torch.exp(m - top)
        num = num + f * acc
        den = den + f * lsum
    return (num / den.clamp(min=1e-30)).reshape(b, 1, h, d).to(q.dtype)


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
    L, g = ck.shape[1], h // hkv
    index = q.device.index or 0
    plan = decode_split_plan(b, L, hkv, g, d, _build.sm_count(index))
    ws = torch.empty(b * hkv * g * plan.splits * (d + 2), dtype=torch.float32, device=q.device)
    lib = _build.load("decode_attention", _SIGNATURES)
    err = lib.ddl_quant_decode_attention(
        index, q.data_ptr(), ck.data_ptr(), ks.data_ptr(), cv.data_ptr(), vs.data_ptr(),
        bias.data_ptr(), _bias_stride(bias), out.data_ptr(), b, L, hkv, g, d,
        ctypes.c_float(1.0 / math.sqrt(d)), plan.heads, plan.keys, plan.splits, ws.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "quant decode attention kernel")
    quant_decode_attention.launches += 1
    return out


quant_decode_attention.launches = 0
