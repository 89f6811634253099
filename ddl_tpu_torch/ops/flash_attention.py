"""Flash-attention forward: the CUDA kernel and its plain version.

Counterpart of ``ddl_tpu/ops/flash_attention.py`` (forward only; the
backward kernels ``_dq_kernel``/``_dkdv_kernel`` come with LM training).
The CUDA kernel ``ddl_tpu_torch/csrc/flash_attention_fwd.cu`` replaces the
TPU kernel ``ddl_tpu/ops/flash_attention.py:84`` (``_fwd_kernel``, reached
through ``_flash_fwd_impl``).

Bound on the H100: tensor-core operations (causal (8, 2048, 12, 64): 51.6
GFLOP over 101 MB, ~52 us at 989 TFLOP/s bf16).  Design: one CTA of four
warps per (batch x head, 64-row query tile), ``mma.sync`` bf16 products
with f32 accumulation, the online softmax in registers, 64-row K/V tiles
double-buffered through shared memory with ``cp.async``, key tiles
outside the causal/window/``kv_offset`` band skipped (``_qk_live``), ragged
T masked in the kernel, and the (B, T, H, D) projections read through
their strides (``flash_attention_fwd.cu`` has the full note).  The TPU's
``block_q``/``block_k``/``interpret`` arguments are TPU tiling and are
gone: the kernel picks its own tiles.

Numerics: the TPU kernel's own (``_fwd_kernel`` :104-130) — f32 scores of
the bf16 values, a max-subtracted online softmax, probabilities zeroed
where the score is masked, ``out = acc / max(l, 1e-30)`` and ``lse = m +
log(max(l, 1e-30))``.  A row that sees no key (possible with
``kv_offset``) has output 0 and lse ``-1e30 + log(1e-30)``.  The kernel
rounds P to bf16 before the P.V product (the TPU kernel keeps it in f32),
so it agrees with ``flash_attention_with_lse_plain`` to bf16 precision, not
bit for bit.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ddl_tpu_torch.ops import _build

__all__ = [
    "FLASH_AUTO_MIN_T",
    "flash_attention",
    "flash_attention_plain",
    "flash_attention_with_lse",
    "flash_attention_with_lse_plain",
    "use_flash",
]

_NEG_INF = -1e30

# Prompt length from which ``flash="auto"`` takes the kernel for the prefill.
# Set from the 124M prompt pass, dense vs flash at B=1 and T in {256, 512,
# 1024, 2048, 4096}, timed by chip_smoke.py on one H100 80GB HBM3 (700 W):
# flash's device time is below dense's at every T of the sweep (1.837 vs
# 2.046 ms at T=256, 8.568 vs 46.690 ms at T=4096; PERF.md), so the
# smallest T from which it stays faster is the sweep's first.  Shorter
# prompts were not measured and stay dense.
FLASH_AUTO_MIN_T = 256

_HEAD_DIMS = (64, 128)
_SIGNATURES = {
    "ddl_flash_attention_fwd": [
        ctypes.c_int, *[ctypes.c_void_p] * 5, *[ctypes.c_int] * 5,
        *[ctypes.c_longlong] * 9, ctypes.c_float, *[ctypes.c_int] * 3, ctypes.c_void_p,
    ],
}


def use_flash(cfg, seq_len: int) -> bool:
    """Whether a causal pass over ``seq_len`` positions takes the flash
    kernel: ``cfg.flash`` True, or ``"auto"`` at or past
    ``FLASH_AUTO_MIN_T``."""
    if not cfg.causal:
        return False
    return cfg.flash is True or (cfg.flash == "auto" and seq_len >= FLASH_AUTO_MIN_T)


def _validate_flash_args(q, k, v, causal, window, kv_offset=0):
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window and not causal:
        raise ValueError("window > 0 requires causal=True (sliding causal window)")
    if kv_offset < 0:
        raise ValueError(f"kv_offset must be >= 0, got {kv_offset}")
    if kv_offset and not causal:
        raise ValueError(
            "kv_offset shifts the causal/window band; it requires causal=True"
        )
    h, hkv = q.shape[2], k.shape[2]
    if v.shape[2] != hkv:
        raise ValueError(f"k has {hkv} heads but v has {v.shape[2]}")
    if h % hkv:
        raise ValueError(f"q heads {h} must divide by kv heads {hkv}")
    return h, hkv


def flash_attention_with_lse_plain(q, k, v, causal: bool = False, window: int = 0,
                                   kv_offset: int = 0):
    """The TPU kernel's math in f32 over whole rows: ``(q . k) * scale``,
    the ``_causal_mask`` band, a max-subtracted softmax with masked
    probabilities zeroed.  Returns (out in ``q.dtype``, lse (B, H, T) f32).
    Grouped K/V by query reshape, never repeated."""
    h, hkv = _validate_flash_args(q, k, v, causal, window, kv_offset)
    b, t, _, d = q.shape
    g = h // hkv
    qg = q.float().reshape(b, t, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (1.0 / math.sqrt(d))
    if causal:
        q_pos = torch.arange(t, device=q.device)[:, None]
        k_pos = torch.arange(t, device=q.device)[None, :] - kv_offset
        keep = k_pos <= q_pos
        if window:
            keep &= k_pos > q_pos - window
        s = s.masked_fill(~keep, _NEG_INF)
    m = s.amax(-1, keepdim=True).clamp(min=_NEG_INF)
    p = torch.where(s > _NEG_INF / 2, torch.exp(s - m), 0.0)
    denom = p.sum(-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float()) / denom.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(denom)).reshape(b, h, t)
    return out.reshape(b, t, h, d).to(q.dtype), lse


def flash_attention_plain(q, k, v, causal: bool = False, window: int = 0,
                          kv_offset: int = 0):
    """``flash_attention_with_lse_plain`` without the lse."""
    return flash_attention_with_lse_plain(q, k, v, causal, window, kv_offset)[0]


def _check_kernel_args(q, k, v) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash attention kernel: unsupported device {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"flash attention kernel: {name} on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"flash attention kernel takes bf16, got {name} {x.dtype}")
        if x.dim() != 4:
            raise ValueError(f"flash attention kernel: {name} must be (B, T, heads, D)")
        if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(
                f"flash attention kernel: {name} needs a contiguous last axis and "
                "16-byte aligned rows"
            )
    b, t, _, d = q.shape
    if k.shape[0] != b or k.shape[1] != t or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(
            f"flash attention kernel: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not match"
        )
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head_dim in {_HEAD_DIMS}, got {d}")


def flash_attention_with_lse(q, k, v, causal: bool = False, window: int = 0,
                             kv_offset: int = 0):
    """q: (B, T, H, D), k/v: (B, T, Hkv, D) -> (out (B, T, H, D), lse
    (B, H, T) f32) with ``lse = log sum_j exp(q_i . k_j / sqrt(D))`` over the
    visible keys.  ``window > 0`` (causal only) keeps the last ``window``
    positions; ``kv_offset`` shifts the keys that many positions earlier
    than the queries.

    A CPU tensor goes through ``flash_attention_with_lse_plain``; a CUDA
    tensor launches the kernel on the current stream (no synchronisation)
    or raises.  Forward only: no autograd yet."""
    h, hkv = _validate_flash_args(q, k, v, causal, window, kv_offset)
    if q.device.type == "cpu":
        return flash_attention_with_lse_plain(q, k, v, causal, window, kv_offset)
    _check_kernel_args(q, k, v)
    b, t, _, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = _build.load("flash_attention_fwd", _SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.ddl_flash_attention_fwd(
        q.device.index or 0, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, t, h, hkv, d, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], ctypes.c_float(1.0 / math.sqrt(d)), int(causal), window,
        kv_offset, stream,
    )
    _build.check(lib, err, "flash attention kernel")
    flash_attention_with_lse.launches += 1
    return out, lse


flash_attention_with_lse.launches = 0


def flash_attention(q, k, v, causal: bool = False, window: int = 0, kv_offset: int = 0):
    """Flash attention. q: (B, T, H, D), k/v: (B, T, Hkv, D) -> (B, T, H, D);
    ``flash_attention_with_lse`` without the lse (the same kernel launch)."""
    return flash_attention_with_lse(q, k, v, causal, window, kv_offset)[0]
