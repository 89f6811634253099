"""Flash attention: the CUDA kernels, their plain versions and the
autograd Function that joins them.

Counterpart of ``ddl_tpu/ops/flash_attention.py``.  Three CUDA kernels in
two sources replace its three TPU kernels:
``ddl_tpu_torch/csrc/flash_attention_fwd.cu`` the forward
(``flash_attention.py:84`` ``_fwd_kernel``, reached through
``_flash_fwd_impl``), ``ddl_tpu_torch/csrc/flash_attention_bwd.cu`` the
backward's dQ (``:133`` ``_dq_kernel``) and dK/dV (``:172``
``_dkdv_kernel``), both reached through ``_flash_bwd_kernels``.

Bound on the H100: tensor-core operations (causal (8, 1024, 12, 64): the
forward 12.9 GFLOP, dQ 19.3, dK/dV 25.8, each over ~63 MB).  All three are
Hopper kernels of one shape: a producer warpgroup issues TMA copies into a
ring of 128-byte-swizzled shared-memory stages, and consumer warpgroups
of 64 rows run the products as ``wgmma`` with the elementwise work in
registers between them.  The forward streams 128-key K/V tiles past 128
or 192 query rows (S = Q.K^T, O += P.V); dQ streams 64-key K/V tiles past
128 query rows (S, dP = dO.V^T, dQ += dS.K); dK/dV streams the Q and dO
tiles of every (group member, query tile) pair past 128 keys (64 at
head_dim 128) (S^T, dP^T, dV += P^T.dO, dK += dS^T.Q).  All three skip
tiles outside the causal/window/``kv_offset`` band (``_qk_live``), mask
only tiles that cross the band's edge or ragged T, and read the (B, T, H,
D) inputs through their strides with 4-D tensor maps (the ``.cu`` files
have the full notes).  dK/dV sum the whole query-head group of a K/V head
in registers, with no atomics.  The TPU's ``block_q``/``block_k``/
``interpret`` arguments are TPU tiling and are gone: the kernels pick
their own tiles.

Numerics: the TPU kernels' own (``_fwd_kernel`` :104-130, ``_dq_kernel``
:150-169, ``_dkdv_kernel`` :195-218) -- f32 scores of the bf16 values, a
max-subtracted online softmax, probabilities zeroed where the score is
masked, ``out = acc / max(l, 1e-30)``, ``lse = m + log(max(l, 1e-30))``,
and in the backward ``p = exp(s - lse)``, ``ds = p * (do . v - delta)``
with ``delta = sum(do * out) - dlse`` taken here from the stored output.
A row that sees no key (possible with ``kv_offset``) has output 0, lse
``-1e30 + log(1e-30)`` and a zero gradient.  The kernels round P (and in
the backward dS) to bf16 before their second products (the TPU kernels
keep f32), so they agree with the plain versions to bf16 precision, not
bit for bit.

``flash_attention`` and ``flash_attention_with_lse`` are differentiable in
out and lse (``FlashAttentionFn``, the ``custom_vjp`` of ``_flash_lse``):
a CPU tensor runs the plain forward and the plain backward, a CUDA tensor
the kernels, and nothing else.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ddl_tpu_torch.ops import _build

__all__ = [
    "FLASH_AUTO_MIN_T",
    "FlashAttentionFn",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_dkdv",
    "flash_attention_bwd_dkdv_plain",
    "flash_attention_bwd_dq",
    "flash_attention_bwd_dq_plain",
    "flash_attention_bwd_plain",
    "flash_attention_fn_plain",
    "flash_attention_plain",
    "flash_attention_with_lse",
    "flash_attention_with_lse_plain",
    "flash_kernel_takes",
    "require_flash_kernel",
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
# device, q, k, v, do, lse, delta, the outputs (dq; dk and dv), B, T, H,
# Hkv, D, the strides of q, k, v and do, scale, causal, window, kv_offset,
# stream
_BWD_SIGNATURES = {
    f"ddl_flash_attention_bwd_{name}": [
        ctypes.c_int, *[ctypes.c_void_p] * (6 + n_out), *[ctypes.c_int] * 5,
        *[ctypes.c_longlong] * 12, ctypes.c_float, *[ctypes.c_int] * 3, ctypes.c_void_p,
    ]
    for name, n_out in (("dq", 1), ("dkdv", 2))
}


def flash_kernel_takes(head_dim: int, dtype, device_type: str | None) -> bool:
    """Whether attention with ``head_dim`` in ``dtype`` on ``device_type``
    can run through the flash kernels.  Off CUDA (or with no device given)
    the plain versions run, and they take every shape; on CUDA the kernels
    take what ``_check_kernel_args`` accepts: bf16 at a head_dim in
    ``_HEAD_DIMS``."""
    if device_type != "cuda":
        return True
    return head_dim in _HEAD_DIMS and dtype == torch.bfloat16


def require_flash_kernel(cfg, device_type: str | None) -> None:
    """Raise ``ValueError`` when ``cfg.flash is True`` asks for the flash
    kernels where they cannot run, so a model or generator fails when it
    is built, before any work, not at its first launch."""
    if cfg.causal and cfg.flash is True and not flash_kernel_takes(
            cfg.head_dim, cfg.dtype, device_type):
        raise ValueError(
            f"flash=True: the flash kernels take {torch.bfloat16} at head_dim in "
            f"{_HEAD_DIMS} on {device_type}, got {cfg.dtype} at head_dim {cfg.head_dim}; use "
            "flash='auto' (dense where the kernels cannot run) or flash=False"
        )


def use_flash(cfg, seq_len: int, device_type: str | None = None) -> bool:
    """Whether a causal pass over ``seq_len`` positions takes the flash
    kernel: ``cfg.flash`` True, or ``"auto"`` at or past
    ``FLASH_AUTO_MIN_T`` where ``flash_kernel_takes`` the config on
    ``device_type``."""
    if not cfg.causal:
        return False
    return cfg.flash is True or (
        cfg.flash == "auto" and seq_len >= FLASH_AUTO_MIN_T
        and flash_kernel_takes(cfg.head_dim, cfg.dtype, device_type))


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


def _masked_scores(qg, k, causal: bool, window: int, kv_offset: int):
    """f32 scores ``(q . k) * scale`` (B, Hkv, G, T, T) of the grouped
    query (B, T, Hkv, G, D), -1e30 outside the ``_causal_mask`` band."""
    t, d = qg.shape[1], qg.shape[-1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (1.0 / math.sqrt(d))
    if causal:
        q_pos = torch.arange(t, device=qg.device)[:, None]
        k_pos = torch.arange(t, device=qg.device)[None, :] - kv_offset
        keep = k_pos <= q_pos
        if window:
            keep &= k_pos > q_pos - window
        s = s.masked_fill(~keep, _NEG_INF)
    return s


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
    s = _masked_scores(qg, k, causal, window, kv_offset)
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


def _check_strided(name: str, x, device) -> None:
    if x.device != device:
        raise ValueError(f"flash attention kernel: {name} on {x.device}, q on {device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"flash attention kernel takes bf16, got {name} {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"flash attention kernel: {name} must be (B, T, heads, D)")
    if not _kernel_readable(x):
        raise ValueError(
            f"flash attention kernel: {name} needs a contiguous last axis, "
            "16-byte aligned rows and no zero stride on an axis longer than 1"
        )


def _kernel_readable(x) -> bool:
    """Whether the kernels' tensor maps can read ``x`` through its strides:
    a contiguous last axis, every row 16-byte aligned, and no zero stride
    on an axis longer than 1 (TMA steps by a positive multiple of 16 bytes;
    an expanded tensor is copied instead).  A size-1 axis takes any
    stride."""
    return x.stride(-1) == 1 and not x.data_ptr() % 16 and all(
        n == 1 or (s > 0 and s % 8 == 0) for n, s in zip(x.shape[:3], x.stride()[:3]))


def _check_kernel_args(q, k, v, do=None) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash attention kernel: unsupported device {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)) + ((("do", do),) if do is not None else ()):
        _check_strided(name, x, q.device)
    b, t, _, d = q.shape
    if k.shape[0] != b or k.shape[1] != t or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(
            f"flash attention kernel: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not match"
        )
    if do is not None and do.shape != q.shape:
        raise ValueError(f"flash attention kernel: do {tuple(do.shape)} is not q's shape")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head_dim in {_HEAD_DIMS}, got {d}")


def _check_rows(name: str, x, q) -> None:
    b, t, h, _ = q.shape
    if x.device != q.device or x.dtype != torch.float32 or tuple(x.shape) != (b, h, t) \
            or not x.is_contiguous():
        raise ValueError(
            f"flash attention kernel: {name} must be contiguous f32 (B, H, T) = "
            f"{(b, h, t)} on {q.device}, got {x.dtype} {tuple(x.shape)} on {x.device}"
        )


def _flash_fwd(q, k, v, causal: bool, window: int, kv_offset: int):
    """The forward kernel: (out, lse) on the current stream, counted in
    ``flash_attention_with_lse.launches``."""
    h, hkv = _validate_flash_args(q, k, v, causal, window, kv_offset)
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


def _probs(q, k, lse, causal: bool, window: int, kv_offset: int):
    """(q grouped as (B, T, Hkv, G, D) in f32, p (B, Hkv, G, T, T) = exp(s -
    lse) over the band, 0 elsewhere, the scale): the backward kernels'
    recomputed probabilities in f32 over whole rows."""
    b, t, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.float().reshape(b, t, hkv, g, d)
    s = _masked_scores(qg, k, causal, window, kv_offset)
    p = torch.where(s > _NEG_INF / 2, torch.exp(s - lse.reshape(b, hkv, g, t, 1)), 0.0)
    return qg, p, 1.0 / math.sqrt(d)


def _dscores(p, do, v, delta):
    """ds = p * (do . v - delta), (B, Hkv, G, T, T) f32."""
    b, t, h, d = do.shape
    hkv, g = v.shape[2], h // v.shape[2]
    dog = do.float().reshape(b, t, hkv, g, d)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    return dog, p * (dp - delta.reshape(b, hkv, g, t, 1))


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool = False,
                                 window: int = 0, kv_offset: int = 0):
    """``_dq_kernel``'s math in f32 over whole rows: ``dq = scale * ds . k``
    in ``q.dtype``; lse and delta (B, H, T) f32."""
    _validate_flash_args(q, k, v, causal, window, kv_offset)
    qg, p, scale = _probs(q, k, lse, causal, window, kv_offset)
    _, ds = _dscores(p, do, v, delta)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    return dq.reshape(q.shape).to(q.dtype)


def flash_attention_bwd_dkdv_plain(q, k, v, do, lse, delta, causal: bool = False,
                                   window: int = 0, kv_offset: int = 0):
    """``_dkdv_kernel``'s math in f32 over whole rows: ``dk = scale * ds^T .
    q`` and ``dv = p^T . do``, each summed over the group's query heads, at
    Hkv heads (grouped K/V by query reshape, never repeated)."""
    _validate_flash_args(q, k, v, causal, window, kv_offset)
    qg, p, scale = _probs(q, k, lse, causal, window, kv_offset)
    dog, ds = _dscores(p, do, v, delta)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def _delta(out, do, dlse=None):
    """``delta = sum_d do * out - dlse`` (B, H, T) f32, from the stored
    output in its own dtype (``_flash_bwd_kernels`` :289-293)."""
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    if dlse is not None:
        delta = delta - dlse.float()
    return delta


def flash_attention_bwd_plain(q, k, v, out, lse, do, dlse=None, causal: bool = False,
                              window: int = 0, kv_offset: int = 0):
    """The flash backward (``_flash_bwd_kernels``) in f32 over whole rows:
    (dq, dk, dv) for the output cotangent ``do`` and the lse cotangent
    ``dlse`` (None: zero), in the inputs' dtypes; dk and dv at Hkv heads."""
    delta = _delta(out, do, dlse)
    dq = flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal, window, kv_offset)
    dk, dv = flash_attention_bwd_dkdv_plain(q, k, v, do, lse, delta, causal, window, kv_offset)
    return dq, dk, dv


def _launch_bwd(which: str, q, k, v, do, lse, delta, outs, causal, window, kv_offset) -> None:
    b, t, h, d = q.shape
    lib = _build.load("flash_attention_bwd", _BWD_SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(lib, f"ddl_flash_attention_bwd_{which}")(
        q.device.index or 0, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(o.data_ptr() for o in outs), b, t, h, k.shape[2], d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        ctypes.c_float(1.0 / math.sqrt(d)), int(causal), window, kv_offset, stream,
    )
    _build.check(lib, err, f"flash attention backward ({which}) kernel")


def _check_bwd_args(q, k, v, do, lse, delta, causal, window, kv_offset) -> None:
    _validate_flash_args(q, k, v, causal, window, kv_offset)
    _check_kernel_args(q, k, v, do)
    _check_rows("lse", lse, q)
    _check_rows("delta", delta, q)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool = False, window: int = 0,
                           kv_offset: int = 0):
    """The dQ kernel: dq (B, T, H, D) bf16 for bf16 CUDA q, k, v, do (read
    through their strides) and f32 (B, H, T) lse and delta, on the current
    stream (no synchronisation); raises on anything else.  Each launch adds
    one to ``flash_attention_bwd_dq.launches``."""
    _check_bwd_args(q, k, v, do, lse, delta, causal, window, kv_offset)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dq.numel():
        _launch_bwd("dq", q, k, v, do, lse, delta, (dq,), causal, window, kv_offset)
        flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal: bool = False, window: int = 0,
                             kv_offset: int = 0):
    """The dK/dV kernel: (dk, dv) (B, T, Hkv, D) bf16, each summed over the
    H / Hkv query heads of its group, for the inputs of
    ``flash_attention_bwd_dq``.  Each launch adds one to
    ``flash_attention_bwd_dkdv.launches``."""
    _check_bwd_args(q, k, v, do, lse, delta, causal, window, kv_offset)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if dk.numel():
        _launch_bwd("dkdv", q, k, v, do, lse, delta, (dk, dv), causal, window, kv_offset)
        flash_attention_bwd_dkdv.launches += 1
    return dk, dv


flash_attention_bwd_dkdv.launches = 0


def flash_attention_bwd(q, k, v, out, lse, do, dlse=None, causal: bool = False,
                        window: int = 0, kv_offset: int = 0):
    """The flash backward through the two CUDA kernels: delta from the
    stored output (a PyTorch reduction, as the TPU path), then dQ and
    dK/dV.  CUDA tensors only: raises off CUDA or on arguments the
    kernels do not take."""
    if q.device.type != "cuda":
        raise ValueError(f"flash attention backward kernels: unsupported device {q.device}")
    delta = _delta(out, do, dlse)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, window, kv_offset)
    dk, dv = flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal, window, kv_offset)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """``(out, lse)`` of flash attention, differentiable in both (the
    ``custom_vjp`` of the JAX ``_flash_lse``): the forward saves ``(q, k,
    v, out, lse)``; the backward takes both cotangents and folds ``dlse``
    into delta.  An unused output's cotangent arrives as None (grads are
    not materialised): a missing ``dlse`` is zero, a missing ``do`` a zero
    tensor.  ``plain`` runs the plain versions (any device), else the
    kernels (CUDA only)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, kv_offset, plain):
        if plain:
            out, lse = flash_attention_with_lse_plain(q, k, v, causal, window, kv_offset)
        else:
            out, lse = _flash_fwd(q, k, v, causal, window, kv_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.set_materialize_grads(False)
        ctx.args = (causal, window, kv_offset, plain)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, kv_offset, plain = ctx.args
        if do is None:
            do = torch.zeros_like(out)
        if plain:
            grads = flash_attention_bwd_plain(q, k, v, out, lse, do, dlse, causal, window,
                                              kv_offset)
        else:
            if not _kernel_readable(do):  # e.g. the expanded cotangent of a sum
                do = do.contiguous()
            grads = flash_attention_bwd(q, k, v, out, lse, do, dlse, causal, window, kv_offset)
        return (*grads, None, None, None, None)


def flash_attention_with_lse(q, k, v, causal: bool = False, window: int = 0,
                             kv_offset: int = 0):
    """q: (B, T, H, D), k/v: (B, T, Hkv, D) -> (out (B, T, H, D), lse
    (B, H, T) f32) with ``lse = log sum_j exp(q_i . k_j / sqrt(D))`` over the
    visible keys.  ``window > 0`` (causal only) keeps the last ``window``
    positions; ``kv_offset`` shifts the keys that many positions earlier
    than the queries.

    Differentiable in out and lse (``FlashAttentionFn``).  A CPU tensor
    goes through the plain forward and backward; a CUDA tensor launches
    the kernels on the current stream (no synchronisation) or raises.
    Each forward kernel launch adds one to
    ``flash_attention_with_lse.launches``."""
    _validate_flash_args(q, k, v, causal, window, kv_offset)
    return FlashAttentionFn.apply(q, k, v, causal, window, kv_offset, q.device.type == "cpu")


flash_attention_with_lse.launches = 0


def flash_attention(q, k, v, causal: bool = False, window: int = 0, kv_offset: int = 0):
    """Flash attention. q: (B, T, H, D), k/v: (B, T, Hkv, D) -> (B, T, H, D);
    ``flash_attention_with_lse`` without the lse (the same kernel launch;
    the unused lse gets no cotangent)."""
    return flash_attention_with_lse(q, k, v, causal, window, kv_offset)[0]


def flash_attention_fn_plain(q, k, v, causal: bool = False, window: int = 0,
                             kv_offset: int = 0):
    """``flash_attention`` through ``FlashAttentionFn`` with the plain
    forward and backward on any device: the plain path that the kernels
    are held against on the card."""
    _validate_flash_args(q, k, v, causal, window, kv_offset)
    return FlashAttentionFn.apply(q, k, v, causal, window, kv_offset, True)[0]
