"""Weight-only int8 matmul for tiny-M decode steps: the CUDA kernel and its
plain version (counterpart of ``ddl_tpu/ops/int8_matvec.py``).

The CUDA source ``ddl_tpu_torch/csrc/int8_matvec.cu`` replaces the TPU
kernel ``ddl_tpu/ops/int8_matvec.py:39`` (``_kernel``, reached through
``int8_matmul_small_m``).  On the TPU, XLA fuses the int8 -> bf16 convert
into the matmul's operand read, and that lowering beat the Pallas kernel,
so the JAX package leaves the kernel unwired.  The card has no such
fusion: ``x @ w8.to(bf16)`` reads each weight byte, writes a 2-byte copy
and reads the copy again.  So here the kernel is the only path that
streams the int8 weights at one byte each, and ``QDense`` and ``LMHead``
(``models/transformer.py``) take it for every product of at most
``MATVEC_MAX_ROWS`` activation rows.

Bound on the H100: bytes (at most 16 operations per weight byte).  The
(D, O) layout splits D over a cluster of 8 CTAs per 64-column strip, so
even the 768 -> 256 projections launch 32 CTAs; the (O, D) layout gives
each warp 4 output rows and walks D with 16-byte loads
(``int8_matvec.cu`` has the full note).  The TPU-only arguments
``block_o`` (the MXU lane tile) and ``interpret`` are gone: the kernel
takes any O and D.

Numerics follow the TPU kernel: the int8 values are exact in f32, the
products are summed in f32, the per-channel scale multiplies the f32 sum,
and the result is rounded once to x's dtype (bf16 in, bf16 out; f32 in,
f32 out, as the head needs).
"""

from __future__ import annotations

import ctypes

import torch

from ddl_tpu_torch.ops import _build

__all__ = [
    "MATVEC_MAX_ROWS",
    "int8_kernel_takes",
    "int8_matmul_small_m",
    "int8_matmul_small_m_plain",
]

MATVEC_MAX_ROWS = 8
_SIGNATURES = {
    "ddl_int8_matmul_small_m": [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, *[ctypes.c_void_p] * 3,
        *[ctypes.c_int] * 5, ctypes.c_void_p,
    ],
}
# Shared memory one block may use on the H100 (227 KB with the opt-in),
# and what each layout's kernel stages (csrc/int8_matvec.cu, launch_m and
# the kernels' arrays): (O, D) x as f32, M x D rounded up to 16; (D, O) its
# cluster rank's eighth of x as f32, plus each warp's and the block's
# M x 64 partial sums.
_SMEM_PER_BLOCK = 232448
_CLUSTER, _STRIP, _WARPS = 8, 64, 8


def _smem_bytes(m: int, d: int, contract_last: bool) -> int:
    if contract_last:
        return m * -(-d // 16) * 16 * 4
    return (-(-d // _CLUSTER) * m + (_WARPS + 1) * m * _STRIP) * 4


def int8_kernel_takes(m: int, d: int, contract_last: bool, dtype, device_type: str) -> bool:
    """Whether an (M, D) product with the int8 weight in the given layout
    goes through ``int8_matmul_small_m``: at most ``MATVEC_MAX_ROWS`` rows
    anywhere (the plain version takes every such shape); on CUDA also a
    bf16 or f32 x whose staging fits the layout's shared memory.  Call
    sites send what this refuses to the large-M product."""
    if m > MATVEC_MAX_ROWS:
        return False
    if device_type != "cuda":
        return True
    return dtype in (torch.bfloat16, torch.float32) and \
        _smem_bytes(m, d, contract_last) <= _SMEM_PER_BLOCK


def _check_args(x, w8, scale, contract_last: bool) -> int:
    """Shapes both paths require; returns O."""
    if x.dim() != 2:
        raise ValueError(f"int8_matmul_small_m takes x of shape (M, D), got {tuple(x.shape)}")
    m, d = x.shape
    if m > MATVEC_MAX_ROWS:
        raise ValueError(f"M={m} > {MATVEC_MAX_ROWS}; use the large-M product")
    if w8.dim() != 2 or w8.shape[1 if contract_last else 0] != d:
        layout = "(O, D)" if contract_last else "(D, O)"
        raise ValueError(f"w8 {tuple(w8.shape)} is not {layout} with D={d}")
    o = w8.shape[0] if contract_last else w8.shape[1]
    if scale.numel() != o:
        raise ValueError(f"scale has {scale.numel()} elements, the output {o} channels")
    return o


def int8_matmul_small_m_plain(x, w8, scale, *, contract_last: bool = False):
    """The TPU kernel's arithmetic in one f32 product."""
    o = _check_args(x, w8, scale, contract_last)
    w = w8.float()
    y = x.float() @ (w.t() if contract_last else w)
    return (y * scale.float().reshape(1, o)).to(x.dtype)


def int8_matmul_small_m(x, w8, scale, *, contract_last: bool = False):
    """``(x @ dequant(w8)) * scale`` for M <= ``MATVEC_MAX_ROWS`` rows.

    x: (M, D) bf16 or f32; ``w8`` int8, (D, O) (``contract_last=False``:
    ``QDense``'s layout) or (O, D) (``True``: ``LMHead``'s vocab-major
    layout); ``scale`` f32 with exactly O elements (any shape).  Returns
    (M, O) in x's dtype.  M > 8 raises ``ValueError``.

    A CPU tensor goes through ``int8_matmul_small_m_plain``; a CUDA tensor
    launches the kernel on the current stream (no synchronisation) or
    raises."""
    o = _check_args(x, w8, scale, contract_last)
    if x.device.type == "cpu":
        return int8_matmul_small_m_plain(x, w8, scale, contract_last=contract_last)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul_small_m kernel: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int8_matmul_small_m kernel takes a bf16 or f32 x, got {x.dtype}")
    if w8.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(
            f"int8_matmul_small_m kernel takes an int8 w8 and f32 scale, got {w8.dtype} / "
            f"{scale.dtype}"
        )
    for name, t in (("w8", w8), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"int8_matmul_small_m kernel: {name} on {t.device}, x on {x.device}")
    if not w8.is_contiguous():
        raise ValueError("int8_matmul_small_m kernel: w8 must be contiguous")
    m, d = x.shape
    if _smem_bytes(m, d, contract_last) > _SMEM_PER_BLOCK:
        raise ValueError(f"int8_matmul_small_m kernel: D={d} at M={m} exceeds shared memory")
    x = x.contiguous()
    scale = scale.reshape(o).contiguous()
    out = torch.empty((m, o), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    vec = (o if not contract_last else d) % 16 == 0 and w8.data_ptr() % 16 == 0
    lib = _build.load("int8_matvec", _SIGNATURES)
    err = lib.ddl_int8_matmul_small_m(
        x.device.index or 0, x.data_ptr(), int(x.dtype == torch.bfloat16), w8.data_ptr(),
        scale.data_ptr(), out.data_ptr(), m, d, o, int(contract_last), int(vec),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "int8_matmul_small_m kernel")
    int8_matmul_small_m.launches += 1
    return out


int8_matmul_small_m.launches = 0
