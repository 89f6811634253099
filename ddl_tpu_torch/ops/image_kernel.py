"""uint8 -> float image normalize: the CUDA kernel and its plain version.

Replaces the TPU kernel ``ddl_tpu/ops/pallas_image.py:26``
(``_normalize_kernel``, reached through ``pallas_normalize_images``); the
kernel source is ``ddl_tpu_torch/csrc/normalize.cu``.

Bound on the H100: bytes.  One byte in and two (bf16) or four (f32) bytes
out per element with one multiply between, so device memory is the limit
(30x224x224x3 in bf16: 13.5 MB, ~4 us at 3.35 TB/s).  The kernel's design
answers only that: 16-byte loads, 16-byte stores, a grid-stride loop, a
scalar tail for sizes that are not a multiple of 16.

Arithmetic follows the Pallas kernel (``pallas_image.py:27-28``): round the
integer to the output type, multiply by ``dtype(1/255)``, round once.  In
bf16 that can differ by one ulp from ``ops/image.normalize_images``, which
divides by 255.
"""

from __future__ import annotations

import ctypes

import torch

from ddl_tpu_torch.ops import _build

__all__ = ["normalize", "normalize_plain"]

_ENTRY = {
    torch.bfloat16: "ddl_normalize_u8_bf16",
    torch.float32: "ddl_normalize_u8_f32",
}
_SIGNATURES = {
    fn: [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_void_p]
    for fn in _ENTRY.values()
}


def normalize_plain(images: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: ``images.to(dtype)`` times a
    0-dim ``dtype`` tensor holding 1/255 (a Python float would keep the
    constant at f32 precision inside a bf16 multiply)."""
    inv = torch.tensor(1.0 / 255.0, dtype=dtype, device=images.device)
    return images.to(dtype) * inv


def normalize(images: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """uint8 (B, H, W, C) -> ``dtype`` (B, H, W, C) in [0, 1].

    A CPU tensor goes through ``normalize_plain``; a CUDA tensor launches
    the kernel on the current stream (no synchronisation) or raises."""
    if images.dtype != torch.uint8:
        raise TypeError(f"normalize takes uint8 images, got {images.dtype}")
    if images.device.type == "cpu":
        return normalize_plain(images, dtype)
    if images.device.type != "cuda":
        raise ValueError(f"normalize: unsupported device {images.device}")
    if dtype not in _ENTRY:
        raise TypeError(f"normalize kernel writes bf16 or f32, not {dtype}")
    if not images.is_contiguous() or images.data_ptr() % 16:
        raise ValueError("normalize kernel needs a contiguous, 16-byte aligned input")
    out = torch.empty(images.shape, dtype=dtype, device=images.device)
    if images.numel() == 0:
        return out
    lib = _build.load("normalize", _SIGNATURES)
    stream = torch.cuda.current_stream(images.device).cuda_stream
    err = getattr(lib, _ENTRY[dtype])(
        images.device.index or 0, images.data_ptr(), out.data_ptr(),
        images.numel(), stream,
    )
    _build.check(lib, err, "normalize kernel")
    normalize.launches += 1
    return out


normalize.launches = 0
