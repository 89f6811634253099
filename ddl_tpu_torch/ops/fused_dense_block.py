"""A whole DenseNet dense block in one kernel call (eval-mode forward).

Counterpart of ``ddl_tpu/ops/fused_dense_block.py`` (forward half and the
folds).  The CUDA kernel ``ddl_tpu_torch/csrc/fused_dense_block.cu``
replaces the TPU kernel ``ddl_tpu/ops/fused_dense_block.py:155``
(``_kernel``, reached through ``_forward_call``).

Bound on the H100: tensor-core operations (block 1 of DenseNet121 at batch
30: 62.4 GFLOP over ~60 MB, ~63 us at 989 TFLOP/s bf16).  Design: one CUDA
block per (image, 8x8 output tile), one launch per layer; each block
recomputes the 1x1 and the bottleneck over its 10x10 halo in shared memory
and runs the 3x3 as nine shifted ``mma.sync`` products.  The growing
feature map lives in the output buffer in device memory, because block 1's
per-image map (1.6 MB) is far larger than the 227 KB of shared memory one
block may use; keeping it on chip is later work.

Numerics follow the TPU kernel (``_kernel`` :179-198): the layer input is
held in the compute dtype, the folded BN affine and the ReLU run in f32,
each product takes bf16 operands and accumulates in f32, the bottleneck is
rounded to bf16 and the strip is stored in the compute dtype.

Layouts differ from the JAX package's padded pack layout (no 128-lane
front pad, no zero-padded full-width 1x1): ``pack_block_params`` returns
``a1``/``b1`` ragged (layer l's ``c0 + l*g`` entries back to back), ``w1``
ragged the same way with each layer's ``(bn, c_in)`` matrix, ``a2``/``b2``
as ``(L, bn)``, and ``w2`` as ``(L, 9, g, bn)`` with tap ``dy*3+dx``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ddl_tpu_torch.ops import _build

__all__ = [
    "BN_EPS",
    "fused_dense_block",
    "fused_dense_block_plain",
    "pack_affines",
    "pack_block_params",
]

BN_EPS = 1e-5

# What the kernel takes: growth 32, bottleneck 128 (DenseNet-121/169/201),
# block inputs a multiple of the kernel's 32-channel chunk.
_KERNEL_GROWTH = 32
_KERNEL_BN = 128
_KERNEL_CHUNK = 32

_SIGNATURES = {
    "ddl_fused_dense_block_fwd": [ctypes.c_int, *[ctypes.c_void_p] * 8,
                                  *[ctypes.c_int] * 5, ctypes.c_void_p],
}


def pack_affines(layer_params, norm1_stats, norm2_stats, dtype) -> dict:
    """Fold per-layer BN params and ``(mean, var)`` stats into the kernel's
    affines and lay the conv weights out for it.

    ``layer_params[i]`` maps torchvision's names inside ``denselayer{i+1}``
    (``norm1.weight``, ``norm1.bias``, ``conv1.weight`` (bn, c_in, 1, 1),
    ``norm2.weight``, ``norm2.bias``, ``conv2.weight`` (g, bn, 3, 3)) to
    tensors.  a = rsqrt(var + eps) * weight and b = bias - mean * a, in
    f32; the weights are cast to ``dtype`` (the kernel's operand type)."""
    a1, b1, w1, a2, b2, w2 = [], [], [], [], [], []
    for p, (mu1, var1), (mu2, var2) in zip(layer_params, norm1_stats, norm2_stats):
        s1 = torch.rsqrt(var1.float() + BN_EPS) * p["norm1.weight"].float()
        a1.append(s1)
        b1.append(p["norm1.bias"].float() - mu1.float() * s1)
        w1.append(p["conv1.weight"].flatten().to(dtype))
        s2 = torch.rsqrt(var2.float() + BN_EPS) * p["norm2.weight"].float()
        a2.append(s2)
        b2.append(p["norm2.bias"].float() - mu2.float() * s2)
        # OIHW (g, bn, 3, 3) -> (3, 3, g, bn) -> (9, g, bn): tap dy*3+dx
        k = p["conv2.weight"]
        w2.append(k.permute(2, 3, 0, 1).reshape(9, k.shape[0], k.shape[1]).to(dtype))
    return {
        "a1": torch.cat(a1).contiguous(),
        "b1": torch.cat(b1).contiguous(),
        "w1": torch.cat(w1).contiguous(),
        "a2": torch.stack(a2).contiguous(),
        "b2": torch.stack(b2).contiguous(),
        "w2": torch.stack(w2).contiguous(),
    }


def pack_block_params(layer_states, dtype) -> dict:
    """Eval-mode fold from the layers' running statistics;
    ``layer_states[i]`` is ``pack_affines``'s mapping plus
    ``norm{1,2}.running_mean`` / ``norm{1,2}.running_var``."""
    stats = [
        [(s[f"{n}.running_mean"], s[f"{n}.running_var"]) for s in layer_states]
        for n in ("norm1", "norm2")
    ]
    return pack_affines(layer_states, stats[0], stats[1], dtype)


def _geometry(x0: torch.Tensor, packed: dict) -> tuple[int, int, int, int]:
    """(c0, L, bn, growth), checked against every packed tensor's size."""
    c0 = x0.shape[-1]
    L, bn = packed["a2"].shape
    g = packed["w2"].shape[2]
    c_sum = L * c0 + g * L * (L - 1) // 2
    want = {"a1": (c_sum,), "b1": (c_sum,), "w1": (c_sum * bn,),
            "b2": (L, bn), "w2": (L, 9, g, bn)}
    for k, shape in want.items():
        if tuple(packed[k].shape) != shape:
            raise ValueError(
                f"packed[{k!r}] has shape {tuple(packed[k].shape)}, the block "
                f"(c0={c0}, L={L}, bn={bn}, growth={g}) needs {shape}"
            )
    return c0, L, bn, g


def fused_dense_block_plain(x0: torch.Tensor, packed: dict) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch.  Products take operands
    rounded to ``x0.dtype`` and accumulate in f32 (they run as f32 matmul
    and conv on those rounded values, so set TF32 off on a GPU to keep
    them exact)."""
    if x0.dim() != 4:
        raise ValueError(f"x0 must be (B, H, W, C0), got {tuple(x0.shape)}")
    c0, L, bn, g = _geometry(x0, packed)
    dt = x0.dtype
    b, h, w, _ = x0.shape
    out = x0.new_empty((b, h, w, c0 + L * g))
    out[..., :c0] = x0
    off = 0
    for l in range(L):
        c_in = c0 + l * g
        a1 = packed["a1"][off:off + c_in]
        b1 = packed["b1"][off:off + c_in]
        w1 = packed["w1"][off * bn:(off + c_in) * bn].view(bn, c_in)
        hid = torch.relu(out[..., :c_in].float() * a1 + b1).to(dt).float()
        y1 = hid @ w1.float().t()
        h2 = torch.relu(y1 * packed["a2"][l] + packed["b2"][l]).to(dt).float()
        k = packed["w2"][l].float().view(3, 3, g, bn).permute(2, 3, 0, 1)
        strip = F.conv2d(h2.permute(0, 3, 1, 2), k, padding=1)
        out[..., c_in:c_in + g] = strip.permute(0, 2, 3, 1).to(dt)
        off += c_in
    return out


def fused_dense_block(x0: torch.Tensor, packed: dict) -> torch.Tensor:
    """Dense block forward: x0 (B, H, W, C0) -> (B, H, W, C0 + L*growth),
    NHWC, in ``x0.dtype``; ``packed`` from ``pack_block_params``.

    A CPU tensor goes through ``fused_dense_block_plain``.  A CUDA tensor
    launches the kernel (a copy of x0 into the output, then one launch per
    layer, all on the current stream, no synchronisation) or raises; each
    layer's launch adds one to ``fused_dense_block.launches``."""
    if x0.device.type == "cpu":
        return fused_dense_block_plain(x0, packed)
    if x0.device.type != "cuda":
        raise ValueError(f"fused_dense_block: unsupported device {x0.device}")
    if x0.dim() != 4 or x0.dtype != torch.bfloat16:
        raise TypeError(
            f"fused_dense_block kernel takes (B, H, W, C0) bf16, got "
            f"{tuple(x0.shape)} {x0.dtype}"
        )
    c0, L, bn, g = _geometry(x0, packed)
    if g != _KERNEL_GROWTH or bn != _KERNEL_BN or c0 % _KERNEL_CHUNK:
        raise ValueError(
            f"fused_dense_block kernel takes growth {_KERNEL_GROWTH}, "
            f"bottleneck {_KERNEL_BN} and C0 % {_KERNEL_CHUNK} == 0; got "
            f"growth {g}, bottleneck {bn}, C0 {c0}"
        )
    args = [x0] + [packed[k] for k in ("a1", "b1", "w1", "a2", "b2", "w2")]
    want = [torch.bfloat16] + [torch.float32] * 2 + [torch.bfloat16] \
        + [torch.float32] * 2 + [torch.bfloat16]
    for t, dt in zip(args, want):
        if t.device != x0.device or t.dtype != dt or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(
                "fused_dense_block kernel needs every tensor contiguous, "
                "16-byte aligned, on x0's device, with x0/w1/w2 bf16 and "
                "a1/b1/a2/b2 f32"
            )
    b, h, w, _ = x0.shape
    out = torch.empty((b, h, w, c0 + L * g), dtype=x0.dtype, device=x0.device)
    lib = _build.load("fused_dense_block", _SIGNATURES)
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    err = lib.ddl_fused_dense_block_fwd(
        x0.device.index or 0, x0.data_ptr(), out.data_ptr(),
        *(t.data_ptr() for t in args[1:]), b, h, w, c0, L, stream,
    )
    _build.check(lib, err, "fused_dense_block kernel")
    fused_dense_block.launches += L
    return out


fused_dense_block.launches = 0
