"""A whole DenseNet dense block in one kernel call, forward and backward.

Counterpart of ``ddl_tpu/ops/fused_dense_block.py``.  The CUDA kernel
``ddl_tpu_torch/csrc/fused_dense_block.cu`` replaces the TPU kernel
``ddl_tpu/ops/fused_dense_block.py:155`` (``_kernel``, reached through
``_forward_call``); ``ddl_tpu_torch/csrc/fused_dense_block_bwd.cu``
replaces ``ddl_tpu/ops/fused_dense_block.py:277`` (``_bwd_kernel``,
reached through ``_backward_call``).  ``FusedDenseBlockFn`` pairs them as
``_diff_block_fn`` does with ``jax.custom_vjp``: the VJP boundary is the
folded affines, so in training the gradient through the batch statistics
they were folded from flows through ``pack_affines`` and the stats pass by
autograd, outside the kernels.

Bound on the H100: tensor-core operations (block 1 of DenseNet121 at batch
30: 62.4 GFLOP over ~60 MB, ~63 us at 989 TFLOP/s bf16).  Design (the CUDA
sources have the full notes; the two share ``csrc/dense_common.cuh``): the
map is a (pixels, channels) matrix and every layer's products take all
B*H*W pixels of the batch as M, in tiles of 64 pixels per warpgroup, so one
set of kernels serves every block geometry.  The forward runs two launches
per layer: the 1x1 with the folded affine and ReLU applied to the A
fragments in registers, writing h2 to a (pixels, 128) workspace, then the
3x3 as nine shifted products whose A rows ldmatrix reads from three staged
bands of h2 (a zero row for the padding).  The backward sweeps the layers
in reverse, one launch each, for the data gradients (dh2, the recomputed
1x1, dy1, dhid, dX), saving each layer's dy1, h2 and transposed bf16
strip cotangent; then one launch each for dW1 and dW2 of all layers over
pixel slices, and fixed-order sums of the partial rows: no atomics, so two
calls give bit-identical gradients.  The affines round the product before
the sum, as ``fused_dense_block_plain`` does, so the ReLU masks agree.
``block_plan`` sizes the tiles, the persistent grids, the slices and the
workspaces; the wrappers allocate the workspaces with ``torch.empty``.

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
    "FusedDenseBlockFn",
    "block_plan",
    "dw1_tiles",
    "fused_block_takes",
    "fused_dense_block",
    "fused_dense_block_bwd",
    "fused_dense_block_bwd_plain",
    "fused_dense_block_fn",
    "fused_dense_block_fn_plain",
    "fused_dense_block_plain",
    "pack_affines",
    "pack_block_params",
    "persistent_tiles",
    "slice_chunks",
    "sweep_units",
]

BN_EPS = 1e-5

# What the kernel takes: growth 32, bottleneck 128 (DenseNet-121/169/201),
# block inputs a multiple of the kernel's 32-channel chunk.
_KERNEL_GROWTH = 32
_KERNEL_BN = 128
_KERNEL_CHUNK = 32

_SIGNATURES = {
    "ddl_fused_dense_block_fwd": [ctypes.c_int, *[ctypes.c_void_p] * 9,
                                  *[ctypes.c_int] * 8, ctypes.c_void_p],
}
_BWD_SIGNATURES = {
    "ddl_fused_dense_block_bwd": [ctypes.c_int, *[ctypes.c_void_p] * 25,
                                  *[ctypes.c_int] * 10, ctypes.c_void_p],
}
# Tiles of the kernels: 64 pixels per warpgroup; map and weight tiles of
# 64 channels.
_TILE_PIX = 64
_TILE_CH = 64
# Persistent CTAs an SM holds at wg = 1 and 2 warpgroups a CTA: the
# forward 1x1 (a ring of map and w1 tiles: eight stages at wg 1, three at
# wg 2), the forward 3x3 and the backward sweep (w2 resident).
_CTAS_PER_SM = {"1x1": (1, 2), "3x3": (1, 1), "bwd": (1, 1)}
# At most this many sweep CTAs share a tile (each recomputes it).
_MAX_SPLIT = 4
_H100_SMS = 132
_PACKED_KEYS = ("a1", "b1", "w1", "a2", "b2", "w2")


def dw1_tiles(c0: int, n_layers: int, growth: int = _KERNEL_GROWTH) -> list[tuple[int, int]]:
    """The (layer, first channel) of every dW1 tile, in the order the dW1
    launch numbers them: layers in order, each layer's ``c0 + l*growth``
    input channels cut into tiles of 64 (the last may hold 32)."""
    return [(l, n0) for l in range(n_layers)
            for n0 in range(0, c0 + l * growth, _TILE_CH)]


def slice_chunks(s: int, slices: int, n_chunks: int) -> range:
    """The 64-pixel chunks that slice ``s`` of ``slices`` walks (in
    order) in the weight-gradient launches."""
    return range(s * n_chunks // slices, (s + 1) * n_chunks // slices)


def persistent_tiles(cta: int, grid: int, n_tiles: int) -> range:
    """The tiles a persistent CTA walks: ``cta``, ``cta + grid``, ..."""
    return range(cta, n_tiles, grid)


def sweep_units(cta: int, plan: dict, n_chunks: int) -> list[tuple[int, list[int]]]:
    """What a CTA of the backward sweep does in a layer whose input is
    ``n_chunks`` 64-channel chunks wide: (tile, its second-pass chunks) for
    each unit it walks.  Unit u is part u % split of tile u // split; every
    part recomputes the tile, and part k takes chunks k, k + split, ..."""
    split = plan["split"]
    return [(u // split, list(range(u % split, n_chunks, split)))
            for u in persistent_tiles(cta, plan["grid_bwd"], plan["m_tiles"] * split)]


def _slices(n_tiles: int, n_chunks: int, ctas: int) -> int:
    """Pixel slices of a weight-gradient launch of ``n_tiles`` output tiles:
    at least ``ctas`` CTAs, no slice without a chunk."""
    return max(1, min(n_chunks, -(-ctas // n_tiles)))


def block_plan(b: int, h: int, w: int, c0: int, n_layers: int,
               sms: int = _H100_SMS, growth: int = _KERNEL_GROWTH,
               bn: int = _KERNEL_BN) -> dict:
    """How the kernels cut a block of ``b`` images of h x w at input width
    ``c0`` on a card of ``sms`` SMs, and the workspaces they need.

    ``wg``: warpgroups per CTA, each with its own 64 pixels (2 where the
    map has a tile of 128 for every SM, so two warpgroups share each load;
    else 1, so small maps spread over more SMs); ``m_tiles`` pixel tiles of
    ``64 * wg``; ``grid_1x1``, ``grid_3x3`` and ``grid_bwd`` persistent
    CTAs (the sweep's CTAs each write one row of column sums); ``split``
    sweep CTAs share each tile where the map has fewer tiles than the card
    has SMs (``sweep_units``); ``s1``, ``s2`` pixel slices of the dW1 and
    dW2 launches; ``workspace``: name -> (shape, dtype) of every buffer the
    wrappers allocate besides their outputs."""
    pix = b * h * w
    c_sum = n_layers * c0 + growth * n_layers * (n_layers - 1) // 2
    wg = 2 if -(-pix // (2 * _TILE_PIX)) >= sms else 1
    m = _TILE_PIX * wg
    m_tiles = -(-pix // m)
    n_chunks = -(-pix // _TILE_PIX)
    grids = {k: max(1, min(m_tiles, n[wg - 1] * sms)) for k, n in _CTAS_PER_SM.items()}
    split = max(1, min(_MAX_SPLIT, sms // m_tiles))
    if split > 1:
        grids["bwd"] = m_tiles * split
    s1 = _slices(len(dw1_tiles(c0, n_layers, growth)), n_chunks, 2 * sms)
    s2 = _slices(n_layers, n_chunks, sms)
    f32, b16 = torch.float32, torch.bfloat16
    return {
        "wg": wg, "m_tiles": m_tiles, "n_chunks": n_chunks,
        "grid_1x1": grids["1x1"], "grid_3x3": grids["3x3"], "grid_bwd": grids["bwd"],
        "split": split,
        "s1": s1, "s2": s2,
        "workspace": {
            "fwd_h2": ((pix, bn), b16),
            "dx": ((pix, c0 + n_layers * growth), f32),
            "dy1": ((n_layers, pix, bn), b16),
            "h2": ((n_layers, pix, bn), b16),
            "ds": ((n_layers, growth, n_chunks * _TILE_PIX), b16),
            "part_w1": ((s1, c_sum * bn), f32),
            "part_w2": ((s2, n_layers * 9 * growth * bn), f32),
            "part_a1": ((grids["bwd"], c_sum), f32),
            "part_b1": ((grids["bwd"], c_sum), f32),
            "part_a2": ((grids["bwd"], n_layers * bn), f32),
            "part_b2": ((grids["bwd"], n_layers * bn), f32),
        },
    }


def _card_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _empty(plan: dict, name: str, device) -> torch.Tensor:
    shape, dtype = plan["workspace"][name]
    return torch.empty(shape, dtype=dtype, device=device)


def pack_affines(layer_params, norm1_stats, norm2_stats, dtype) -> dict:
    """Fold per-layer BN params and ``(mean, var)`` stats into the kernel's
    affines and lay the conv weights out for it.

    ``layer_params[i]`` maps torchvision's names inside ``denselayer{i+1}``
    (``norm1.weight``, ``norm1.bias``, ``conv1.weight`` (bn, c_in, 1, 1),
    ``norm2.weight``, ``norm2.bias``, ``conv2.weight`` (g, bn, 3, 3)) to
    tensors.  a = rsqrt(var + eps) * weight and b = bias - mean * a, in
    f32; the weights are cast to ``dtype`` (the kernel's operand type;
    training keeps them f32 and ``FusedDenseBlockFn`` casts them, so
    their gradients reach the f32 parameters unrounded).  Every step is
    differentiable, so batch statistics fold with their gradient."""
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


def _geometry(c0: int, packed: dict) -> tuple[int, int, int, int]:
    """(c0, L, bn, growth), checked against every packed tensor's size."""
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


def _check_kernel_args(what: str, c0: int, maps: list, packed: dict):
    """Geometry of a kernel call with block input width ``c0``, after
    checking what the CUDA kernels take: bf16 (B, H, W, C) maps on CUDA,
    growth 32, bottleneck 128, C0 % 32 == 0, every tensor contiguous,
    16-byte aligned and on the maps' device, w1/w2 bf16 and the affines
    f32."""
    device = maps[0].device
    if device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {device}")
    for t in maps:
        if t.dim() != 4 or t.dtype != torch.bfloat16:
            raise TypeError(
                f"{what} kernel takes (B, H, W, C) bf16 maps, got "
                f"{tuple(t.shape)} {t.dtype}"
            )
    c0, L, bn, g = _geometry(c0, packed)
    if g != _KERNEL_GROWTH or bn != _KERNEL_BN or c0 % _KERNEL_CHUNK:
        raise ValueError(
            f"{what} kernel takes growth {_KERNEL_GROWTH}, "
            f"bottleneck {_KERNEL_BN} and C0 % {_KERNEL_CHUNK} == 0; got "
            f"growth {g}, bottleneck {bn}, C0 {c0}"
        )
    want = dict(zip(_PACKED_KEYS, (torch.float32, torch.float32, torch.bfloat16,
                                   torch.float32, torch.float32, torch.bfloat16)))
    tensors = [(t, torch.bfloat16) for t in maps] + [(packed[k], want[k]) for k in _PACKED_KEYS]
    for t, dt in tensors:
        if t.device != device or t.dtype != dt or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(
                f"{what} kernel needs every tensor contiguous, 16-byte "
                f"aligned, on one device, with the maps and w1/w2 bf16 and "
                f"a1/b1/a2/b2 f32"
            )
    return c0, L, bn, g


def fused_dense_block_plain(x0: torch.Tensor, packed: dict) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch.  Products take operands
    rounded to ``x0.dtype`` (the weights too) and accumulate in f32 (they
    run as f32 matmul and conv on those rounded values, so set TF32 off on
    a GPU to keep them exact).  Differentiable by autograd."""
    if x0.dim() != 4:
        raise ValueError(f"x0 must be (B, H, W, C0), got {tuple(x0.shape)}")
    c0, L, bn, g = _geometry(x0.shape[-1], packed)
    dt = x0.dtype
    out = x0
    for l in range(L):
        c_in = c0 + l * g
        off = _layer_offset(l, c0, g)
        a1 = packed["a1"][off:off + c_in]
        b1 = packed["b1"][off:off + c_in]
        w1 = packed["w1"][off * bn:(off + c_in) * bn].view(bn, c_in)
        hid = torch.relu(out.float() * a1 + b1).to(dt).float()
        y1 = hid @ w1.to(dt).float().t()
        h2 = torch.relu(y1 * packed["a2"][l] + packed["b2"][l]).to(dt).float()
        k = packed["w2"][l].to(dt).float().view(3, 3, g, bn).permute(2, 3, 0, 1)
        strip = F.conv2d(h2.permute(0, 3, 1, 2), k, padding=1)
        out = torch.cat([out, strip.permute(0, 2, 3, 1).to(dt)], -1)
    return out


def fused_dense_block(x0: torch.Tensor, packed: dict) -> torch.Tensor:
    """Dense block forward: x0 (B, H, W, C0) -> (B, H, W, C0 + L*growth),
    NHWC, in ``x0.dtype``; ``packed`` from ``pack_block_params``.

    A CPU tensor goes through ``fused_dense_block_plain``.  A CUDA tensor
    launches the kernels (a copy of x0 into the output, then the 1x1 and
    the 3x3 of each layer, on an h2 workspace from ``block_plan``, all on
    the current stream, no synchronisation) or raises.  A call adds L, its
    layers, to ``fused_dense_block.launches``, whatever number of CUDA
    launches it makes."""
    if x0.device.type == "cpu":
        return fused_dense_block_plain(x0, packed)
    c0, L, bn, g = _check_kernel_args("fused_dense_block", x0.shape[-1], [x0], packed)
    b, h, w, _ = x0.shape
    plan = block_plan(b, h, w, c0, L, _card_sms(x0.device))
    out = torch.empty((b, h, w, c0 + L * g), dtype=x0.dtype, device=x0.device)
    h2 = _empty(plan, "fwd_h2", x0.device)
    lib = _build.load("fused_dense_block", _SIGNATURES)
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    err = lib.ddl_fused_dense_block_fwd(
        x0.device.index or 0, x0.data_ptr(), out.data_ptr(),
        *(packed[k].data_ptr() for k in _PACKED_KEYS), h2.data_ptr(), b, h, w, c0, L,
        plan["wg"], plan["grid_1x1"], plan["grid_3x3"], stream,
    )
    _build.check(lib, err, "fused_dense_block kernel")
    fused_dense_block.launches += L
    return out


fused_dense_block.launches = 0


def fused_block_takes(dtype, growth: int, bn_size: int, c0: int, device_type: str) -> bool:
    """Whether a block of ``growth``, bottleneck ``bn_size * growth`` and
    input width ``c0``, its maps in ``dtype`` on ``device_type``, runs
    through the fused kernels.  Off CUDA the plain versions take every
    block; on CUDA the kernels take what ``_check_kernel_args`` accepts:
    bf16 maps, growth 32, bottleneck 128, C0 a multiple of 32.  Call sites
    run what this refuses as the packed block does (cuDNN convolutions)."""
    if device_type != "cuda":
        return True
    return (dtype == torch.bfloat16 and growth == _KERNEL_GROWTH
            and bn_size * growth == _KERNEL_BN and c0 % _KERNEL_CHUNK == 0)


def _layer_offset(l: int, c0: int, g: int) -> int:
    """Where layer l's ``c0 + l*g`` entries start in the ragged a1/b1."""
    return l * c0 + g * l * (l - 1) // 2


def fused_dense_block_bwd_plain(out: torch.Tensor, g: torch.Tensor,
                                packed: dict) -> tuple[torch.Tensor, dict]:
    """The backward kernel's arithmetic in plain PyTorch: the VJP of
    ``fused_dense_block`` with the folded tensors as independent inputs.

    ``out`` is the forward's output (B, H, W, C0 + L*growth), ``g`` its
    cotangent.  Returns ``(dx0, grads)``: dx0 (B, H, W, C0) in
    ``out.dtype`` and ``grads[k]`` for every packed tensor, f32, in
    ``packed``'s layouts.  Same recompute structure and rounding points as
    ``_bwd_kernel`` (ddl_tpu/ops/fused_dense_block.py:303-386): each
    layer's hid/y1/h2 recomputed in f32 from ``out``; the strip cotangent
    rounded to the compute dtype for both the 3x3 transpose and dW2; hid
    and dy1 rounded for dW1 and dhid; the map cotangent accumulated in
    f32.  Products run as f32 matmuls on rounded operands (TF32 off on a
    GPU keeps them exact)."""
    L, bn = packed["a2"].shape
    gr = packed["w2"].shape[2]
    c0 = out.shape[-1] - L * gr
    _geometry(c0, packed)
    if g.shape != out.shape:
        raise ValueError(f"cotangent {tuple(g.shape)} != output {tuple(out.shape)}")
    dt = out.dtype
    b, h, w, _ = out.shape
    f32 = torch.float32
    dx = g.to(f32).clone()
    grads = {k: torch.zeros(packed[k].shape, dtype=f32, device=out.device)
             for k in _PACKED_KEYS}
    for l in reversed(range(L)):
        c_in = c0 + l * gr
        off = _layer_offset(l, c0, gr)
        a1 = packed["a1"][off:off + c_in]
        w1 = packed["w1"][off * bn:(off + c_in) * bn].view(bn, c_in).to(dt).float()
        a2 = packed["a2"][l]
        w2 = packed["w2"][l].to(dt).float()  # (9, growth, bn)
        x = out[..., :c_in].float()
        z1 = x * a1 + packed["b1"][off:off + c_in]
        hid = torch.relu(z1).to(dt).float()
        y1 = hid @ w1.t()
        z2 = y1 * a2 + packed["b2"][l]
        h2 = torch.relu(z2).to(dt).float()
        dstrip = dx[..., c_in:c_in + gr].to(dt).float()
        h2p = F.pad(h2, (0, 0, 1, 1, 1, 1))
        dsp = F.pad(dstrip, (0, 0, 1, 1, 1, 1))
        dh2 = torch.zeros_like(h2)
        for dy in range(3):
            for dx_ in range(3):
                tap = dy * 3 + dx_
                # forward: strip[p] += h2[p + (dy-1, dx-1)] @ w2[tap]^T
                grads["w2"][l, tap] = torch.einsum(
                    "bhwn,bhwk->nk", dstrip, h2p[:, dy:dy + h, dx_:dx_ + w])
                dh2 += dsp[:, 2 - dy:2 - dy + h, 2 - dx_:2 - dx_ + w] @ w2[tap]
        dz2 = torch.where(z2 > 0, dh2, 0.0)
        grads["a2"][l] = (dz2 * y1).sum((0, 1, 2))
        grads["b2"][l] = dz2.sum((0, 1, 2))
        dy1 = (dz2 * a2).to(dt).float()
        grads["w1"][off * bn:(off + c_in) * bn] = (
            dy1.reshape(-1, bn).t() @ hid.reshape(-1, c_in)).flatten()
        dz1 = torch.where(z1 > 0, dy1 @ w1, 0.0)
        grads["a1"][off:off + c_in] = (dz1 * x).sum((0, 1, 2))
        grads["b1"][off:off + c_in] = dz1.sum((0, 1, 2))
        dx[..., :c_in] += dz1 * a1
    return dx[..., :c0].to(dt), grads


def fused_dense_block_bwd(out: torch.Tensor, g: torch.Tensor,
                          packed: dict) -> tuple[torch.Tensor, dict]:
    """Dense block backward: ``fused_dense_block_bwd_plain``'s function.

    A CPU tensor goes through the plain version.  A CUDA tensor launches
    the kernels (a seed of the f32 map cotangent from g, one sweep launch
    per layer in reverse order, one dW1 and one dW2 launch over pixel
    slices, fixed-order sums of the partials and a cast of dx0, on
    workspaces from ``block_plan``, all on the current stream, no
    synchronisation, no atomics: two calls on the same inputs give
    bit-identical results) or raises.  A call adds L, its layers, to
    ``fused_dense_block_bwd.launches``, whatever number of CUDA launches it
    makes."""
    if out.device.type == "cpu":
        return fused_dense_block_bwd_plain(out, g, packed)
    L = packed["a2"].shape[0]
    c0 = out.shape[-1] - L * packed["w2"].shape[2]
    c0, L, bn, gr = _check_kernel_args("fused_dense_block_bwd", c0, [out, g], packed)
    if g.shape != out.shape:
        raise ValueError(f"cotangent {tuple(g.shape)} != output {tuple(out.shape)}")
    b, h, w, _ = out.shape
    plan = block_plan(b, h, w, c0, L, _card_sms(out.device))
    ws = {k: _empty(plan, k, out.device)
          for k in ("dx", "dy1", "h2", "ds", "part_w1", "part_w2", "part_a1", "part_b1",
                    "part_a2", "part_b2")}
    dx0 = torch.empty((b, h, w, c0), dtype=out.dtype, device=out.device)
    grads = {k: torch.empty(packed[k].shape, dtype=torch.float32, device=out.device)
             for k in _PACKED_KEYS}
    lib = _build.load("fused_dense_block_bwd", _BWD_SIGNATURES)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    err = lib.ddl_fused_dense_block_bwd(
        out.device.index or 0, out.data_ptr(), g.data_ptr(), ws["dx"].data_ptr(),
        dx0.data_ptr(), *(packed[k].data_ptr() for k in _PACKED_KEYS),
        *(grads[k].data_ptr() for k in _PACKED_KEYS),
        *(ws[k].data_ptr() for k in ("dy1", "h2", "ds", "part_w1", "part_w2", "part_a1",
                                     "part_b1", "part_a2", "part_b2")),
        b, h, w, c0, L, plan["wg"], plan["grid_bwd"], plan["split"], plan["s1"], plan["s2"],
        stream,
    )
    _build.check(lib, err, "fused_dense_block_bwd kernel")
    fused_dense_block_bwd.launches += L
    return dx0, grads


fused_dense_block_bwd.launches = 0


class FusedDenseBlockFn(torch.autograd.Function):
    """The fused block as an autograd Function (``_diff_block_fn`` of the
    JAX package): ``apply(x0, a1, b1, w1, a2, b2, w2, plain)``.

    The inputs are the block input and ``pack_affines``'s tensors, with
    w1/w2 in f32: the forward casts them to ``x0.dtype`` for the kernel,
    and the backward returns their gradients in f32, so autograd hands
    them to the f32 parameters unrounded.  The forward saves only its
    output (the whole feature map: every layer's input is a prefix of it)
    and the folded tensors.  ``plain=True`` runs the plain versions on any
    device (the reference path); otherwise each wrapper takes the kernel
    for CUDA tensors and the plain version for CPU tensors."""

    @staticmethod
    def forward(ctx, x0, a1, b1, w1, a2, b2, w2, plain=False):
        dt = x0.dtype
        packed = {"a1": a1, "b1": b1, "w1": w1.to(dt), "a2": a2, "b2": b2,
                  "w2": w2.to(dt)}
        out = (fused_dense_block_plain if plain else fused_dense_block)(x0, packed)
        ctx.save_for_backward(out, *(packed[k] for k in _PACKED_KEYS))
        ctx.plain = plain
        return out

    @staticmethod
    def backward(ctx, g):
        out, *tensors = ctx.saved_tensors
        packed = dict(zip(_PACKED_KEYS, tensors))
        bwd = fused_dense_block_bwd_plain if ctx.plain else fused_dense_block_bwd
        dx0, grads = bwd(out, g.to(out.dtype).contiguous(), packed)
        return (dx0, *(grads[k] for k in _PACKED_KEYS), None)


def fused_dense_block_fn(x0: torch.Tensor, packed: dict) -> torch.Tensor:
    """Differentiable fused block through the kernels (CUDA tensors) or
    the plain versions (CPU tensors)."""
    return FusedDenseBlockFn.apply(x0, *(packed[k] for k in _PACKED_KEYS), False)


def fused_dense_block_fn_plain(x0: torch.Tensor, packed: dict) -> torch.Tensor:
    """Differentiable fused block through the plain versions on any device."""
    return FusedDenseBlockFn.apply(x0, *(packed[k] for k in _PACKED_KEYS), True)
