"""The port's fused dense block (ddl_tpu_torch/ops/fused_dense_block.py)
against the JAX package's Pallas kernel in interpret mode: the fold, the
OIHW -> tap-order weight layout, and the forward in f32 and bf16.  On the
CPU the port runs its plain version; the CUDA kernel itself is held to
that plain version by chip_smoke.py on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl_tpu.ops.fused_dense_block import block_pad, fused_dense_block_eval
from ddl_tpu.ops.fused_dense_block import pack_block_params as jax_pack_block_params
from ddl_tpu_torch.models.convert import from_jax_params
from ddl_tpu_torch.ops.fused_dense_block import (
    fused_dense_block,
    fused_dense_block_plain,
    pack_block_params,
)


def _jax_layers(seed, c0, growth, bn, n_layers):
    """Seeded layer params and running stats in the JAX package's layout
    (HWIO kernels, positive variances)."""
    rng = np.random.default_rng(seed)

    def normal(*shape, std=1.0):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def uniform(n):
        return rng.uniform(0.5, 1.5, n).astype(np.float32)

    params, stats = [], []
    for i in range(n_layers):
        c = c0 + i * growth
        params.append({
            "norm1": {"scale": uniform(c), "bias": normal(c, std=0.1)},
            "conv1": {"kernel": normal(1, 1, c, bn, std=(2 / c) ** 0.5)},
            "norm2": {"scale": uniform(bn), "bias": normal(bn, std=0.1)},
            "conv2": {"kernel": normal(3, 3, bn, growth, std=(2 / (9 * bn)) ** 0.5)},
        })
        stats.append({
            "norm1": {"mean": normal(c, std=0.5), "var": uniform(c)},
            "norm2": {"mean": normal(bn, std=0.5), "var": uniform(bn)},
        })
    return params, stats


def _port_layers(params, stats):
    """The same layers as the port's per-layer state mappings (OIHW),
    carried across by models/convert.from_jax_params."""
    sd = from_jax_params(
        [{"b": {f"l{i}": p for i, p in enumerate(params)}}],
        [{"b": {f"l{i}": s for i, s in enumerate(stats)}}],
    )
    return [
        {k.removeprefix(f"features.b.l{i}."): v for k, v in sd.items()
         if k.startswith(f"features.b.l{i}.")}
        for i in range(len(params))
    ]


def _both(seed, b, h, w, c0, growth, bn, n_layers, dtype):
    """(port output, JAX kernel output) on the same seeded block, as f32."""
    params, stats = _jax_layers(seed, c0, growth, bn, n_layers)
    x = np.random.default_rng(seed + 1).standard_normal((b, h, w, c0)).astype(np.float32) * 2
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    packed = jax_pack_block_params(params, stats, c0, growth)
    want = fused_dense_block_eval(
        jnp.asarray(x, jdt), packed, c0=c0, growth=growth, interpret=True
    )
    pad0, _ = block_pad(c0, n_layers, growth)
    want = np.asarray(want[..., pad0:pad0 + c0 + n_layers * growth], np.float32)
    port_packed = pack_block_params(_port_layers(params, stats), dtype)
    got = fused_dense_block_plain(torch.from_numpy(x).to(dtype), port_packed)
    return got.float().numpy(), want


def test_fold_matches_jax_fold():
    """Same affines (to f32 rounding of rsqrt and of b = bias - mean * a:
    1e-6), same weights exactly, in the port's ragged layout."""
    c0, growth, bn, n_layers = 16, 8, 16, 3
    params, stats = _jax_layers(0, c0, growth, bn, n_layers)
    want = jax_pack_block_params(params, stats, c0, growth)
    got = pack_block_params(_port_layers(params, stats), torch.float32)
    pad0, _ = block_pad(c0, n_layers, growth)
    off = 0
    for i in range(n_layers):
        c_in = c0 + i * growth
        cols = slice(pad0, pad0 + c_in)
        for k in ("a1", "b1"):
            np.testing.assert_allclose(got[k][off:off + c_in].numpy(),
                                       np.asarray(want[k][i, 0, cols]),
                                       rtol=1e-6, atol=1e-6)
        w1 = got["w1"][off * bn:(off + c_in) * bn].view(bn, c_in)
        np.testing.assert_array_equal(w1.numpy().T, np.asarray(want["w1"][i, cols]))
        for k in ("a2", "b2"):
            np.testing.assert_allclose(got[k][i].numpy(), np.asarray(want[k][i, 0]),
                                       rtol=1e-6, atol=1e-6)
        off += c_in


def test_oihw_reordered_to_tap_order():
    """packed w2[l, dy*3+dx] is the OIHW kernel's (out, in) matrix at
    (dy, dx), i.e. the transpose of the JAX package's HWIO tap."""
    c0, growth, bn, n_layers = 16, 8, 16, 2
    params, stats = _jax_layers(1, c0, growth, bn, n_layers)
    layers = _port_layers(params, stats)
    w2 = pack_block_params(layers, torch.float32)["w2"]
    jax_w2 = np.asarray(jax_pack_block_params(params, stats, c0, growth)["w2"])
    assert w2.shape == (n_layers, 9, growth, bn)
    for i in range(n_layers):
        for dy in range(3):
            for dx in range(3):
                tap = w2[i, dy * 3 + dx]
                torch.testing.assert_close(tap, layers[i]["conv2.weight"][:, :, dy, dx],
                                           rtol=0, atol=0)
                np.testing.assert_array_equal(tap.numpy().T, jax_w2[i, dy * 3 + dx])


# f32: the same arithmetic in another order, 1e-4.  bf16: both round the
# layer input, the 1x1 and 3x3 operands and the strip to bf16 at the same
# places, so they differ where another f32 summation order flips one
# rounding: one bf16 ulp, at most 2^-7 of the largest value; 1e-2 of the
# largest value admits that and no more.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_matches_jax_kernel(dtype):
    got, want = _both(2, b=2, h=6, w=6, c0=16, growth=8, bn=16, n_layers=3, dtype=dtype)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def test_plain_respects_conv_padding():
    """A 3x3 map: every pixel is a border pixel, so the zero halo of the
    3x3 is pinned on every side."""
    got, want = _both(3, b=1, h=3, w=3, c0=8, growth=8, bn=8, n_layers=2,
                      dtype=torch.float32)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_wrapper_on_cpu_is_the_plain_version():
    params, stats = _jax_layers(4, 16, 8, 16, 2)
    packed = pack_block_params(_port_layers(params, stats), torch.bfloat16)
    x = torch.randn(2, 5, 7, 16, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    before = fused_dense_block.launches
    torch.testing.assert_close(fused_dense_block(x, packed),
                               fused_dense_block_plain(x, packed), rtol=0, atol=0)
    assert fused_dense_block.launches == before


def test_wrapper_rejects_a_mismatched_fold():
    params, stats = _jax_layers(5, 16, 8, 16, 2)
    packed = pack_block_params(_port_layers(params, stats), torch.float32)
    with pytest.raises(ValueError, match="packed"):
        fused_dense_block(torch.zeros(1, 4, 4, 24), packed)  # C0 24, fold made for 16
