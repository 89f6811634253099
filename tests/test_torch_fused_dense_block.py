"""The port's fused dense block (ddl_tpu_torch/ops/fused_dense_block.py)
against the JAX package's Pallas kernels in interpret mode: the fold, the
OIHW -> tap-order weight layout, the forward in f32 and bf16, the backward
(jax.vjp of the custom-VJP block) in f32 and bf16, and the autograd
Function.  On the CPU the port runs its plain versions; the CUDA kernels
themselves are held to those plain versions by chip_smoke.py on the
card; here ``block_plan``'s partition of the work (pixel tiles, persistent
grids, dW1 tiles, pixel slices, workspaces) is checked at DenseNet121's
four block geometries and the card check's edge shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl_tpu.ops.fused_dense_block import block_pad, fused_dense_block_eval
from ddl_tpu.ops.fused_dense_block import fused_dense_block as jax_fused_dense_block
from ddl_tpu.ops.fused_dense_block import pack_block_params as jax_pack_block_params
from ddl_tpu_torch.models.convert import from_jax_params
from ddl_tpu_torch.ops.fused_dense_block import (
    block_plan,
    dw1_tiles,
    fused_dense_block,
    fused_dense_block_bwd,
    fused_dense_block_bwd_plain,
    fused_dense_block_fn,
    fused_dense_block_plain,
    pack_block_params,
    persistent_tiles,
    slice_chunks,
    sweep_units,
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


def _vjps(seed, b, h, w, c0, growth, bn, n_layers, dtype):
    """{gradient name: (port, JAX)} as flat f32 arrays: the port's plain
    backward against jax.vjp of the JAX package's differentiable block
    (both Pallas kernels in interpret mode), same layers, input and
    output cotangent.  JAX's padded gradients are mapped to the port's
    ragged layouts: da1[i, 0, pad0:pad0+c_in], dw1[i, pad0:pad0+c_in, :]
    transposed, dw2 with its last two axes swapped."""
    params, stats = _jax_layers(seed, c0, growth, bn, n_layers)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((b, h, w, c0)).astype(np.float32) * 2
    g = rng.standard_normal((b, h, w, c0 + n_layers * growth)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    pad0, _ = block_pad(c0, n_layers, growth)
    out, vjp = jax.vjp(
        lambda x, pk: jax_fused_dense_block(x, pk, c0=c0, growth=growth, interpret=True),
        jnp.asarray(x, jdt), jax_pack_block_params(params, stats, c0, growth))
    g_padded = np.zeros(out.shape, np.float32)
    g_padded[..., pad0:pad0 + g.shape[-1]] = g
    dx0, dpk = vjp(jnp.asarray(g_padded, jdt))

    packed = pack_block_params(_port_layers(params, stats), dtype)
    out = fused_dense_block_plain(torch.from_numpy(x).to(dtype), packed)
    got_dx0, got = fused_dense_block_bwd_plain(out, torch.from_numpy(g).to(dtype), packed)
    pairs = {k: ([], []) for k in ("a1", "b1", "w1", "a2", "b2", "w2")}
    off = 0
    for i in range(n_layers):
        c_in = c0 + i * growth
        cols = slice(pad0, pad0 + c_in)
        for k in ("a1", "b1"):
            pairs[k][0].append(got[k][off:off + c_in].numpy())
            pairs[k][1].append(np.asarray(dpk[k][i, 0, cols]))
        pairs["w1"][0].append(got["w1"][off * bn:(off + c_in) * bn].view(bn, c_in).numpy().T)
        pairs["w1"][1].append(np.asarray(dpk["w1"][i, cols]))
        for k in ("a2", "b2"):
            pairs[k][0].append(got[k][i].numpy())
            pairs[k][1].append(np.asarray(dpk[k][i, 0]))
        pairs["w2"][0].append(got["w2"][i].numpy().swapaxes(-1, -2))
        pairs["w2"][1].append(np.asarray(dpk["w2"][i]))
        off += c_in
    flat = {k: (np.concatenate([a.ravel() for a in p]), np.concatenate([a.ravel() for a in q]))
            for k, (p, q) in pairs.items()}
    flat["dx0"] = (got_dx0.float().numpy().ravel(), np.asarray(dx0, np.float32).ravel())
    return flat


# f32: the same arithmetic in another order, 1e-4 of each gradient's
# largest value.  bf16: both round the strip cotangent, hid and dy1 to bf16
# at the same places and dx0 at the end, so they differ where another f32
# summation order flips one rounding: one bf16 ulp, at most 2^-7 of the
# largest value; 1e-2 admits that and no more.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_plain_matches_jax_vjp(dtype):
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    pairs = _vjps(6, b=2, h=6, w=5, c0=16, growth=8, bn=16, n_layers=3, dtype=dtype)
    assert set(pairs) == {"dx0", "a1", "b1", "w1", "a2", "b2", "w2"}
    for k, (got, want) in pairs.items():
        assert got.shape == want.shape, k
        assert np.abs(got - want).max() <= tol * np.abs(want).max(), k


def _f32_block(seed, c0=16, growth=8, bn=16, n_layers=3):
    params, stats = _jax_layers(seed, c0, growth, bn, n_layers)
    packed = pack_block_params(_port_layers(params, stats), torch.float32)
    x = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (2, 5, 7, c0)).astype(np.float32))
    return x, packed


def _grads(fn, x, packed, g):
    """Gradients of sum(fn(x, packed) * g) w.r.t. x and every packed tensor."""
    x = x.clone().requires_grad_()
    packed = {k: v.clone().requires_grad_() for k, v in packed.items()}
    (fn(x, packed).float() * g).sum().backward()
    return {"x0": x.grad, **{k: v.grad for k, v in packed.items()}}


def test_function_gradients_match_autograd_of_the_plain_forward():
    """FusedDenseBlockFn's CPU path (plain forward, plain backward) against
    autograd of fused_dense_block_plain, in f32 — the port's counterpart of
    loss_folded in tests/test_fused_dense_block.py: the backward is the
    true VJP of the forward.  Same products in another order: 1e-5 of each
    gradient's largest value."""
    x, packed = _f32_block(7)
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 5, 7, 16 + 3 * 8)).astype(np.float32))
    got = _grads(fused_dense_block_fn, x, packed, g)
    want = _grads(fused_dense_block_plain, x, packed, g)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        assert (got[k] - v).abs().max() <= 1e-5 * v.abs().max(), k


def test_function_returns_f32_weight_gradients_for_a_bf16_block():
    """A bf16 block with f32 packed weights: the Function casts the
    weights inside, so their gradients come back f32 and unrounded —
    exactly the plain backward's f32 sums — while dx0 is bf16."""
    x, packed = _f32_block(8)
    x = x.to(torch.bfloat16)
    g = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (2, 5, 7, 16 + 3 * 8)).astype(np.float32)).to(torch.bfloat16)
    got = _grads(fused_dense_block_fn, x, packed, g)
    bf16 = {k: v.to(torch.bfloat16) if k in ("w1", "w2") else v for k, v in packed.items()}
    _, want = fused_dense_block_bwd_plain(fused_dense_block_plain(x, bf16), g, bf16)
    assert got["x0"].dtype == torch.bfloat16
    for k in ("w1", "w2"):
        assert got[k].dtype == torch.float32
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
        assert not torch.equal(got[k], got[k].to(torch.bfloat16).float()), k


def test_backward_wrapper_on_cpu_is_the_plain_version():
    x, packed = _f32_block(11)
    out = fused_dense_block_plain(x, packed)
    g = torch.ones_like(out)
    before = fused_dense_block_bwd.launches
    got_dx0, got = fused_dense_block_bwd(out, g, packed)
    want_dx0, want = fused_dense_block_bwd_plain(out, g, packed)
    torch.testing.assert_close(got_dx0, want_dx0, rtol=0, atol=0)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert fused_dense_block_bwd.launches == before


def test_backward_rejects_a_mismatched_cotangent():
    x, packed = _f32_block(12)
    out = fused_dense_block_plain(x, packed)
    with pytest.raises(ValueError, match="cotangent"):
        fused_dense_block_bwd(out, out[..., :-1], packed)


# (B, H, W, C0, L): DenseNet121's blocks 1-4 at batch 30 (block 3 cut to 4
# layers, as the card check runs it), B = 1, C0 = 96 and the edge tiles.
_PLAN_SHAPES = [(30, 56, 56, 64, 6), (30, 28, 28, 128, 12), (30, 14, 14, 256, 4),
                (30, 7, 7, 512, 16), (1, 56, 56, 64, 6), (2, 8, 8, 96, 3), (2, 9, 11, 64, 2)]


@pytest.mark.parametrize("geom", _PLAN_SHAPES)
def test_persistent_grids_cover_every_pixel_once(geom):
    """Every pixel lies in one tile, and every tile is walked by exactly one
    persistent CTA of each launch."""
    b, h, w, c0, n_layers = geom
    plan = block_plan(*geom)
    m = 64 * plan["wg"]
    assert plan["wg"] in (1, 2)
    assert (plan["m_tiles"] - 1) * m < b * h * w <= plan["m_tiles"] * m
    for key in ("grid_1x1", "grid_3x3"):
        grid = plan[key]
        assert 1 <= grid <= plan["m_tiles"]
        walked = [t for cta in range(grid) for t in persistent_tiles(cta, grid, plan["m_tiles"])]
        assert sorted(walked) == list(range(plan["m_tiles"]))
        pixels = np.zeros(b * h * w, np.int64)
        for t in walked:
            pixels[t * m:(t + 1) * m] += 1
        assert (pixels == 1).all()


@pytest.mark.parametrize("geom", _PLAN_SHAPES)
def test_weight_gradient_tiles_cover_every_layer_and_pixel_once(geom):
    """dW1's tiles cover each layer's input channels once; each launch's
    slices cover every pixel once, in order, with no empty slice."""
    b, h, w, c0, n_layers = geom
    plan = block_plan(*geom)
    seen = {l: np.zeros(c0 + 32 * l, np.int64) for l in range(n_layers)}
    for l, n0 in dw1_tiles(c0, n_layers):
        seen[l][n0:n0 + 64] += 1
    assert all((v == 1).all() for v in seen.values())
    for slices in (plan["s1"], plan["s2"]):
        assert 1 <= slices <= plan["n_chunks"]
        chunks = [c for s in range(slices) for c in slice_chunks(s, slices, plan["n_chunks"])]
        assert chunks == list(range(plan["n_chunks"]))
        assert all(len(slice_chunks(s, slices, plan["n_chunks"])) for s in range(slices))
        pixels = np.zeros(b * h * w, np.int64)
        for c in chunks:
            pixels[c * 64:(c + 1) * 64] += 1
        assert (pixels == 1).all()


@pytest.mark.parametrize("geom", _PLAN_SHAPES)
def test_weight_gradient_launches_fill_the_card(geom):
    """The dW1 launch holds two CTAs per SM of a 132-SM card and the dW2
    launch (one CTA a layer and slice) one, or every pixel chunk has its
    own slice where the map is too small."""
    b, h, w, c0, n_layers = geom
    plan = block_plan(*geom)
    for tiles, slices, ctas in ((len(dw1_tiles(c0, n_layers)), plan["s1"], 2 * 132),
                                (n_layers, plan["s2"], 132)):
        assert tiles * slices >= ctas or slices == plan["n_chunks"]
        assert tiles * (slices - 1) < ctas


@pytest.mark.parametrize("geom", _PLAN_SHAPES)
def test_workspaces_hold_what_the_kernels_write(geom):
    """Each workspace's size from the block's geometry: the per-layer dy1
    and h2 maps and transposed bf16 dstrip (rows padded to whole chunks),
    one partial row per slice or sweep CTA of every gradient."""
    b, h, w, c0, n_layers = geom
    plan = block_plan(*geom)
    pix, bn = b * h * w, 128
    c_sum = sum(c0 + 32 * l for l in range(n_layers))
    want = {"fwd_h2": (pix, bn), "dx": (pix, c0 + 32 * n_layers), "dy1": (n_layers, pix, bn),
            "h2": (n_layers, pix, bn), "ds": (n_layers, 32, plan["n_chunks"] * 64),
            "part_w1": (plan["s1"], c_sum * bn),
            "part_w2": (plan["s2"], n_layers * 9 * 32 * bn),
            "part_a1": (plan["grid_bwd"], c_sum), "part_b1": (plan["grid_bwd"], c_sum),
            "part_a2": (plan["grid_bwd"], n_layers * bn),
            "part_b2": (plan["grid_bwd"], n_layers * bn)}
    assert {k: v[0] for k, v in plan["workspace"].items()} == want
    # dW1's tiles write the ragged (bn, c_in) matrices, c_sum * bn entries
    assert sum(bn * min(64, c0 + 32 * l - n0) for l, n0 in dw1_tiles(c0, n_layers)) == c_sum * bn


@pytest.mark.parametrize("geom", _PLAN_SHAPES)
def test_sweep_covers_every_tile_and_chunk_once(geom):
    """The backward sweep: in every layer, each tile is recomputed by its
    ``split`` CTAs, exactly one of which (part 0) writes the tile's
    workspaces, and each of the layer's input chunks is taken by exactly
    one of them; the grid is a multiple of ``split``, so a CTA keeps its
    part, and small maps spread over the card."""
    b, h, w, c0, n_layers = geom
    plan = block_plan(*geom)
    split, grid = plan["split"], plan["grid_bwd"]
    assert grid % split == 0 and 1 <= split <= 4
    assert grid == plan["m_tiles"] * split if split > 1 else grid == min(plan["m_tiles"], 132)
    assert plan["m_tiles"] * split <= 132 or split == 1
    for l in range(n_layers):
        n_chunks = -(-(c0 + 32 * l) // 64)
        chunks = {t: [] for t in range(plan["m_tiles"])}
        leads = {t: 0 for t in range(plan["m_tiles"])}
        for cta in range(grid):
            for t, mine in sweep_units(cta, plan, n_chunks):
                chunks[t] += mine
                leads[t] += all(c % split == 0 for c in mine) and cta % split == 0
        assert all(sorted(v) == list(range(n_chunks)) for v in chunks.values())
        assert all(v == 1 for v in leads.values())
