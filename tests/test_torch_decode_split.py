"""The int8 decode kernel's split of the keys (ddl_tpu_torch/ops/
decode_attention.py): ``decode_split_plan`` covers every key once, keeps
every bulk copy on a 16-byte boundary, fits the block's shared memory and
fills the H100 at the 124M decode's variants B and C; and
``decode_split_combine_plain``, the kernel's per-range (m, l, acc) and its
fixed-order combine in PyTorch, against the JAX package's Pallas decode
kernels in interpret mode (``block_l=4``): 1, 2, 7 and 16 ranges, bf16 and
int8 caches, a shared and a per-lane bias, ranges whose keys are all masked
and ranges with no key at all.  f32 to 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl_tpu.ops import quant as jq
from ddl_tpu.ops.decode_attention import decode_attention as jax_decode_attention
from ddl_tpu.ops.decode_attention import quant_decode_attention as jax_quant_decode_attention
from ddl_tpu_torch.ops._build import H100_SMS, SMEM_PER_BLOCK
from ddl_tpu_torch.ops.decode_attention import (
    decode_split_combine_plain,
    decode_split_plan,
    split_smem,
)

B, L, H, HKV, D = 3, 16, 6, 2, 8

# (B, L, Hkv, G, D): the 124M decode's variants B (batch 32, 1024 + 64) and
# C (batch 1, the 1024-slot ring), chip_smoke.py's other int8 caches
# (variant A's shape, the masked stretch, ragged L, every grouping at both
# head dims), and edges (one key, a cache shorter than the SM count)
VARIANTS = {"B": (32, 1088, 4, 3, 64), "C": (1, 1024, 4, 3, 64)}
SHAPES = {**VARIANTS, "A-shaped": (8, 2176, 12, 1, 64), "masked stretch": (3, 1500, 4, 3, 64),
          "ragged 1001": (2, 1001, 4, 3, 64), "ragged 300": (2, 300, 4, 3, 64),
          "D128 G8": (2, 300, 2, 8, 128), "D64 G1": (2, 300, 2, 1, 64), "one key": (1, 1, 4, 3, 64),
          "L 50": (1, 50, 4, 3, 64), "B 200": (200, 64, 8, 2, 128)}


@pytest.mark.parametrize("shape", SHAPES)
def test_split_plan_covers_each_key_once_aligned_and_fits(shape):
    b, length, hkv, g, d = SHAPES[shape]
    plan = decode_split_plan(b, length, hkv, g, d)
    assert hkv % plan.heads == 0 and plan.keys >= 1
    covered = [k for lo, n in plan.ranges(length) for k in range(lo, lo + n)]
    assert covered == list(range(length))
    assert all(n >= 1 for _, n in plan.ranges(length))  # no range is wasted
    row = hkv * d  # int8 bytes per staged key: the whole cache row
    for bi in range(b):
        for lo, n in plan.ranges(length):  # one span per 32 keys and cache
            starts = [(bi * length + lo + c) * row for c in range(0, n, 32)]
            sizes = [min(32, n - c) * row for c in range(0, n, 32)]
            assert all(s % 16 == 0 for s in starts + sizes)
    assert plan.smem == split_smem(hkv, plan.heads, plan.keys, d, g) <= SMEM_PER_BLOCK
    assert 3 * plan.smem <= SMEM_PER_BLOCK or plan.keys == 16  # three CTAs share an SM


@pytest.mark.parametrize("variant", VARIANTS)
def test_split_plan_fills_the_h100_at_the_decode_variants(variant):
    b, length, hkv, g, d = VARIANTS[variant]
    plan = decode_split_plan(b, length, hkv, g, d)
    assert plan.ctas(b, hkv) >= H100_SMS
    # every CTA resident at once: three an SM by shared memory
    assert plan.ctas(b, hkv) <= 3 * H100_SMS


def _inputs(seed, bias_kind):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, L, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, L, HKV, D)).astype(np.float32)
    rows = 1 if bias_kind == "shared" else B
    mask = rng.random((rows, L)) > 0.3
    mask[:, -1] = True
    if bias_kind == "masked-range":
        mask[:, :4] = False  # whole ranges masked at 7 and 16 ranges
    if bias_kind == "per-lane":
        mask[1] = False  # a lane that sees nothing: output 0
    return q, k, v, np.where(mask, 0.0, -1e30).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


SPLITS = [1, 2, 7, 16]  # 7 ranges of 3 keys: the last one has none
BIASES = ["shared", "per-lane", "masked-range"]


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("bias_kind", BIASES)
@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_split_and_combine_matches_the_jax_kernels(cache, bias_kind, splits):
    q, k, v, bias = _inputs(7 + splits, bias_kind)
    keys = -(-L // splits)
    if cache == "bf16":
        ck, cv = k.reshape(B, L, HKV * D), v.reshape(B, L, HKV * D)
        want = jax_decode_attention(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                                    jnp.asarray(bias), hkv=HKV, block_l=4, interpret=True)
        got = decode_split_combine_plain(_t(q), _t(ck), _t(cv), _t(bias), hkv=HKV, keys=keys,
                                         splits=splits)
    else:
        kq, ks = jq.quantize_q8(jnp.asarray(k))
        vq, vs = jq.quantize_q8(jnp.asarray(v))
        args = (kq.reshape(B, L, -1), ks[..., 0].transpose(0, 2, 1), vq.reshape(B, L, -1),
                vs[..., 0].transpose(0, 2, 1))
        want = jax_quant_decode_attention(jnp.asarray(q), *args, jnp.asarray(bias), hkv=HKV,
                                          block_l=4, interpret=True)
        tk, tks, tv, tvs = (_t(np.asarray(a)) for a in args)
        got = decode_split_combine_plain(_t(q), tk, tv, _t(bias), hkv=HKV, keys=keys,
                                         splits=splits, ks=tks, vs=tvs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    if bias_kind == "per-lane":
        assert (got[1] == 0).all()  # every range masked: exactly 0


def test_a_range_past_the_cache_adds_nothing():
    """Ranges with no key (m = -1e30, l = 0, acc = 0) and ranges whose keys
    are all masked leave the result exactly as without them."""
    q, k, v, bias = _inputs(3, "masked-range")
    ck, cv = _t(k.reshape(B, L, HKV * D)), _t(v.reshape(B, L, HKV * D))
    base = decode_split_combine_plain(_t(q), ck, cv, _t(bias), hkv=HKV, keys=4, splits=4)
    padded = decode_split_combine_plain(_t(q), ck, cv, _t(bias), hkv=HKV, keys=4, splits=9)
    torch.testing.assert_close(padded, base, rtol=0, atol=0)
