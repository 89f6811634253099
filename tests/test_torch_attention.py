"""The port's dense attention (ddl_tpu_torch/ops/attention.py) against the
JAX package's ``dense_attention`` on the same seeded inputs: MHA, GQA,
causal, sliding window, and explicit (Tq, Tk) / (B, Tq, Tk) masks, in f32
to 1e-5 and in bf16 to bf16 rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl_tpu.ops.attention import dense_attention as jax_dense_attention
from ddl_tpu_torch.ops.attention import dense_attention

CASES = {
    "mha-causal": dict(h=4, hkv=4, causal=True),
    "gqa-causal": dict(h=4, hkv=2, causal=True),
    "mha-window": dict(h=4, hkv=4, causal=True, window=3),
    "gqa-window": dict(h=6, hkv=2, causal=True, window=2),
    "bidirectional": dict(h=4, hkv=2, causal=False),
    "mask-shared": dict(h=4, hkv=2, mask="shared"),
    "mask-per-row": dict(h=4, hkv=4, mask="per-row"),
    "gqa-mask-per-row": dict(h=6, hkv=3, mask="per-row"),
}


def _inputs(seed, b=2, tq=7, tk=7, h=4, hkv=4, d=8, mask=None, **_):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, tk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, tk, hkv, d)).astype(np.float32)
    m = None
    if mask == "shared":
        m = rng.random((tq, tk)) > 0.4
    elif mask == "per-row":
        m = rng.random((b, tq, tk)) > 0.4
    if m is not None:
        m[..., 0] = True
        m[..., 1, :] = False  # one fully masked row: finite, uniform
    return q, k, v, m


def _both(q, k, v, m, dtype, causal=False, window=0):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_dense_attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                               causal=causal, window=window,
                               mask=None if m is None else jnp.asarray(m))
    got = dense_attention(torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
                          torch.from_numpy(v).to(dtype), causal=causal, window=window,
                          mask=None if m is None else torch.from_numpy(m))
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("case", CASES)
def test_dense_attention_matches_jax_f32(case):
    kw = CASES[case]
    q, k, v, m = _inputs(1, **kw)
    got, want = _both(q, k, v, m, torch.float32, kw.get("causal", False), kw.get("window", 0))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", ["gqa-causal", "mha-window", "mask-per-row"])
def test_dense_attention_matches_jax_bf16(case):
    """Same rounding points (bf16 scores, f32 softmax, bf16 probabilities):
    the outputs agree to one bf16 ulp of the largest value."""
    kw = CASES[case]
    q, k, v, m = _inputs(2, **kw)
    got, want = _both(q, k, v, m, torch.bfloat16, kw.get("causal", False), kw.get("window", 0))
    np.testing.assert_allclose(got, want, atol=2 ** -7 * np.abs(want).max(), rtol=0)


def test_cross_length_mask_for_cached_decode():
    """Tq < Tk with an explicit mask: the cached-attention shape."""
    q, k, v, _ = _inputs(3, tq=2, tk=9, h=4, hkv=2)
    m = np.arange(9)[None, :] <= np.array([[5], [6]])
    got, want = _both(q, k, v, m, torch.float32)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_dense_attention_argument_errors():
    q = torch.zeros(1, 4, 4, 8)
    kv = torch.zeros(1, 4, 3, 8)
    with pytest.raises(ValueError, match="divide"):
        dense_attention(q, kv, kv)
    with pytest.raises(ValueError, match="causal"):
        dense_attention(q, q, q, window=2)
    with pytest.raises(ValueError, match=">= 0"):
        dense_attention(q, q, q, causal=True, window=-1)
    with pytest.raises(ValueError, match="not both"):
        dense_attention(q, q, q, causal=True, window=2,
                        mask=torch.ones(4, 4, dtype=torch.bool))
