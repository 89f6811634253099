"""The port's flash-attention forward (ddl_tpu_torch/ops/flash_attention.py)
against the JAX package's Pallas kernel in interpret mode, with small
blocks so the online softmax runs over several tiles: out and lse in f32
to 1e-5, causal or not, GQA, sliding window, ``kv_offset`` with rows that
see no key, and a T that no block divides.  On the CPU the port runs
``flash_attention_with_lse_plain``; the CUDA kernel is held to it by
chip_smoke.py on the card.  Also pinned: the argument checks and the
``flash="auto"`` resolution rule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl_tpu.ops.flash_attention import flash_attention_with_lse as jax_flash_with_lse
from ddl_tpu_torch.models.transformer import LMConfig
from ddl_tpu_torch.ops.flash_attention import (
    FLASH_AUTO_MIN_T,
    flash_attention,
    flash_attention_plain,
    flash_attention_with_lse,
    flash_attention_with_lse_plain,
    use_flash,
)

# (B, T, H, Hkv, D, causal, window, kv_offset)
CASES = {
    "mha-causal": (2, 32, 4, 4, 8, True, 0, 0),
    "bidirectional": (2, 24, 4, 2, 8, False, 0, 0),
    "gqa-causal": (1, 32, 6, 2, 8, True, 0, 0),
    "window": (2, 32, 4, 2, 8, True, 5, 0),
    "kv-offset-empty-rows": (1, 16, 4, 4, 8, True, 8, 16),
    "kv-offset-partial": (2, 24, 4, 2, 8, True, 0, 6),
    "ragged-t": (2, 20, 4, 2, 16, True, 0, 0),
}


def _qkv(seed, b, t, h, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h, d)).astype(np.float32),
            rng.standard_normal((b, t, hkv, d)).astype(np.float32),
            rng.standard_normal((b, t, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("case", CASES)
def test_flash_with_lse_matches_jax_kernel(case):
    b, t, h, hkv, d, causal, window, off = CASES[case]
    q, k, v = _qkv(0, b, t, h, hkv, d)
    want, want_lse = jax_flash_with_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        causal=causal, window=window, kv_offset=off,
                                        block_q=8, block_k=8, interpret=True)
    got, lse = flash_attention_with_lse(torch.from_numpy(q), torch.from_numpy(k),
                                        torch.from_numpy(v), causal, window, off)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5, rtol=1e-5)
    out_only = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               causal, window, off)
    torch.testing.assert_close(out_only, got, rtol=0, atol=0)


def test_empty_band_rows_are_zero_with_the_floor_lse():
    """kv_offset pushes the band past every key for the later rows: output
    exactly 0 and lse at -1e30 + log(1e-30), as the TPU kernel."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 16, 2, 2, 8))
    out, lse = flash_attention_with_lse_plain(q, k, v, causal=True, window=4, kv_offset=12)
    q_pos = np.arange(16)
    empty = q_pos + 12 - 4 >= 15  # the first visible key position is past the last key
    assert empty.any() and not empty.all()
    assert (out[0, empty] == 0).all()
    floor = np.float32(-1e30) + np.log(np.float32(1e-30))
    assert (lse[0][:, empty] == floor).all()
    assert torch.isfinite(out).all() and (lse[0][:, ~empty] > -1e29).all()


def test_bf16_inputs_keep_their_dtype_and_f32_lse():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(2, 1, 16, 4, 2, 8))
    out, lse = flash_attention_with_lse(q, k, v, causal=True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    want = flash_attention_plain(q.float(), k.float(), v.float(), causal=True)
    torch.testing.assert_close(out.float(), want, atol=2 ** -7 * want.abs().max().item(), rtol=0)


@pytest.mark.parametrize("kwargs, match", [
    (dict(window=-1, causal=True), ">= 0"),
    (dict(window=4), "causal"),
    (dict(kv_offset=-1, causal=True), ">= 0"),
    (dict(kv_offset=3), "causal"),
])
def test_flash_argument_errors(kwargs, match):
    x = torch.zeros(1, 8, 2, 8)
    with pytest.raises(ValueError, match=match):
        flash_attention(x, x, x, **kwargs)


def test_flash_head_mismatches():
    q = torch.zeros(1, 8, 4, 8)
    with pytest.raises(ValueError, match="divide"):
        flash_attention(q, torch.zeros(1, 8, 3, 8), torch.zeros(1, 8, 3, 8))
    with pytest.raises(ValueError, match="heads"):
        flash_attention(q, torch.zeros(1, 8, 2, 8), torch.zeros(1, 8, 4, 8))


def test_flash_auto_resolution_rule():
    """``flash="auto"`` takes the kernel from FLASH_AUTO_MIN_T positions on;
    True always, False never; a bidirectional config never."""
    auto = LMConfig(flash="auto")
    assert not use_flash(auto, FLASH_AUTO_MIN_T - 1)
    assert use_flash(auto, FLASH_AUTO_MIN_T)
    assert use_flash(LMConfig(flash=True), 1)
    assert not use_flash(LMConfig(flash=False), 10 ** 6)
    assert not use_flash(LMConfig(flash=True, causal=False), 10 ** 6)
