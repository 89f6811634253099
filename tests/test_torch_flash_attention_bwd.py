"""The port's flash-attention backward (ddl_tpu_torch/ops/flash_attention.py,
``FlashAttentionFn``) against the JAX package's ``_dq_kernel`` and
``_dkdv_kernel`` (Pallas in interpret mode, small blocks so every sum runs
over several tiles): dq, dk and dv in f32 to 1e-5 for the forward's seven
cases, with both the out and the lse cotangents live.  On the CPU the port
runs ``flash_attention_bwd_plain``; the CUDA kernels are held to it by
chip_smoke.py on the card.  Also pinned: the plain backward equals autograd
through the plain forward, dK/dV stay at Hkv heads, an unused output gets
no cotangent, and the kernel entry points refuse a CPU tensor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl_tpu.ops.flash_attention import flash_attention_with_lse as jax_flash_with_lse
from ddl_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkdv,
    flash_attention_bwd_dkdv_plain,
    flash_attention_bwd_dq,
    flash_attention_bwd_dq_plain,
    flash_attention_bwd_plain,
    flash_attention_fn_plain,
    flash_attention_with_lse,
    flash_attention_with_lse_plain,
)

# (B, T, H, Hkv, D, causal, window, kv_offset): the forward test's cases
CASES = {
    "mha-causal": (2, 32, 4, 4, 8, True, 0, 0),
    "bidirectional": (2, 24, 4, 2, 8, False, 0, 0),
    "gqa-causal": (1, 32, 6, 2, 8, True, 0, 0),
    "window": (2, 32, 4, 2, 8, True, 5, 0),
    "kv-offset-empty-rows": (1, 16, 4, 4, 8, True, 8, 16),
    "kv-offset-partial": (2, 24, 4, 2, 8, True, 0, 6),
    "ragged-t": (2, 20, 4, 2, 16, True, 0, 0),
}


def _inputs(seed, b, t, h, hkv, d):
    """q, k, v and the two cotangents (do (B, T, H, D), dlse (B, H, T))."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, t, h, d), (b, t, hkv, d), (b, t, hkv, d), (b, t, h, d), (b, h, t))]


@pytest.mark.parametrize("case", CASES)
def test_grads_match_jax_kernels(case):
    b, t, h, hkv, d, causal, window, off = CASES[case]
    q, k, v, do, dlse = _inputs(0, b, t, h, hkv, d)
    _, vjp = jax.vjp(
        lambda q_, k_, v_: jax_flash_with_lse(q_, k_, v_, causal=causal, window=window,
                                              kv_offset=off, block_q=8, block_k=8,
                                              interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = flash_attention_with_lse(qt, kt, vt, causal, window, off)
    got = torch.autograd.grad((out, lse), (qt, kt, vt),
                              (torch.from_numpy(do), torch.from_numpy(dlse)))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_equals_autograd_through_the_plain_forward(case):
    b, t, h, hkv, d, causal, window, off = CASES[case]
    q, k, v, do, dlse = (torch.from_numpy(x) for x in _inputs(1, b, t, h, hkv, d))
    qt, kt, vt = (x.clone().requires_grad_() for x in (q, k, v))
    out, lse = flash_attention_with_lse_plain(qt, kt, vt, causal, window, off)
    want = torch.autograd.grad((out, lse), (qt, kt, vt), (do, dlse))
    got = flash_attention_bwd_plain(q, k, v, out.detach(), lse.detach(), do, dlse, causal,
                                    window, off)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5, msg=name)


def test_dkdv_keep_kv_heads_and_sum_the_group():
    """dK/dV at Hkv heads equal the repeat-then-attend gradients summed over
    each group's query heads."""
    b, t, h, hkv, d = 2, 16, 6, 2, 8
    q, k, v, do, _ = (torch.from_numpy(x) for x in _inputs(2, b, t, h, hkv, d))
    kt, vt = (x.clone().requires_grad_() for x in (k, v))
    dk, dv = torch.autograd.grad(flash_attention(q, kt, vt, causal=True), (kt, vt), do)
    assert dk.shape == dv.shape == (b, t, hkv, d)
    kr, vr = (x.repeat_interleave(h // hkv, dim=2).requires_grad_() for x in (k, v))
    dkr, dvr = torch.autograd.grad(flash_attention(q, kr, vr, causal=True), (kr, vr), do)
    torch.testing.assert_close(dk, dkr.reshape(b, t, hkv, h // hkv, d).sum(3), atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(dv, dvr.reshape(b, t, hkv, h // hkv, d).sum(3), atol=1e-5,
                               rtol=1e-5)


def test_split_entry_points_and_the_unused_lse():
    """``flash_attention`` leaves lse without a cotangent (treated as zero),
    so its grads equal the two plain kernels' with delta = sum(do * out);
    the Function with plain versions gives the same."""
    b, t, h, hkv, d = 1, 24, 4, 2, 16
    q, k, v, do, _ = (torch.from_numpy(x) for x in _inputs(3, b, t, h, hkv, d))
    qt, kt, vt = (x.clone().requires_grad_() for x in (q, k, v))
    got = torch.autograd.grad(flash_attention(qt, kt, vt, causal=True, window=7), (qt, kt, vt),
                              do)
    out, lse = flash_attention_with_lse_plain(q, k, v, causal=True, window=7)
    delta = (do * out).sum(-1).permute(0, 2, 1).contiguous()
    dq = flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, True, 7)
    dk, dv = flash_attention_bwd_dkdv_plain(q, k, v, do, lse, delta, True, 7)
    for g, w in zip(got, (dq, dk, dv)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    qt, kt, vt = (x.clone().requires_grad_() for x in (q, k, v))
    again = torch.autograd.grad(flash_attention_fn_plain(qt, kt, vt, True, 7), (qt, kt, vt), do)
    for g, w in zip(again, got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_bf16_plain_backward_keeps_the_input_dtypes():
    q, k, v, do, _ = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(4, 1, 16, 4, 2, 8))
    qt, kt, vt = (x.clone().requires_grad_() for x in (q, k, v))
    grads = torch.autograd.grad(flash_attention(qt, kt, vt, causal=True), (qt, kt, vt), do)
    assert all(g.dtype == torch.bfloat16 for g in grads)
    # the f32 backward of the same bf16 values; bf16 output rounding and the
    # bf16 out stored by the forward: within 2^-6 of the largest value
    want = flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                     *flash_attention_with_lse_plain(q.float(), k.float(),
                                                                     v.float(), causal=True),
                                     do.float(), causal=True)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g.float(), w, atol=2 ** -6 * w.abs().max().item(), rtol=0)


def test_kernel_entry_points_refuse_cpu_tensors():
    q, k, v, do, _ = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(5, 1, 16, 4, 2, 64))
    out, lse = flash_attention_with_lse_plain(q, k, v, causal=True)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    with pytest.raises(ValueError, match="device"):
        flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    with pytest.raises(ValueError, match="device"):
        flash_attention_bwd_dq(q, k, v, do, lse, delta, True)
    with pytest.raises(ValueError, match="device"):
        flash_attention_bwd_dkdv(q, k, v, do, lse, delta, True)
    assert flash_attention_bwd_dq.launches == flash_attention_bwd_dkdv.launches == 0
