"""The port's flash-attention backward (ddl_tpu_torch/ops/flash_attention.py,
``FlashAttentionFn``) against the JAX package's ``_dq_kernel`` and
``_dkdv_kernel`` (Pallas in interpret mode, small blocks so every sum runs
over several tiles): dq, dk and dv in f32 to 1e-5 for the forward's seven
cases, with both the out and the lse cotangents live.  On the CPU the port
runs ``flash_attention_bwd_plain``; the CUDA kernels are held to it by
chip_smoke.py on the card.  Also pinned: the plain backward equals autograd
through the plain forward, dK/dV stay at Hkv heads, an unused output gets
no cotangent, a broadcast cotangent gives JAX's gradients, the kernels'
tensor maps are handed no zero stride, and the kernel entry points refuse
a CPU tensor."""

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
from ddl_tpu_torch.ops.flash_attention import _kernel_readable

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


def _fused_views():
    """q, k and v as strided views of one (B, T, (H + 2 Hkv) * D) buffer."""
    buf = torch.zeros(2, 16, (4 + 2 * 2) * 64, dtype=torch.bfloat16)
    return (buf[..., :256].unflatten(-1, (4, 64)), buf[..., 256:384].unflatten(-1, (2, 64)),
            buf[..., 384:].unflatten(-1, (2, 64)))


_BASE = torch.zeros(2, 16, 4, 64, dtype=torch.bfloat16)
READABLE = {
    "contiguous": (lambda: _BASE, True),
    "batch-expanded (stride 0)": (lambda: _BASE[:1].expand(3, 16, 4, 64), False),
    "head-expanded (stride 0)": (lambda: _BASE[:, :, :1].expand(2, 16, 4, 64), False),
    "time-expanded (stride 0)": (lambda: _BASE[:, :1].expand(2, 16, 4, 64), False),
    "size-1 batch, odd stride": (
        lambda: torch.as_strided(_BASE, (1, 16, 4, 64), (3, 256, 64, 1)), True),
    "size-1 head, stride 0": (
        lambda: torch.as_strided(_BASE, (2, 16, 1, 64), (4096, 256, 0, 1)), True),
    "fused q view": (lambda: _fused_views()[0], True),
    "fused k view": (lambda: _fused_views()[1], True),
    "fused v view": (lambda: _fused_views()[2], True),
    "non-contiguous last axis": (lambda: _BASE.transpose(2, 3), False),
}


@pytest.mark.parametrize("case", READABLE)
def test_kernel_readable_refuses_zero_strides(case):
    """A zero stride on an axis longer than 1 (an expanded tensor) is not
    handed to the kernels' tensor maps, which step by a positive multiple
    of 16 bytes; a size-1 axis takes any stride; strided views of one fused
    buffer are read in place."""
    make, readable = READABLE[case]
    assert _kernel_readable(make()) is readable


@pytest.mark.parametrize("axis", ["batch", "head"])
def test_broadcast_cotangent_matches_jax(axis):
    """A cotangent broadcast over the batch or the heads (a stride-0 view,
    as the gradient of a sum leaves it) gives the JAX kernels' gradients
    through ``FlashAttentionFn``'s plain path."""
    b, t, h, hkv, d, causal, window, off = CASES["gqa-causal"]
    b = 2
    q, k, v, do, _ = _inputs(6, b, t, h, hkv, d)
    do = do[:1] if axis == "batch" else do[:, :, :1]
    full = np.broadcast_to(do, (b, t, h, d))
    _, vjp = jax.vjp(
        lambda q_, k_, v_: jax_flash_with_lse(q_, k_, v_, causal=causal, window=window,
                                              kv_offset=off, block_q=8, block_k=8,
                                              interpret=True)[0],
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(full))
    do_t = torch.from_numpy(np.ascontiguousarray(do)).expand(b, t, h, d)
    assert 0 in do_t.stride()[:3] and not _kernel_readable(do_t)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = torch.autograd.grad(flash_attention(qt, kt, vt, causal, window, off), (qt, kt, vt),
                              do_t)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
