"""The port's decode attention and int8 KV cache (ddl_tpu_torch/ops/
decode_attention.py, ops/quant.py) against the JAX package: the Pallas
decode kernels in interpret mode (with small ``block_l`` so the online
softmax runs over several L tiles), shared and per-lane bias, a fully
masked tile; ``quantize_q8`` bit-equal; the in-place cache writes,
slices and ``kv_attend`` against the JAX functions' results.  f32 to
1e-5.  On the CPU the port runs the kernels' plain versions; the CUDA
kernels are held to them by chip_smoke.py on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl_tpu.ops import quant as jq
from ddl_tpu.ops.decode_attention import decode_attention as jax_decode_attention
from ddl_tpu.ops.decode_attention import quant_decode_attention as jax_quant_decode_attention
from ddl_tpu_torch.ops import quant as tq
from ddl_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_plain,
    quant_decode_attention,
)

B, L, H, HKV, D = 3, 16, 6, 2, 8


def _inputs(seed, bias_kind):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, L, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, L, HKV, D)).astype(np.float32)
    rows = 1 if bias_kind == "shared" else B
    mask = rng.random((rows, L)) > 0.3
    mask[:, -1] = True
    if bias_kind == "masked-tile":
        mask[:, :4] = False  # with block_l=4 the first tile sees no key
    if bias_kind == "per-lane":
        mask[1] = False  # a lane that sees nothing: output 0
    bias = np.where(mask, 0.0, -1e30).astype(np.float32)
    return q, k, v, bias


def _t(a):
    return torch.from_numpy(np.array(a))


BIASES = ["shared", "per-lane", "masked-tile"]


@pytest.mark.parametrize("block_l", [None, 4], ids=["one-tile", "4-tiles"])
@pytest.mark.parametrize("bias_kind", BIASES)
def test_decode_attention_matches_jax_kernel(bias_kind, block_l):
    q, k, v, bias = _inputs(0, bias_kind)
    ck, cv = k.reshape(B, L, HKV * D), v.reshape(B, L, HKV * D)
    want = jax_decode_attention(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                                jnp.asarray(bias), hkv=HKV, block_l=block_l, interpret=True)
    got = decode_attention(_t(q), _t(ck), _t(cv), _t(bias), hkv=HKV)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("block_l", [None, 4], ids=["one-tile", "4-tiles"])
@pytest.mark.parametrize("bias_kind", BIASES)
def test_quant_decode_attention_matches_jax_kernel(bias_kind, block_l):
    q, k, v, bias = _inputs(1, bias_kind)
    kq, ks = jq.quantize_q8(jnp.asarray(k))
    vq, vs = jq.quantize_q8(jnp.asarray(v))
    args = (kq.reshape(B, L, -1), ks[..., 0].transpose(0, 2, 1), vq.reshape(B, L, -1),
            vs[..., 0].transpose(0, 2, 1))
    want = jax_quant_decode_attention(jnp.asarray(q), args[0], args[1], args[2], args[3],
                                      jnp.asarray(bias), hkv=HKV, block_l=block_l,
                                      interpret=True)
    got = quant_decode_attention(_t(q), *(_t(np.asarray(a)) for a in args), _t(bias), hkv=HKV)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, L), (1, L + 1), (L,)], ids=["batch", "length", "1-d"])
def test_decode_attention_rejects_other_bias_shapes(shape):
    q, k, v, _ = _inputs(2, "shared")
    ck, cv = _t(k.reshape(B, L, -1)), _t(v.reshape(B, L, -1))
    with pytest.raises(ValueError, match="bias"):
        decode_attention_plain(_t(q), ck, cv, torch.zeros(shape), hkv=HKV)


def test_quantize_q8_bit_equal_including_ties():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 5, 3, 16)).astype(np.float32) * 3
    # amax 127 makes the scale exactly 1: 2.5 -> 2, -3.5 -> -4, 0.5 -> 0
    x[0, 0, 0, :5] = [127.0, 2.5, -3.5, 0.5, 1.5]
    x[1, 1, 1] = 0.0  # an all-zero row: the 1e-12 floor
    for axis in (-1, 1):
        jqv, jsv = jq.quantize_q8(jnp.asarray(x), axis=axis)
        qv, sv = tq.quantize_q8(_t(x), axis=axis)
        np.testing.assert_array_equal(qv.numpy(), np.asarray(jqv))
        np.testing.assert_array_equal(sv.numpy(), np.asarray(jsv))
    assert qv.dtype == torch.int8
    np.testing.assert_array_equal(tq.quantize_q8(_t(x))[0][0, 0, 0, :5].numpy(), [127, 2, -4, 0, 2])
    np.testing.assert_array_equal(tq.dequantize_q8(qv, sv).numpy(),
                                  np.asarray(jq.dequantize_q8(jqv, jsv)))


def _caches(quant, seed=4, b=2, length=10, hkv=2, d=8):
    rng = np.random.default_rng(seed)
    k0 = rng.standard_normal((b, length, hkv, d)).astype(np.float32)
    v0 = rng.standard_normal((b, length, hkv, d)).astype(np.float32)
    if quant:
        (kq, ks), (vq, vs) = tq.quantize_q8(_t(k0)), tq.quantize_q8(_t(v0))
        port = tq.QuantKV(tq.kv_fuse(kq), ks[..., 0].transpose(1, 2).contiguous(),
                          tq.kv_fuse(vq), vs[..., 0].transpose(1, 2).contiguous())
        jax_cache = jq.QuantKV(*(jnp.asarray(a.numpy()) for a in port))
    else:
        port = (tq.kv_fuse(_t(k0)), tq.kv_fuse(_t(v0)))
        jax_cache = tuple(jnp.asarray(a.numpy()) for a in port)
    return port, jax_cache


def _assert_same(port, jax_cache):
    for a, b in zip(port, jax_cache):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("quant", [False, True], ids=["bf16-layout", "int8"])
def test_kv_write_set_slots_slice_match_jax(quant):
    rng = np.random.default_rng(5)
    port, jax_cache = _caches(quant)
    k = rng.standard_normal((2, 3, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 3, 2, 8)).astype(np.float32)
    # kv_write at an offset, in place: the same tensors come back
    got = tq.kv_write(port, _t(k), _t(v), 4)
    assert all(a is b for a, b in zip(got, port))
    jax_cache = jq.kv_write(jax_cache, jnp.asarray(k), jnp.asarray(v), 4)
    _assert_same(port, jax_cache)
    # ring slots that wrap around
    slots = np.array([8, 9, 0])
    tq.kv_set_slots(port, _t(k), _t(v), torch.from_numpy(slots))
    jax_cache = jq.kv_set_slots(jax_cache, jnp.asarray(k), jnp.asarray(v), jnp.asarray(slots))
    _assert_same(port, jax_cache)
    _assert_same(tq.kv_slice(port, 3, 5), jq.kv_slice(jax_cache, 3, 5))
    copy = tq.kv_map(torch.clone, port)
    assert type(copy) is type(port) and all(a is not b for a, b in zip(copy, port))
    _assert_same(copy, jax_cache)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16-layout", "int8"])
@pytest.mark.parametrize("tq_len, use_kernel, per_row", [
    (1, True, False), (1, True, True), (1, False, False), (3, False, True),
], ids=["decode-kernel", "decode-kernel-per-row", "t1-dense", "t3-dense-per-row"])
def test_kv_attend_matches_jax(quant, tq_len, use_kernel, per_row):
    rng = np.random.default_rng(6)
    port, jax_cache = _caches(quant)
    q = rng.standard_normal((2, tq_len, 4, 8)).astype(np.float32)
    shape = (2, tq_len, 10) if per_row else (tq_len, 10)
    mask = rng.random(shape) > 0.3
    mask[..., 0] = True
    want = jq.kv_attend(jnp.asarray(q), jax_cache, jnp.asarray(mask), use_kernel=use_kernel)
    got = tq.kv_attend(_t(q), port, _t(mask), use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_kv_decode_plain_is_the_cpu_path_of_kv_decode():
    port, _ = _caches(True)
    q = torch.randn(2, 1, 4, 8)
    bias = torch.zeros(1, 10)
    torch.testing.assert_close(tq.kv_decode(q, port, bias), tq.kv_decode_plain(q, port, bias),
                               rtol=0, atol=0)


def test_quant_dense_attention_matches_jax():
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
    kq = rng.integers(-127, 128, (2, 10, 2, 8)).astype(np.int8)
    vq = rng.integers(-127, 128, (2, 10, 2, 8)).astype(np.int8)
    ks = rng.random((2, 2, 10)).astype(np.float32) * 0.05
    vs = rng.random((2, 2, 10)).astype(np.float32) * 0.05
    mask = rng.random((2, 3, 10)) > 0.3
    mask[..., 0] = True
    want = jq.quant_dense_attention(*(jnp.asarray(a) for a in (q, kq, ks, vq, vs, mask)))
    got = tq.quant_dense_attention(*(_t(a) for a in (q, kq, ks, vq, vs)), mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
