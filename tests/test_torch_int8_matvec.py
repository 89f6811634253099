"""The port's int8 small-M matmul (ddl_tpu_torch/ops/int8_matvec.py) against
the JAX package's Pallas kernel in interpret mode on the same inputs: both
weight layouts, M in {1, 3, 8}, f32 and bf16 activations, an O that is not a
multiple of 128, and the M > 8 refusal.  On a CPU tensor the wrapper runs
the plain version and counts no launch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl_tpu.ops import int8_matvec as jm
from ddl_tpu_torch.ops.int8_matvec import (
    MATVEC_MAX_ROWS,
    int8_matmul_small_m,
    int8_matmul_small_m_plain,
)

D = 64


def inputs(m, o, contract_last, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, D)).astype(np.float32)
    w8 = rng.integers(-127, 128, (o, D) if contract_last else (D, o)).astype(np.int8)
    scale = (rng.random((1, o)) * 0.01).astype(np.float32)
    return x, w8, scale


def jax_kernel(x, w8, scale, contract_last, dtype):
    got = jm.int8_matmul_small_m(jnp.asarray(x, dtype), jnp.asarray(w8), jnp.asarray(scale),
                                 contract_last=contract_last, block_o=128, interpret=True)
    return np.asarray(got.astype(jnp.float32))


@pytest.mark.parametrize("o", [384, 200], ids=["o384", "ragged_o200"])
@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("contract_last", [False, True], ids=["DxO", "OxD"])
def test_f32_matches_the_jax_kernel(m, o, contract_last):
    """f32 in, f32 out: the same f32 products summed in another order
    (1e-5 relative to each row's largest value)."""
    x, w8, scale = inputs(m, o, contract_last)
    want = jax_kernel(x, w8, scale, contract_last, jnp.float32)
    counts = int8_matmul_small_m.launches
    got = int8_matmul_small_m(torch.from_numpy(x), torch.from_numpy(w8), torch.from_numpy(scale),
                              contract_last=contract_last)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, o)
    assert int8_matmul_small_m.launches == counts
    row_max = np.abs(want).max(-1, keepdims=True)
    assert (np.abs(got.numpy() - want) <= 1e-5 * row_max).all()


@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("contract_last", [False, True], ids=["DxO", "OxD"])
def test_bf16_matches_the_jax_kernel(m, contract_last):
    """bf16 in, bf16 out: both sum exact f32 products in f32 and round once,
    so another summation order flips at most one bf16 rounding: within one
    bf16 ulp (2^-7 relative) of each row's largest value."""
    x, w8, scale = inputs(m, 384, contract_last, seed=1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = jax_kernel(xb.float().numpy(), w8, scale, contract_last, jnp.bfloat16)
    got = int8_matmul_small_m(xb, torch.from_numpy(w8), torch.from_numpy(scale),
                              contract_last=contract_last)
    assert got.dtype == torch.bfloat16
    row_max = np.abs(want).max(-1, keepdims=True)
    assert (np.abs(got.float().numpy() - want) <= 2.0 ** -7 * row_max).all()


def test_scale_of_any_shape_and_plain_equals_wrapper_on_cpu():
    x, w8, scale = inputs(3, 128, False, seed=2)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w8)
    flat = int8_matmul_small_m(xt, wt, torch.from_numpy(scale.reshape(-1)))
    torch.testing.assert_close(flat, int8_matmul_small_m_plain(xt, wt, torch.from_numpy(scale)),
                               rtol=0, atol=0)


@pytest.mark.parametrize("fn", [int8_matmul_small_m, int8_matmul_small_m_plain],
                         ids=["wrapper", "plain"])
def test_rejects_more_than_eight_rows_and_bad_shapes(fn):
    x = torch.zeros(MATVEC_MAX_ROWS + 1, 16)
    w8 = torch.zeros(16, 32, dtype=torch.int8)
    with pytest.raises(ValueError, match="use the large-M product"):
        fn(x, w8, torch.ones(1, 32))
    with pytest.raises(ValueError, match="is not"):
        fn(x[:2], w8.t().contiguous(), torch.ones(1, 32))
    with pytest.raises(ValueError, match="scale has"):
        fn(x[:2], w8, torch.ones(1, 31))
