"""The port's normalize and loss ops (ddl_tpu_torch/ops/) against the JAX
package: the kernel's plain version bit-equal to the Pallas kernel in
interpret mode, and within one bf16 ulp of the divide path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl_tpu.ops import cross_entropy_loss as jax_cross_entropy_loss
from ddl_tpu.ops import normalize_images as jax_normalize_images
from ddl_tpu.ops import softmax_cross_entropy as jax_softmax_cross_entropy
from ddl_tpu.ops.pallas_image import pallas_normalize_images
from ddl_tpu_torch.ops import (
    cross_entropy_loss,
    normalize,
    normalize_images,
    normalize_plain,
    softmax_cross_entropy,
)

DTYPES = [(torch.float32, jnp.float32, np.int32), (torch.bfloat16, jnp.bfloat16, np.int16)]
# (4,16,16,3): F = 768 columns, one partial Pallas block; (2,40,40,3):
# F = 4800, three full 1536-column blocks and a ragged one.
SHAPES = [(4, 16, 16, 3), (2, 40, 40, 3)]


def _images(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _bits(x, int_dtype):
    """Raw bits of a port tensor or a JAX array, for bit-equality checks."""
    if isinstance(x, torch.Tensor):
        return x.view({np.int16: torch.int16, np.int32: torch.int32}[int_dtype]).numpy()
    return np.asarray(x).view(int_dtype)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_normalize_plain_bit_equal_to_pallas(shape, dtypes):
    tdt, jdt, idt = dtypes
    imgs = _images(shape)
    got = normalize_plain(torch.from_numpy(imgs), tdt)
    want = pallas_normalize_images(jnp.asarray(imgs), jdt, interpret=True)
    np.testing.assert_array_equal(_bits(got, idt), _bits(want, idt))


def test_normalize_plain_within_one_bf16_ulp_of_the_divide():
    """x * bf16(1/255) vs x / 255: at most one bf16 ulp apart (the bits of
    positive floats are monotone, so one ulp is a difference of 1)."""
    imgs = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    got = _bits(normalize_plain(torch.from_numpy(imgs), torch.bfloat16), np.int16)
    want = _bits(jax_normalize_images(jnp.asarray(imgs), jnp.bfloat16), np.int16)
    assert np.abs(got.astype(np.int32) - want).max() <= 1


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_normalize_images_bit_equal_to_jax(dtypes):
    tdt, jdt, idt = dtypes
    imgs = _images((2, 8, 8, 3), seed=1)
    got = normalize_images(torch.from_numpy(imgs), tdt)
    want = jax_normalize_images(jnp.asarray(imgs), jdt)
    np.testing.assert_array_equal(_bits(got, idt), _bits(want, idt))


def test_normalize_wrapper_on_cpu_is_the_plain_version():
    imgs = torch.from_numpy(_images((3, 7, 5, 3), seed=2))
    before = normalize.launches
    torch.testing.assert_close(normalize(imgs), normalize_plain(imgs), rtol=0, atol=0)
    assert normalize.launches == before
    with pytest.raises(TypeError):
        normalize(imgs.float())


@pytest.mark.parametrize("logit_dtype", [torch.float32, torch.bfloat16])
def test_cross_entropy_matches_jax(logit_dtype):
    """Both compute in f32 from the same (possibly bf16) logits: 1e-6."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.normal(size=(32, 5)).astype(np.float32)).to(logit_dtype)
    labels = rng.integers(0, 5, 32)
    jlogits = jnp.asarray(logits.float().numpy()).astype(
        jnp.bfloat16 if logit_dtype == torch.bfloat16 else jnp.float32)
    np.testing.assert_allclose(
        softmax_cross_entropy(logits, torch.from_numpy(labels)).numpy(),
        np.asarray(jax_softmax_cross_entropy(jlogits, jnp.asarray(labels))),
        rtol=1e-6, atol=1e-6,
    )
    assert cross_entropy_loss(logits, torch.from_numpy(labels)).item() == pytest.approx(
        float(jax_cross_entropy_loss(jlogits, jnp.asarray(labels))), rel=1e-6
    )
