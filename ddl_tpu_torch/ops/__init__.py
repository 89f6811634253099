from ddl_tpu_torch.ops.fused_dense_block import (
    fused_dense_block,
    fused_dense_block_bwd,
    fused_dense_block_bwd_plain,
    fused_dense_block_fn,
    fused_dense_block_fn_plain,
    fused_dense_block_plain,
)
from ddl_tpu_torch.ops.image import normalize_images
from ddl_tpu_torch.ops.image_kernel import normalize, normalize_plain
from ddl_tpu_torch.ops.losses import cross_entropy_loss, softmax_cross_entropy


def get_normalizer(use_kernel: bool = False):
    """The image-normalize implementation: the divide in ``ops/image.py``,
    or the CUDA kernel (``ops/image_kernel.normalize``) when
    ``ModelConfig.pallas_normalize`` asks for the kernel."""
    return normalize if use_kernel else normalize_images


__all__ = [
    "cross_entropy_loss",
    "fused_dense_block",
    "fused_dense_block_bwd",
    "fused_dense_block_bwd_plain",
    "fused_dense_block_fn",
    "fused_dense_block_fn_plain",
    "fused_dense_block_plain",
    "get_normalizer",
    "normalize",
    "normalize_images",
    "normalize_plain",
    "softmax_cross_entropy",
]
