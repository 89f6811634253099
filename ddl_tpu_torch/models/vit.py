"""Vision Transformer (counterpart of ``ddl_tpu/models/vit.py``).

The LM's ``Block`` (``models/transformer.py``) run bidirectionally
(``LMConfig.causal=False``: the dense attention core without its mask)
over a patch sequence, with a learned positional embedding and a
mean-pool classifier head.  It trains on the DenseNet's data path
(224x224x3 uint8 in, 5 APTOS grades out): ``examples/train_vit.py``.

Parameter names and layouts follow the Flax tree as the LM's do
(``block{i}.*`` as in ``TransformerLM``, ``norm_f.scale``, ``pos_embed``
(1, N, d), ``head.kernel`` (d, classes) and ``head.bias``), except the
patchify convolution, a ``torch.nn.Conv2d`` (``patch_embed.weight`` OIHW,
``patch_embed.bias``): ``models/convert.vit_params_from_jax`` transposes
the JAX kernel (HWIO over NHWC images).  The convolution is a plain
PyTorch op, as the JAX package computes it outside any Pallas kernel; its
patch order is row-major over the patch grid, the JAX output's reshape.

Tensor parallelism (``tp``, a ``models.transformer.ModelShard``): the
blocks are the LM's tensor-parallel ``Block``s; the patch and position
embeddings, ``norm_f`` and the head replicate, as ``parallel/rules.
vit_rules`` places them (``models/convert.shard_vit_state`` cuts a
one-device state into a rank's part).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ddl_tpu_torch.models.transformer import (
    Block,
    LMConfig,
    RMSNorm,
    _lecun_normal_,
    fold_seed,
    init_lm_weights,
    remat_block,
)

__all__ = ["ViT", "ViTConfig", "ViTHead", "init_vit_weights", "make_patch_embed",
           "make_vit_head", "patchify"]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """The JAX ``ViTConfig``'s fields and defaults (ViT-S/16 at 224px):
    ``fsdp`` above one data rank is refused by the step factory (ROADMAP
    item 11b, FSDP), as the LM's."""

    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 5  # APTOS diabetic-retinopathy grades
    d_model: int = 384
    n_layers: int = 12
    n_heads: int = 6
    # grouped-query attention (0 = multi-head); see LMConfig.n_kv_heads
    n_kv_heads: int = 0
    head_dim: int = 64
    d_ff: int = 1536
    compute_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"  # see LMConfig.remat_policy
    fsdp: bool = False
    dropout_rate: float = 0.0  # residual dropout inside the blocks

    @property
    def num_patches(self) -> int:
        if self.image_size % self.patch_size:
            raise ValueError(
                f"image_size {self.image_size} % patch_size {self.patch_size} != 0"
            )
        return (self.image_size // self.patch_size) ** 2

    def block_config(self) -> LMConfig:
        """The encoder blocks, expressed as a bidirectional LMConfig so the
        LM's Block machinery is reused unchanged."""
        return LMConfig(
            vocab_size=1,  # unused (no token embedding)
            d_model=self.d_model,
            n_layers=self.n_layers,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            head_dim=self.head_dim,
            d_ff=self.d_ff,
            compute_dtype=self.compute_dtype,
            remat=self.remat,
            remat_policy=self.remat_policy,
            fsdp=self.fsdp,
            causal=False,
            dropout_rate=self.dropout_rate,
        )

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def make_patch_embed(cfg: ViTConfig) -> nn.Conv2d:
    """The patchify conv ('patch_embed'): stride = kernel = patch, f32
    master weight and bias, applied in the compute dtype (``patchify``).
    One construction shared by ``ViT`` and the pipeline's first stage."""
    return nn.Conv2d(3, cfg.d_model, cfg.patch_size, stride=cfg.patch_size)


def patchify(conv: nn.Conv2d, images: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, W, 3) float images -> (B, N, d) patch embeddings in ``dtype``,
    patches in row-major grid order (the JAX conv's NHWC output reshaped)."""
    x = images.to(dtype).permute(0, 3, 1, 2)
    y = F.conv2d(x, conv.weight.to(dtype), conv.bias.to(dtype), stride=conv.stride)
    return y.flatten(2).transpose(1, 2)


class ViTHead(nn.Module):
    """The classifier head ('head'): an f32 (d, classes) ``kernel`` and
    ``bias``, so the loss-side softmax is f32."""

    def __init__(self, d_model: int, num_classes: int) -> None:
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(d_model, num_classes))
        self.bias = nn.Parameter(torch.zeros(num_classes))

    def forward(self, x):
        return x.float() @ self.kernel + self.bias


def make_vit_head(cfg: ViTConfig) -> ViTHead:
    """The f32 head, shared by ``ViT`` and the pipeline's last stage."""
    return ViTHead(cfg.d_model, cfg.num_classes)


class ViT(nn.Module):
    """images (B, H, W, 3) float -> logits (B, num_classes) f32.

    ``ViT(cfg, stage=s, stages=P, virtual=V)`` is rank ``s``'s part of the
    pipelined model (``parallel/lm_pipeline.layer_chunks``): the patch and
    positional embeddings on stage 0, the blocks of its chunks under their
    global names, ``norm_f`` and the head on stage P-1; its ``state_dict``
    is the whole model's restricted to them.  ``tp`` makes the blocks this
    rank's tensor-parallel part."""

    def __init__(self, cfg: ViTConfig, stage: int | None = None, stages: int = 1,
                 virtual: int = 1, tp=None) -> None:
        super().__init__()
        self.cfg = cfg
        bc = cfg.block_config()
        if stage is None:
            self.layers = list(range(cfg.n_layers))
        else:
            from ddl_tpu_torch.parallel.lm_pipeline import layer_chunks

            self.layers = sum(layer_chunks(cfg.n_layers, stages, virtual)[stage], [])
        if stage in (None, 0):
            self.patch_embed = make_patch_embed(cfg)
            self.pos_embed = nn.Parameter(torch.empty(1, cfg.num_patches, cfg.d_model))
        for i in self.layers:
            self.add_module(f"block{i}", Block(bc, tp=tp))
        if stage in (None, stages - 1):
            self.norm_f = RMSNorm(cfg.d_model, cfg.dtype)
            self.head = make_vit_head(cfg)

    def blocks(self):
        return [getattr(self, f"block{i}") for i in self.layers]

    def embed(self, images):
        """Patch embedding plus the positional embedding, in the compute
        dtype: the pipeline's first-stage prologue."""
        x = patchify(self.patch_embed, images, self.cfg.dtype)
        return x + self.pos_embed.to(self.cfg.dtype)

    def pool_logits(self, x):
        """``norm_f``, the mean over patches and the f32 head: the
        pipeline's last-stage epilogue."""
        return self.head(self.norm_f(x).mean(dim=1).float())

    def forward(self, images, deterministic: bool = True,
                rngs: Optional[Mapping[str, int]] = None):
        """``deterministic=False`` with ``rngs={"dropout": key}``
        (``train.lm_steps.dropout_kwargs``) trains with dropout, block i's
        masks seeded by ``fold_seed(key, i)``, as ``TransformerLM``'s."""
        x = self.embed(images)
        run = remat_block(self.cfg.block_config())
        key = None if rngs is None else rngs.get("dropout")
        for i, block in enumerate(self.blocks()):
            seed = None if key is None else fold_seed(key, i)
            x, _aux = run(block, x, None, None, False, deterministic, seed)
        return self.pool_logits(x)


def init_vit_weights(model: nn.Module, seed: int) -> None:
    """The Flax initialisers' distributions from a ``torch.Generator``
    seeded with ``seed`` (``init_lm_weights`` for the blocks and norms):
    the patch kernel ``lecun_normal`` over its fan-in (patch² × 3), the
    head's over d_model, the biases zeros, ``pos_embed`` ``normal(0.02)``."""
    init_lm_weights(model, seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                _lecun_normal_(m.weight, m.weight[0].numel(), g)
                nn.init.zeros_(m.bias)
            elif isinstance(m, ViTHead):
                _lecun_normal_(m.kernel, m.kernel.shape[0], g)
                nn.init.zeros_(m.bias)
        for name, p in model.named_parameters():
            if name == "pos_embed":
                nn.init.normal_(p, 0.0, 0.02, generator=g)
