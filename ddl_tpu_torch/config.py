"""Configuration for the port (own copy of what it needs from
``ddl_tpu/config.py``).

Same dataclass names, field names and defaults as the JAX package, so a
preset and its overrides mean the same thing in both.  ``ModelConfig`` and
``DataConfig`` are whole copies; ``TrainConfig`` and ``Config`` carry only
what the ported slices read (the optimizer and its schedule, the epoch
count, the seed, the log directory, the NaN halt, the strategy), and the
rest (checkpoints, recovery, preemption, profiling, pipelines) arrive with
the slices that use them.  Strategies other than ``"single"`` are not
ported yet and are refused by ``Config.validate``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, fields
from typing import Any, Tuple

__all__ = [
    "Config",
    "DataConfig",
    "ModelConfig",
    "TrainConfig",
    "apply_overrides",
    "preset",
]

# Strategies the port runs so far ("dp", "pp", "dp_pp" are later slices).
PORTED_STRATEGIES = ("single",)


@dataclass
class ModelConfig:
    """DenseNet family hyperparameters (torchvision densenet121 defaults)."""

    growth_rate: int = 32
    block_config: Tuple[int, ...] = (6, 12, 24, 16)
    num_init_features: int = 64
    bn_size: int = 4
    num_classes: int = 5
    # Dense blocks that BEGIN a new pipeline stage; (2,) is the reference
    # split at features.denseblock3.denselayer1.
    split_blocks: Tuple[int, ...] = (2,)
    # Compute dtype; parameters stay float32.
    compute_dtype: str = "float32"
    # Rematerialise stage activations in the pipeline backward (read by
    # the pipeline slice; carried so configs mean the same in both packages).
    remat: bool = True
    # Normalize the uint8 batch with the CUDA kernel (ops/image_kernel.py)
    # instead of the divide in ops/image.py.  The name is the JAX field's.
    pallas_normalize: bool = False
    # How dense blocks run: "packed" (and "concat"/"buffer", the same math
    # in plain PyTorch here) or "fused" — the whole-block CUDA kernel
    # (ops/fused_dense_block.py) for the blocks in
    # dense_block_fused_blocks, plain PyTorch for the rest.
    dense_block_impl: str = "packed"
    dense_block_fused_blocks: Tuple[int, ...] = (0, 3)
    # Optional torchvision state_dict (.pth) to initialise from; a
    # classifier of another shape (the 1000-class ImageNet head) is skipped.
    pretrained_path: str | None = None


@dataclass
class DataConfig:
    dataset_dir: str = field(default_factory=lambda: os.environ.get("DDL_DATASET_DIR", ""))
    # Without a dataset dir the synthetic APTOS-shaped set is used.
    synthetic_num_train: int = 2930
    synthetic_num_test: int = 732
    image_size: int = 224
    num_classes: int = 5
    global_batch_size: int = 30
    eval_batch_size: int = 30
    shuffle: bool = True
    drop_last: bool = True
    num_workers: int = 2
    train_csv: str = "train.csv"
    test_csv: str = "test.csv"
    train_images: str = "train_images"
    test_images: str = "test_images"
    train_filename_col: str = "new_id_code"
    test_filename_col: str = "id_code"
    label_col: str = "diagnosis"


def _env(name: str, default: str) -> str:
    return os.environ.get(name, default)


@dataclass
class TrainConfig:
    max_epochs: int = 30
    learning_rate: float = 1e-3  # torch.optim.Adam default (reference single.py:305)
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0  # >0 switches to decoupled AdamW
    grad_clip_norm: float = 0.0  # >0 enables global-norm clipping
    # The JAX package's single-pass Adam; the math is the same either way,
    # and the port carries the field so configs mean the same in both.
    fused_adam: bool = True
    lr_schedule: str = "constant"  # "constant" | "cosine"
    warmup_steps: int = 0  # linear 0 -> lr ramp prepended to either schedule
    decay_steps: int = 0  # total steps for cosine (incl. warmup)
    seed: int = 42
    log_dir: str = field(default_factory=lambda: _env("DDL_LOG_DIR", "training_logs"))
    # Halt with a clear diagnostic when the training loss goes non-finite.
    halt_on_nan: bool = True


@dataclass
class Config:
    strategy: str = "single"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def validate(self) -> "Config":
        if self.strategy not in PORTED_STRATEGIES:
            raise ValueError(
                f"strategy {self.strategy!r} is not ported yet "
                f"(ported: {PORTED_STRATEGIES})"
            )
        if self.model.dense_block_impl not in ("concat", "buffer", "packed", "fused"):
            raise ValueError(
                f"dense_block_impl must be 'concat', 'buffer', 'packed' or "
                f"'fused', got {self.model.dense_block_impl!r}"
            )
        return self


def preset(name: str, **overrides: Any) -> Config:
    if name != "single":
        raise ValueError(f"preset {name!r} is not ported yet (ported: 'single')")
    cfg = Config(strategy="single")
    cfg.data.global_batch_size = 30  # reference single.py:286
    apply_overrides(cfg, overrides)
    return cfg.validate()


def _coerce(current: Any, raw: str) -> Any:
    if current is None:
        try:
            return json.loads(raw)
        except json.JSONDecodeError:
            return raw
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, tuple):
        return tuple(json.loads(raw))
    return raw


def apply_overrides(cfg: Config, overrides: dict[str, Any]) -> Config:
    """Dotted-path overrides, e.g. ``{"model.compute_dtype": "bfloat16"}``;
    string values are coerced to the field's current type."""
    for path, value in overrides.items():
        obj = cfg
        *parents, leaf = path.split(".")
        for p in parents:
            obj = getattr(obj, p)
        if not any(f.name == leaf for f in fields(obj)):
            raise KeyError(f"no config field {path!r}")
        current = getattr(obj, leaf)
        if isinstance(value, str) and not isinstance(current, str):
            value = _coerce(current, value)
        setattr(obj, leaf, value)
    return cfg
