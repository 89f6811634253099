"""Configuration for the port (own copy of what it needs from
``ddl_tpu/config.py``).

Same dataclass names, field names and defaults as the JAX package, so a
preset and its overrides mean the same thing in both: ``MeshConfig``,
``ModelConfig``, ``DataConfig``, ``TrainConfig`` and ``Config`` are whole
copies, ``preset`` has the JAX package's four presets, and
``Config.validate`` makes its checks.  Every strategy runs: ``"single"``,
``"dp"`` (``mesh.data`` ranks, one device each), and the pipelines
``"pp"`` and ``"dp_pp"`` (``mesh.data * mesh.pipe`` ranks, one stage
each).  ``num_microbatches``, ``pipeline_schedule`` and ``model.remat``
are read by the pipelines only, and so is ``split_blocks``.
``train.zero_sharding`` shards Adam's moments over the data ranks of
``"dp"`` (``train/fused_optim.py``; a no-op at ``mesh.data`` 1).

``parse_cli`` is the command line's half (``--preset``, ``--set
PATH=VALUE ...``, ``--print-config``), with ``--device`` beside the JAX
package's ``--cpu-devices``: it returns ``(cfg, device)``, the device
being ``None`` (CUDA, ``cuda:<local rank>`` in a world of several ranks)
unless the caller asks for another; ``--cpu-devices N`` means the CPU,
with N devices for the command line's ranks (``launch.check_local_world``).
"""

from __future__ import annotations

import argparse
import json
import os
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Tuple

__all__ = [
    "Config",
    "DataConfig",
    "MeshConfig",
    "ModelConfig",
    "TrainConfig",
    "apply_overrides",
    "parse_cli",
    "preset",
    "to_dict",
]

@dataclass
class MeshConfig:
    """Logical device mesh: ``(data, pipe)`` axes (reference ddp_n_pp.py:32-33)."""

    data: int = 1
    pipe: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.pipe


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
    # the pipelines only).
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
    # The JAX package's single-pass Adam; the math is the same either way.
    # Only plain Adam configs fuse (train/state.Optimizer.fused), and ZeRO
    # requires it.
    fused_adam: bool = True
    # ZeRO-1 optimizer-state sharding over 'data' (train/fused_optim.py).
    zero_sharding: bool = False
    lr_schedule: str = "constant"  # "constant" | "cosine"
    warmup_steps: int = 0  # linear 0 -> lr ramp prepended to either schedule
    decay_steps: int = 0  # total steps for cosine (incl. warmup)
    num_microbatches: int = 5  # reference pp.py:378
    # "gpipe" (reference ScheduleGPipe semantics, pp.py:140) or "1f1b"
    pipeline_schedule: str = "gpipe"
    seed: int = 42
    log_dir: str = field(default_factory=lambda: _env("DDL_LOG_DIR", "training_logs"))
    checkpoint_dir: str = field(default_factory=lambda: _env("DDL_CHECKPOINT_DIR", "checkpoints"))
    # Resume: load the snapshot at <checkpoint_dir>/<job_id>/epoch_<n>
    # (reference single.py:116, ddp.py:129-133).
    snapshot_job_id: str | None = None
    snapshot_epoch: int | None = None
    # Without a snapshot_job_id, resume from the latest valid snapshot of
    # THIS job id if there is one, so a relaunch with the same job id
    # continues with no extra flags.
    auto_resume: bool = True
    # Save a snapshot when validation QWK improves (reference ddp.py:292-295).
    save_best_qwk: bool = True
    # Commit snapshots on a background thread (training continues).
    async_checkpoint: bool = True
    # Snapshot GC: keep the newest K *valid* snapshots after each save
    # (checkpoint.gc_snapshots); 0 keeps everything.
    keep_snapshots: int = 0
    # Halt with a clear diagnostic when the training loss goes non-finite.
    halt_on_nan: bool = True
    # "halt" (above) or "recover": skip a non-finite epoch, and after
    # nan_max_consecutive of them roll back to the latest valid snapshot
    # with updates scaled by nan_grace_scale for nan_grace_periods epochs
    # (train/recovery.RecoveryPolicy).
    nan_policy: str = "halt"
    nan_max_consecutive: int = 3
    nan_grace_scale: float = 0.1
    nan_grace_periods: int = 2
    # Catch SIGTERM/SIGINT, finish the in-flight step, snapshot, exit.
    preemption_save: bool = True
    # Per-parameter |grad| statistics into gradient.csv every step.
    log_gradient_stats: bool = False
    # Trace one post-warm-up epoch with torch.profiler into this directory.
    profile_dir: str | None = None


@dataclass
class Config:
    strategy: str = "single"
    mesh: MeshConfig = field(default_factory=MeshConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def validate(self) -> "Config":
        if self.strategy not in ("single", "dp", "pp", "dp_pp"):
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.train.nan_policy not in ("halt", "recover"):
            raise ValueError(
                f"unknown nan_policy {self.train.nan_policy!r} "
                "(want 'halt' or 'recover')"
            )
        if self.train.zero_sharding and self.strategy in ("pp", "dp_pp"):
            raise ValueError(
                "zero_sharding shards the optimizer update over 'data' "
                "inside the flat DP step; the pipeline schedules apply "
                "their optimizer inside a manual shard_map region where "
                "sharding constraints cannot be planted — use strategy "
                "'single'/'dp'"
            )
        if self.train.zero_sharding and (
            not self.train.fused_adam
            or self.train.weight_decay > 0.0
            or self.train.grad_clip_norm > 0.0
        ):
            # weight decay / clipping leave the plain Adam even with
            # fused_adam=true: catch the whole class here, not deep inside
            # with_zero (and not only at dp>1)
            raise ValueError(
                "zero_sharding requires the fused Adam path: "
                "fused_adam=true and weight_decay=0 and grad_clip_norm=0 "
                "(the sharded update is planted inside train/fused_optim's "
                "per-leaf expression; optax chains cannot be ZeRO-sharded)"
            )
        if self.strategy == "single" and self.mesh.num_devices != 1:
            raise ValueError("strategy 'single' requires a (1,1) mesh")
        if self.strategy == "dp" and self.mesh.pipe != 1:
            raise ValueError("strategy 'dp' requires pipe=1")
        if self.strategy == "pp" and self.mesh.data != 1:
            raise ValueError("strategy 'pp' requires data=1")
        if self.strategy in ("pp", "dp_pp"):
            n_stages = len(self.model.split_blocks) + 1
            if self.mesh.pipe != n_stages:
                raise ValueError(
                    f"mesh.pipe={self.mesh.pipe} must equal number of stages "
                    f"{n_stages} (split_blocks={self.model.split_blocks})"
                )
        if self.data.global_batch_size % self.mesh.data != 0:
            raise ValueError("global_batch_size must divide by mesh.data")
        local = self.data.global_batch_size // self.mesh.data
        if self.strategy in ("pp", "dp_pp") and local % self.train.num_microbatches != 0:
            raise ValueError(
                f"per-replica batch {local} must divide by "
                f"num_microbatches={self.train.num_microbatches}"
            )
        if self.model.dense_block_impl not in ("concat", "buffer", "packed", "fused"):
            raise ValueError(
                f"dense_block_impl must be 'concat', 'buffer', 'packed' or "
                f"'fused', got {self.model.dense_block_impl!r}"
            )
        return self


def preset(name: str, **overrides: Any) -> Config:
    if name == "single":
        cfg = Config(strategy="single", mesh=MeshConfig(1, 1))
        cfg.data.global_batch_size = 30  # reference single.py:286
    elif name == "dp":
        cfg = Config(strategy="dp", mesh=MeshConfig(2, 1))
        # reference ddp.py:335 uses per-rank batch 15 -> global 15*D
        cfg.data.global_batch_size = 15 * cfg.mesh.data
    elif name == "pp":
        cfg = Config(strategy="pp", mesh=MeshConfig(1, 2))
        cfg.data.global_batch_size = 30  # reference pp.py:365
    elif name == "dp_pp":
        # (3,2) mesh, per-data-row batch 10 (reference ddp_n_pp.py:33,371)
        cfg = Config(strategy="dp_pp", mesh=MeshConfig(3, 2))
        cfg.data.global_batch_size = 10 * cfg.mesh.data
    else:
        raise ValueError(f"unknown preset {name!r}")
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


def to_dict(cfg: Any) -> Any:
    if is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in fields(cfg)}
    if isinstance(cfg, tuple):
        return list(cfg)
    return cfg


def parse_cli(argv: list[str] | None = None) -> tuple[Config, str | None]:
    """``(cfg, device)`` from the command line.  ``--device`` names the
    torch device (default ``None``: CUDA); the JAX package's ``--cpu-devices
    N`` means ``--device cpu``, with N CPU devices for the ranks of a
    world of ``mesh.data * mesh.pipe`` ranks (gloo), which the command
    line starts."""
    parser = argparse.ArgumentParser(
        description="distributed training on GPUs (ddl_tpu_torch)",
    )
    parser.add_argument(
        "--preset",
        default="single",
        choices=["single", "dp", "pp", "dp_pp"],
        help="strategy preset mirroring the reference entry points",
    )
    parser.add_argument(
        "--set",
        nargs="*",
        default=[],
        metavar="PATH=VALUE",
        help="dotted config overrides, e.g. train.max_epochs=3 data.dataset_dir=/data",
    )
    parser.add_argument("--print-config", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; 'cpu' runs on the CPU)")
    parser.add_argument("--cpu-devices", type=int, default=0,
                        help="the JAX command line's flag: run on N CPU devices "
                             "(--device cpu; one gloo rank each under --preset dp, pp "
                             "and dp_pp)")
    args = parser.parse_args(argv)
    device = args.device
    if args.cpu_devices >= 1:
        device = "cpu"
    overrides = {}
    for item in args.set:
        path, _, value = item.partition("=")
        overrides[path] = value
    cfg = preset(args.preset, **overrides)
    if args.print_config:
        print(json.dumps(to_dict(cfg), indent=2))
    return cfg, device
