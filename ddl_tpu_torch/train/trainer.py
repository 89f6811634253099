"""The CNN trainer (counterpart of ``ddl_tpu/train/trainer.py``): the
model, the optimizer, the data loaders, ``run_period`` and ``evaluate``,
on the period loop of ``train/loop.BaseTrainer``.

``Trainer(cfg).train(max_periods)`` trains: per epoch, the shuffled
drop-last train loader -> uint8 batch on the device -> normalize ->
DenseNet with batch statistics -> softmax cross-entropy -> backward ->
Adam, then the eval pass and the CSV rows.  Losses and predictions stay on
the device during the epoch and are fetched to the host once at its end.

``Trainer(cfg).evaluate(epoch)`` is the eval path: uint8 batch ->
normalize -> DenseNet in eval mode -> logits -> the masked metric suite
(val_loss, accuracy, QWK, F1, ...).  Eval is deterministic and
full-coverage: an ordered sampler with no dropped tail, the last batch
padded to full size with label -1 rows that the metrics mask out, so every
test sample counts exactly once.

Checkpoints and resume, recovery, preemption and obs are the next slice of
the port and are not here.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ddl_tpu_torch.config import Config
from ddl_tpu_torch.data import DataLoader, ShardedEpochSampler, build_datasets, to_device
from ddl_tpu_torch.models import DenseNet, init_weights
from ddl_tpu_torch.ops import get_normalizer
from ddl_tpu_torch.train.loop import BaseTrainer
from ddl_tpu_torch.train.state import make_optimizer
from ddl_tpu_torch.train.steps import make_eval_step, make_train_step
from ddl_tpu_torch.utils import MetricLogger, masked_classification_eval

__all__ = ["Trainer", "resolve_device", "resolve_job_id"]


def resolve_job_id() -> str:
    """Job identity from the launcher's environment (``DDL_JOB_ID``, then
    ``TORCHX_JOB_ID``, else ``"local"``); the last path segment."""
    raw = os.environ.get("DDL_JOB_ID") or os.environ.get("TORCHX_JOB_ID") or "local"
    return raw.split("/")[-1]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without CUDA raises (the
    port never drops to the CPU unless the caller asks for it)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


def load_pretrained(model: DenseNet, path: str) -> list[str]:
    """Overlay a torchvision DenseNet ``state_dict`` (.pth) onto ``model``;
    returns the keys left at their fresh values because their shapes
    differ (the 1000-class ImageNet classifier vs a 5-class head) or the
    file lacks them."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    own = model.state_dict()
    keep = {k: v for k, v in sd.items() if k in own and own[k].shape == v.shape}
    model.load_state_dict(keep, strict=False)
    return sorted(k for k in own if k not in keep)


class Trainer(BaseTrainer):
    def __init__(self, cfg: Config, device=None, datasets=None) -> None:
        cfg.validate()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.compute_dtype = getattr(torch, cfg.model.compute_dtype)
        model = DenseNet(cfg.model, num_stages=1)
        init_weights(model, cfg.train.seed)
        if cfg.model.pretrained_path:
            skipped = load_pretrained(model, cfg.model.pretrained_path)
            if skipped:
                print(f"[ddl_tpu_torch] pretrained overlay skipped keys: {skipped}")
        self.model = model.to(self.device).eval()
        self.optimizer = make_optimizer(self.model.parameters(), cfg.train)
        normalizer = get_normalizer(cfg.model.pallas_normalize)
        self.train_step = make_train_step(self.model, self.optimizer, self.compute_dtype,
                                          normalizer=normalizer)
        self.eval_step = make_eval_step(self.model, self.compute_dtype, normalizer=normalizer)
        train_ds, test_ds = datasets if datasets is not None else build_datasets(cfg.data)
        # None: an eval-only trainer
        self.train_loader = None if train_ds is None else DataLoader(
            train_ds,
            cfg.data.global_batch_size,
            sampler=ShardedEpochSampler(
                len(train_ds), shuffle=cfg.data.shuffle, drop_last=cfg.data.drop_last,
                seed=cfg.train.seed,
            ),
            num_workers=cfg.data.num_workers,
            drop_last=cfg.data.drop_last,
        )
        if len(test_ds) == 0:
            raise ValueError("empty eval set")
        self.test_loader = DataLoader(
            test_ds,
            cfg.data.eval_batch_size,
            sampler=ShardedEpochSampler(
                len(test_ds), shuffle=False, drop_last=False,
                pad_mode="sentinel", seed=cfg.train.seed + 1,
            ),
            num_workers=cfg.data.num_workers,
            drop_last=False,
            pad_last_batch=True,
        )
        self.job_id = resolve_job_id()
        self.logger = MetricLogger(cfg.train.log_dir, self.job_id)
        self.num_periods = cfg.train.max_epochs
        self.halt_on_nan = cfg.train.halt_on_nan

    def run_period(self, epoch: int) -> tuple[dict, int]:
        """One training epoch in training mode -> ({"loss": mean train
        loss, "train_accuracy": ...}, steps).  The per-step losses and
        predictions are fetched to the host once, after the last step."""
        if self.train_loader is None:
            raise RuntimeError("this Trainer was built without a train set")
        self.model.train()
        self.train_loader.set_epoch(epoch)
        losses, preds, targets = [], [], []
        for images, labels in self.train_loader:
            gi, gl = to_device(images, labels, self.device)
            loss, pred = self.train_step(gi, gl)
            losses.append(loss)
            preds.append(pred)
            targets.append(labels)
        if not losses:
            raise RuntimeError("empty epoch: dataset smaller than one batch")
        mean_loss = float(np.mean(torch.stack(losses).cpu().numpy()))
        accuracy = float(np.mean(torch.cat(preds).cpu().numpy() == np.concatenate(targets)))
        return {"loss": mean_loss, "train_accuracy": accuracy}, len(losses)

    def evaluate(self, epoch: int) -> dict:
        """Eval loop in eval mode -> metric dict, over every test sample
        exactly once.  Logits stay on the device until the loop ends; one
        copy to the host then."""
        self.model.eval()
        self.test_loader.set_epoch(epoch)
        logits, targets = [], []
        for images, labels in self.test_loader:
            gi, _ = to_device(images, labels, self.device)
            logits.append(self.eval_step(gi))
            targets.append(labels)
        all_logits = torch.cat(logits).cpu().numpy()
        return masked_classification_eval(all_logits, np.concatenate(targets))

    # -------------------------------------------------- loop hooks

    def evaluate_period(self, epoch: int) -> dict:
        return self.evaluate(epoch)

    def format_train_line(self, epoch, elapsed, steps, m) -> str:
        return (
            f"Epoch {epoch} | Time: {elapsed:.2f}s | Steps: {steps} | "
            f"Loss: {m['loss']:.4f} | Training Accuracy: {m['train_accuracy']:.4f}"
        )

    def format_eval_line(self, epoch, m) -> str:
        return (
            f"Epoch {epoch} | Validation Loss: {m['val_loss']:.4f} | "
            f"Accuracy: {m['val_accuracy']:.4f} | QWK: {m['qwk']:.4f}"
        )
