"""The CNN trainer (counterpart of ``ddl_tpu/train/trainer.py``): the
model, the optimizer, the data loaders, ``run_period`` and ``evaluate``,
snapshots and resume, on the period loop of ``train/loop.BaseTrainer``.

``Trainer(cfg).train(max_periods)`` trains: per epoch, the shuffled
drop-last train loader -> uint8 batch on the device -> normalize ->
DenseNet with batch statistics -> softmax cross-entropy -> backward ->
Adam, then the eval pass, the CSV rows, the events, and a snapshot when
validation QWK improves.  Losses and predictions stay on the device during
the epoch and are fetched to the host once at its end (the ``fence``
phase); the ``step`` phase is the dispatch.

``Trainer(cfg).evaluate(epoch)`` is the eval path: uint8 batch ->
normalize -> DenseNet in eval mode -> logits -> the masked metric suite
(val_loss, accuracy, QWK, F1, ...).  Eval is deterministic and
full-coverage: an ordered sampler with no dropped tail, the last batch
padded to full size with label -1 rows that the metrics mask out, so every
test sample counts exactly once.

Snapshots (``checkpoint.py``) hold the model's ``state_dict`` (parameters
and BatchNorm running statistics) and the ``Optimizer.state_dict()``
(moments, per-parameter steps and the schedule's ``count``); the
sampler's order is a function of ``(seed, epoch)``, so no generator state
is needed.  A restore or rollback loads in place (``load_state_dict``
copies into the live tensors), so the optimizer keeps pointing at them.
A run resumes from ``train.snapshot_job_id``/``snapshot_epoch``, or by
itself from the latest valid snapshot of its job id; a snapshot whose
manifest carries a mid-epoch cursor re-enters that epoch at that batch.
"""

from __future__ import annotations

import os
from time import perf_counter

import numpy as np
import torch

from ddl_tpu_torch import checkpoint as ckpt
from ddl_tpu_torch.config import Config
from ddl_tpu_torch.data import DataLoader, ShardedEpochSampler, build_datasets, to_device
from ddl_tpu_torch.models import DenseNet, build_stage_specs, init_weights
from ddl_tpu_torch.ops import get_normalizer
from ddl_tpu_torch.train.loop import BaseTrainer, _phase
from ddl_tpu_torch.train.recovery import make_policy
from ddl_tpu_torch.train.state import make_optimizer
from ddl_tpu_torch.train.steps import make_eval_step, make_grad_stats_fn, make_train_step
from ddl_tpu_torch.utils import MetricLogger, faultinject, masked_classification_eval
from ddl_tpu_torch.utils.device import resolve_device
from ddl_tpu_torch.utils.timing import fence

__all__ = ["Trainer", "resolve_device", "resolve_job_id"]


def resolve_job_id() -> str:
    """Job identity from the launcher's environment (``DDL_JOB_ID``, then
    ``TORCHX_JOB_ID``, else ``"local"``); the last path segment."""
    raw = os.environ.get("DDL_JOB_ID") or os.environ.get("TORCHX_JOB_ID") or "local"
    return raw.split("/")[-1]


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
    best_metric = "qwk"
    best_mode = "max"
    best_label = "QWK"

    def __init__(self, cfg: Config, device=None, datasets=None) -> None:
        cfg.validate()
        self.cfg = cfg
        self.job_id = resolve_job_id()
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
        self.grad_stats_fn = None
        if cfg.train.log_gradient_stats:
            self.grad_stats_fn = make_grad_stats_fn(
                self.model, build_stage_specs(cfg.model, num_stages=1))
        normalizer = get_normalizer(cfg.model.pallas_normalize)
        self.train_step = make_train_step(
            self.model, self.optimizer, self.compute_dtype, normalizer=normalizer,
            on_grads=self._log_grad_stats if self.grad_stats_fn is not None else None)
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
            on_retry=self._note_io_retry,
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
            on_retry=self._note_io_retry,
        )

        # the resume decision comes BEFORE the logger, so the CSV lineage
        # column records auto-resumed runs too
        self._resume_job = cfg.train.snapshot_job_id
        self._resume_epoch = cfg.train.snapshot_epoch
        self._resume_auto = False
        if self._resume_job is None:
            # snapshot_epoch without a job id means THIS job at that epoch
            found = ckpt.resolve_resume(
                cfg.train.checkpoint_dir, self.job_id,
                explicit=cfg.train.snapshot_epoch, auto=cfg.train.auto_resume,
            )
            if found is not None:
                self._resume_job, self._resume_epoch = self.job_id, found
                self._resume_auto = cfg.train.snapshot_epoch is None
        self.logger = MetricLogger(cfg.train.log_dir, self.job_id,
                                   model_start_job_id=self._resume_job)
        self._init_obs(cfg.train.log_dir, self.job_id, "cnn")
        self.epochs_run = 0
        # shared-loop knobs (train/loop.BaseTrainer)
        self.num_periods = cfg.train.max_epochs
        self.halt_on_nan = cfg.train.halt_on_nan
        self.recovery = make_policy(cfg.train)
        self.keep_snapshots = cfg.train.keep_snapshots
        self.preemption_save = cfg.train.preemption_save
        self.profile_dir = cfg.train.profile_dir
        self.save_best = cfg.train.save_best_qwk
        self.best_value = -1.0
        self._snapshot_mgr = None
        self._period_steps = 0
        if self._resume_job is not None:
            self._load_snapshot()

    # ------------------------------------------------------- snapshots

    # ``epochs_run`` is this family's public name for the loop's resume
    # cursor; keep both views in sync.
    @property
    def periods_run(self) -> int:
        return self.epochs_run

    @periods_run.setter
    def periods_run(self, value: int) -> None:
        self.epochs_run = value

    def snapshot_state(self) -> dict:
        """What a snapshot holds: the live tensors (a save copies them)."""
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict()}

    def load_state(self, state: dict) -> None:
        """Restore a snapshot state in place: the model's tensors and the
        optimizer's state, which keeps pointing at the parameters."""
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])

    def _restore(self, job_id: str, epoch: int, verify: bool) -> None:
        state, self.epochs_run = ckpt.load_snapshot(
            self.cfg.train.checkpoint_dir, job_id, epoch, map_location=self.device,
            verify=verify,
        )
        self.load_state(state)
        self._apply_cursor(job_id, epoch)

    def _snapshot_store(self):
        t = self.cfg.train
        return (t.checkpoint_dir, self.job_id) if t.checkpoint_dir else None

    def _rollback_restore(self, epoch: int) -> None:
        self._restore(self.job_id, epoch, verify=False)

    def _scale_updates(self, scale: float) -> None:
        self.optimizer.update_scale = scale

    def _apply_cursor(self, job_id: str, epoch: int) -> None:
        """Exact-resume refinement: if the snapshot's manifest carries a
        mid-epoch data cursor (a preemption landed partway through the
        epoch), re-enter THAT epoch at the recorded batch offset instead
        of skipping its remaining batches."""
        cur = ckpt.read_cursor(self.cfg.train.checkpoint_dir, job_id, epoch)
        if cur and int(cur.get("offset", 0)) > 0:
            self.epochs_run = int(cur.get("period", self.epochs_run))
            self._resume_offset = int(cur["offset"])
            print(f"[resume] data cursor: re-entering epoch {self.epochs_run} at batch "
                  f"{self._resume_offset}")

    def _load_snapshot(self) -> None:
        t = self.cfg.train
        path = ckpt.snapshot_path(t.checkpoint_dir, self._resume_job, self._resume_epoch)
        if not path.exists():
            print(f"No snapshot at {path}; starting fresh")
            return
        print(f"Loading snapshot from {path}")
        t0 = perf_counter()
        ckpt.run_resume_load(
            # an auto-discovered epoch was verified by resolve_resume moments
            # ago; only explicit resumes verify again
            lambda: self._restore(self._resume_job, self._resume_epoch,
                                  verify=not self._resume_auto),
            auto=self._resume_auto,
            desc=str(path),
            hint="pass train.auto_resume=false",
        )
        self._emit_snapshot_restore(perf_counter() - t0, self._resume_epoch,
                                    self.epochs_run, self._resume_offset)
        print(f"Resuming training from epoch {self.epochs_run}")

    def save_snapshot(self, epoch: int) -> None:
        cursor = self.data_cursor
        if cursor and cursor.get("offset", 0) >= len(self.train_loader):
            # preempted exactly at the epoch's end: the stream is fully
            # consumed, so the cursor is a clean next-epoch start
            cursor = {"period": int(cursor["period"]) + 1, "offset": 0}
        t = self.cfg.train
        if t.async_checkpoint:
            if self._snapshot_mgr is None:
                self._snapshot_mgr = ckpt.SnapshotManager(t.checkpoint_dir, self.job_id)
            path = self._snapshot_mgr.save(epoch, self.snapshot_state(), cursor=cursor)
        else:
            path = ckpt.save_snapshot(t.checkpoint_dir, self.job_id, epoch,
                                      self.snapshot_state(), cursor=cursor)
        print(f"Epoch {epoch} | Saved snapshot to {path}")

    def wait_for_saves(self) -> None:
        if self._snapshot_mgr is not None:
            self._snapshot_mgr.wait()

    def last_snapshot_hint(self):
        return ckpt.latest_epoch(self.cfg.train.checkpoint_dir, self.job_id)

    def resume_hint(self, epoch: int) -> str:
        return f"train.snapshot_job_id={self.job_id} train.snapshot_epoch={epoch}"

    def opt_state_bytes(self) -> int:
        return self.optimizer.state_bytes()

    # ------------------------------------------------------------ steps

    def _log_grad_stats(self) -> None:
        """The train step's ``on_grads``: this step's gradient statistics
        into ``gradient.csv``, under the period's step count (as the JAX
        trainer logs them)."""
        self.logger.log_gradient_stats(self.grad_stats_fn(), step=self._period_steps)

    def run_period(self, epoch: int, guard=None) -> tuple[dict, int]:
        """One training epoch in training mode -> ({"loss": mean train
        loss, "train_accuracy": ...}, steps).  The per-step losses and
        predictions are fetched to the host once, after the last step.
        ``guard`` (a ``PreemptionGuard``) stops the epoch after the
        in-flight step when a preemption signal has arrived."""
        if self.train_loader is None:
            raise RuntimeError("this Trainer was built without a train set")
        self.model.train()
        self.train_loader.set_epoch(epoch)
        # exact resume: skip the batches a preemption snapshot already
        # consumed this epoch (index-level, one-shot)
        skip = self.consume_resume_offset()
        if skip:
            self.train_loader.set_start_batch(skip)
        losses, preds, targets = [], [], []
        steps = 0
        # event steps are GLOBAL (epoch * steps/epoch + i): one monotone
        # counter per host
        step_base = epoch * len(self.train_loader) + skip
        it = iter(self.train_loader)
        while True:
            # data_wait = host-side batch production, h2d = the copy to the
            # device, step = the step's dispatch; the device time the
            # dispatch hides surfaces in the period-end fence phase
            with _phase(self.obs, "data_wait", step=step_base + steps):
                batch = next(it, None)
            if batch is None:
                break
            images, labels = batch
            with _phase(self.obs, "h2d", step=step_base + steps):
                gi, gl = to_device(images, labels, self.device)
            self._period_steps = steps
            with _phase(self.obs, "step", step=step_base + steps):
                loss, pred = self.train_step(gi, gl)
            losses.append(loss)
            preds.append(pred)
            targets.append(labels)
            steps += 1
            faultinject.check_step(step_base + steps - 1, guard)
            if guard is not None and guard.requested:
                break
        if steps == 0:
            raise RuntimeError("empty epoch: dataset smaller than one batch")
        with _phase(self.obs, "fence", step=step_base + steps):
            fence(self.device)
            mean_loss = float(np.mean(torch.stack(losses).cpu().numpy()))
            y_pred = torch.cat(preds).cpu().numpy()
        accuracy = float(np.mean(y_pred == np.concatenate(targets)))
        return {"loss": mean_loss, "train_accuracy": accuracy}, steps

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
