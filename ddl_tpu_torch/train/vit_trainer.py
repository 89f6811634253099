"""The ViT trainer: the vision transformer on the shared period loop
(counterpart of ``ddl_tpu/train/vit_trainer.py``).

The CNN Trainer's shape (epoch periods, APTOS-style image loaders, masked
full-coverage eval, QWK-gated snapshots) driving the ViT step functions
(``train/vit_steps.py``).  In a world of ``data x pipe`` ranks each rank
loads its data row's contiguous ``batch / data`` rows of every global
batch (``ShardedEpochSampler(block=...)``, the JAX package's sharding of
one loader's batch over ``data``), every stage of a row the same rows; the
eval loader is ordered and sentinel-padded, its padded rows (label -1)
masked out of the metrics, every row's logits gathered (``Mesh.gather``)
so every rank computes the same QWK.

Snapshots hold the one-device layout (``{"model", "optimizer", "step"}``;
under ZeRO the optimizer's moments gathered into the replicated layout) or,
pipelined, the port's per-stage layout (``{"stages": [...]}``, gathered
from data row 0 onto rank 0, as the DenseNet pipeline's): a resume into
another layout fails naming both (``checkpoint.require_layout``), and one
of other stages' layers (another ``virtual_stages``) names the virtual
stages.  Under ``model`` rank 0 gathers the model ranks' parts and joins
them (``checkpoint.gather_parts``, ``models/convert.gather_vit_state``)
into the same layouts, and a restore cuts them over ``model`` again, so a
snapshot's layout does not depend on ``model``.  The manifest's cursor
re-enters a preempted epoch at its batch;
the resume and rollback snapshots are rank 0's choice, broadcast.  Rank 0
writes the CSV rows and the snapshots.
"""

from __future__ import annotations

import dataclasses
from time import perf_counter

import numpy as np
import torch

from ddl_tpu_torch import checkpoint as ckpt
from ddl_tpu_torch.config import DataConfig
from ddl_tpu_torch.data import DataLoader, ShardedEpochSampler, build_datasets, to_device
from ddl_tpu_torch.models.vit import ViTConfig
from ddl_tpu_torch.models.convert import gather_vit_state, shard_vit_state
from ddl_tpu_torch.parallel.mesh import build_lm_mesh
from ddl_tpu_torch.parallel.sharding import LMMeshSpec
from ddl_tpu_torch.train.loop import BaseTrainer, _phase
from ddl_tpu_torch.train.recovery import make_policy
from ddl_tpu_torch.train.vit_steps import make_vit_step_fns
from ddl_tpu_torch.utils import MetricLogger, faultinject, masked_classification_eval

__all__ = ["ViTRunConfig", "ViTTrainer"]


@dataclasses.dataclass
class ViTRunConfig:
    """The JAX ``ViTRunConfig``'s fields and defaults (the notes on each
    are there)."""

    batch: int = 32
    epochs: int = 3
    num_microbatches: int = 0
    accum_steps: int = 1
    # "gpipe" | "1f1b" | "zb" (parallel/lm_pipeline.SCHEDULES)
    pipeline_schedule: str = "gpipe"
    virtual_stages: int = 1
    zero_sharding: bool = False
    checkpoint_dir: str | None = "checkpoints"
    keep_snapshots: int = 0
    resume_epoch: int | None = None
    auto_resume: bool = True
    save_best_qwk: bool = True
    job_id: str = "vit"
    log_dir: str | None = "training_logs"
    halt_on_nan: bool = True
    nan_policy: str = "halt"
    nan_max_consecutive: int = 3
    nan_grace_scale: float = 0.1
    nan_grace_periods: int = 2
    preemption_save: bool = True
    profile_dir: str | None = None


class ViTTrainer(BaseTrainer):
    best_metric = "qwk"
    best_mode = "max"
    best_label = "QWK"

    def __init__(self, cfg: ViTConfig, spec: LMMeshSpec, tx, run: ViTRunConfig,
                 data: DataConfig | None = None, datasets=None, seed: int = 0, device=None,
                 mesh=None) -> None:
        """``tx(params) -> Optimizer``; ``seed`` seeds the weights and the
        dropout streams (the JAX trainer's ``rng``); ``device`` None means
        CUDA (``cuda:<local rank>`` in a world); ``mesh`` defaults to
        ``build_lm_mesh(spec)`` over the world, which must hold
        ``spec.num_devices`` ranks."""
        self.cfg, self.spec, self.run = cfg, spec, run
        self.job_id = run.job_id
        self.tx, self.seed = tx, seed
        self.pipelined = spec.pipe > 1
        if mesh is None:
            mesh = build_lm_mesh(spec, device)
        self.mesh = mesh
        self.device = self.mesh.device
        self.fns = self._make_fns()

        dc = data if data is not None else DataConfig(
            image_size=cfg.image_size, global_batch_size=run.batch, eval_batch_size=run.batch)
        train_ds, test_ds = datasets if datasets is not None else build_datasets(dc)
        shards, shard, rows = spec.data, self.mesh.data_index, run.batch // spec.data
        self.train_loader = DataLoader(
            train_ds, rows,
            sampler=ShardedEpochSampler(len(train_ds), shards, shard, seed=0, block=rows),
            on_retry=self._note_io_retry,
        )
        self.test_loader = DataLoader(
            test_ds, rows,
            sampler=ShardedEpochSampler(len(test_ds), shards, shard, shuffle=False,
                                        drop_last=False, pad_mode="sentinel", seed=1,
                                        block=rows),
            drop_last=False, pad_last_batch=True, on_retry=self._note_io_retry,
        )

        rank = self.mesh.rank
        self.is_logging_process = rank == 0
        self.logger = (MetricLogger(run.log_dir, run.job_id, global_rank=rank, local_rank=rank)
                       if run.log_dir else None)
        self._init_obs(run.log_dir, run.job_id, "vit",
                       host=rank if self.mesh.size > 1 else None)
        self._emit_pipe_schedule(run.pipeline_schedule, spec.pipe,
                                 run.num_microbatches or spec.pipe, run.virtual_stages)
        self.num_periods = run.epochs
        self.halt_on_nan = run.halt_on_nan
        self.recovery = make_policy(run)
        self.keep_snapshots = run.keep_snapshots
        self.preemption_save = run.preemption_save and bool(run.checkpoint_dir)
        self.profile_dir = run.profile_dir
        self.save_best = run.save_best_qwk and bool(run.checkpoint_dir)
        self.best_value = -1.0

        self.state = self.fns.init_state()
        self.periods_run = 0
        mine = None
        if self._first_on_host():
            mine = ckpt.resolve_resume(run.checkpoint_dir, run.job_id, run.resume_epoch,
                                       run.auto_resume)
        resume_epoch = self.mesh.agree(lambda: mine)
        if run.checkpoint_dir and resume_epoch is not None:
            t0 = perf_counter()
            ckpt.run_resume_load(
                # auto-discovered epochs were verified by resolve_resume
                lambda: self._restore(resume_epoch, verify=run.resume_epoch is not None),
                auto=run.resume_epoch is None,
                desc=f"job {run.job_id!r} epoch {resume_epoch}",
                hint="pass --fresh (auto_resume=False)",
            )
            self._emit_snapshot_restore(perf_counter() - t0, resume_epoch,
                                        self.periods_run, self._resume_offset)
            print(f"resumed; continuing at epoch {self.periods_run}")

    def _make_fns(self):
        run = self.run
        return make_vit_step_fns(
            self.cfg, self.spec, self.tx, self.seed, run.batch, mesh=self.mesh,
            num_microbatches=run.num_microbatches, accum_steps=run.accum_steps,
            pipeline_schedule=run.pipeline_schedule, virtual_stages=run.virtual_stages,
            zero_sharding=run.zero_sharding,
        )

    def _rebuild_step_fns(self) -> None:
        """A new step for the grace window's entry and exit, as the JAX
        trainer recompiles it: the factory reads the build-time fault
        again (consumed by the first build), so the replay runs clean."""
        self.fns = self._make_fns()

    # --------------------------------------------------------- snapshots

    def stage_state(self) -> dict:
        """This rank's model and optimizer state and the step: the live
        tensors (a save copies them)."""
        return {"model": self.state.model.state_dict(),
                "optimizer": self.state.optimizer.state_dict(), "step": self.state.step}

    def snapshot_state(self) -> dict | None:
        """What a snapshot holds; pipelined, ``{"stages": [...]}`` of data
        row 0 on rank 0 (CPU copies of the other stages, over the host
        group), each stage's model ranks joined.  Every rank must call it
        (ZeRO's moments are gathered too); ranks other than 0 get None when
        pipelined or tensor-parallel."""
        if not self.pipelined and self.spec.model == 1:
            return self.stage_state()
        parts = ckpt.gather_parts(self.mesh, self.stage_state)
        if parts is None:
            return None
        stages = [gather_vit_state([parts[p, m] for m in range(self.spec.model)])
                  for p in range(self.spec.pipe)]
        return {"stages": stages} if self.pipelined else stages[0]

    def load_state(self, state: dict) -> None:
        """Restore a snapshot state in place (the optimizer keeps pointing
        at the live parameters); a pipeline rank takes its stage's.  A
        snapshot of another layout raises ``ValueError`` naming both."""
        if self.pipelined:
            s = self.mesh.pipe_index
            ckpt.require_layout(state, self.spec.pipe)
            state = state["stages"][s]
            if set(state["model"]) != set(self.state.model.state_dict()):
                raise ValueError(
                    f"the snapshot holds the pipelined layout of {self.spec.pipe} stages cut "
                    f"elsewhere: its stage {s} holds other layers than this run's "
                    f"virtual_stages={self.run.virtual_stages} give that stage")
        else:
            ckpt.require_layout(state, 0)
        if self.spec.model > 1:
            state = shard_vit_state(state, self.spec, self.mesh.model_index)
        self.state.model.load_state_dict(state["model"])
        self.state.optimizer.load_state_dict(state["optimizer"])
        self.state.step = int(state["step"])

    def _restore(self, epoch: int, verify: bool) -> None:
        state, self.periods_run = ckpt.load_snapshot(
            self.run.checkpoint_dir, self.job_id, epoch, map_location=self.device,
            verify=verify)
        self.load_state(state)
        self._apply_cursor(epoch)

    def _snapshot_store(self):
        run = self.run
        return (run.checkpoint_dir, run.job_id) if run.checkpoint_dir else None

    def _rollback_restore(self, epoch: int) -> None:
        self._restore(epoch, verify=False)

    def _scale_updates(self, scale: float) -> None:
        self.state.optimizer.update_scale = scale

    def _apply_cursor(self, epoch: int) -> None:
        """Exact resume: a mid-epoch preemption snapshot re-enters its
        epoch at the recorded batch offset."""
        cur = ckpt.read_cursor(self.run.checkpoint_dir, self.run.job_id, epoch)
        if cur and int(cur.get("offset", 0)) > 0:
            self.periods_run = int(cur.get("period", self.periods_run))
            self._resume_offset = int(cur["offset"])
            print(f"[resume] data cursor: re-entering epoch {self.periods_run} at batch "
                  f"{self._resume_offset}")

    def save_snapshot(self, epoch: int) -> None:
        state = self.snapshot_state()
        if not self.is_logging_process:
            return
        cursor = self.data_cursor
        if cursor and cursor.get("offset", 0) >= len(self.train_loader):
            # preempted exactly at the epoch boundary: a clean next-epoch
            # start, not an empty-remainder resume
            cursor = {"period": int(cursor["period"]) + 1, "offset": 0}
        path = ckpt.save_snapshot(self.run.checkpoint_dir, self.job_id, epoch, state,
                                  cursor=cursor)
        print(f"epoch {epoch} | saved snapshot to {path}")

    def last_snapshot_hint(self):
        if not self.run.checkpoint_dir:
            return "none (set checkpoint_dir)"
        return ckpt.latest_epoch(self.run.checkpoint_dir, self.job_id)

    def resume_hint(self, epoch: int) -> str:
        return f"--job-id {self.job_id} --resume-epoch {epoch}"

    def opt_state_hbm_bytes(self) -> int:
        return self.state.optimizer.state_bytes()

    def param_hbm_bytes(self) -> int | None:
        from ddl_tpu_torch.obs.hbm import tree_shard_bytes

        return tree_shard_bytes(self.state.model.parameters())

    # ------------------------------------------------------- loop hooks

    def run_period(self, epoch: int, guard=None):
        self.train_loader.set_epoch(epoch)
        # exact resume: skip the batches a preemption snapshot already
        # consumed this epoch (one-shot index-level skip)
        skip = self.consume_resume_offset()
        if skip:
            self.train_loader.set_start_batch(skip)
        losses, steps = [], 0
        # global event steps (epoch * steps/epoch + i): one monotone counter
        step_base = epoch * len(self.train_loader) + skip
        it = iter(self.train_loader)
        while True:
            with _phase(self.obs, "data_wait", step=step_base + steps):
                batch = next(it, None)
            if batch is None:
                break
            images, labels = batch
            with _phase(self.obs, "h2d", step=step_base + steps):
                gi, gl = to_device(images, labels, self.device)
            with _phase(self.obs, "step", step=step_base + steps):
                # the HBM ledger's plan rides the run's first dispatch
                self.state, m = self.emit_hbm_plan("train_step", self.fns.train, self.state,
                                                   gi, gl,
                                                   resident=self.state.model.state_dict())
            # the loss stays on the device until the epoch's end
            losses.append(m["loss"])
            steps += 1
            faultinject.check_step(step_base + steps - 1, guard)
            if guard is not None and self.mesh.any(guard.requested):
                guard.request()  # the loop's preemption save, on every rank
                break
        if steps == 0:
            raise RuntimeError("empty epoch: dataset smaller than one batch")
        with _phase(self.obs, "fence", step=step_base + steps - 1):
            # the step's loss is already the data rows' mean, on every rank
            loss = float(torch.stack(losses).mean().item())
        return {"loss": loss}, steps

    def evaluate_period(self, epoch: int) -> dict:
        self.test_loader.set_epoch(epoch)
        logits, targets = [], []
        for images, labels in self.test_loader:
            gi, _ = to_device(images, labels, self.device)
            logits.append(self.fns.evaluate(self.state, gi))
            targets.append(labels)
        all_logits = self.mesh.gather(torch.cat(logits).cpu().numpy())
        return masked_classification_eval(all_logits, self.mesh.gather(np.concatenate(targets)))

    def rate_metrics(self, steps: int, elapsed: float) -> dict:
        return {"img_per_sec": steps * self.run.batch / elapsed}

    def format_train_line(self, epoch, elapsed, steps, m) -> str:
        return (f"epoch {epoch}: loss {m['loss']:.4f} ({steps} steps, {elapsed:.1f}s, "
                f"{steps / elapsed:.2f} steps/s)")

    def format_eval_line(self, epoch, m) -> str:
        return f"epoch {epoch}: val_acc {m['val_accuracy']:.4f} qwk {m['qwk']:.4f}"
