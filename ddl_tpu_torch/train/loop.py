"""The family-agnostic training loop (port of ``ddl_tpu/train/loop.py``,
``BaseTrainer``).  Every generic concern lives here once:

* the period loop (an epoch for DenseNet, a step window for the LM) with
  wall-clock timing,
* CSV metric logging (``utils/csv_logger.MetricLogger``) and the
  structured event stream (``obs/``): per-step phase spans, one
  ``period`` event per period, the hung-step watchdog (``DDL_WATCHDOG_S``,
  ``DDL_WATCHDOG_ACTION``),
* the NaN policy: halt with a pointer at the last snapshot
  (``nan_policy="halt"``), or recover in-loop (``"recover"``): skip the
  bad period's metrics/eval/snapshot, and after K consecutive hits roll
  back to the last valid snapshot with a reduced-LR grace window
  (``train/recovery.RecoveryPolicy``),
* the ``torch.profiler`` hook (one post-warm-up period into
  ``profile_dir``, with a digest of its device time),
* preemption (SIGTERM -> finish the in-flight step -> snapshot with the
  data cursor -> clean exit, ``utils/preemption.PreemptionGuard``),
* snapshot gating: best-eval-metric improvements (QWK for DenseNet)
  and/or a fixed cadence, and keep-last-K GC that never reaps the best,
* fault-injection hooks (``utils/faultinject``) so every recovery path
  above is provable by a CPU-only test.

Families subclass :class:`BaseTrainer` and implement only what is
genuinely family-specific: how to run one period, how to evaluate, and
how to write a snapshot.  ``train/trainer.py`` (DenseNet) and
``train/lm_trainer.py`` are the two here.

Not here yet: the JAX package's HBM ledger events (``hbm_plan``,
``hbm_sample``, the OOM dump; ROADMAP item 9), the pod agreement on the
rollback snapshot (item 7), and the pipeline-schedule event (item 8).
"""

from __future__ import annotations

import os
from contextlib import nullcontext
from time import perf_counter

import numpy as np

from ddl_tpu_torch.utils import faultinject
from ddl_tpu_torch.utils.memory import hbm_stats

__all__ = ["BaseTrainer"]


def _phase(obs, name: str, step: int | None = None):
    """Obs phase context, or a no-op when the trainer runs untraced."""
    return obs.phase(name, step=step) if obs is not None else nullcontext()


class BaseTrainer:
    """Template-method training loop.

    Subclass contract — attributes (set in ``__init__``):
      ``job_id``             job identity for logs and snapshots
      ``logger``             a ``MetricLogger`` or ``None``
      ``device``             the torch device the family runs on
      ``periods_run``        resume cursor (first period to run)
      ``num_periods``        total periods in a full run
      ``halt_on_nan``        raise on non-finite training loss
      ``preemption_save``    install a SIGTERM guard around the run
      ``profile_dir``        trace one post-warm-up period here (or None)
      ``save_best``          gate snapshots on eval-metric improvements
      ``best_metric``        eval-dict key for the gate (or None)
      ``best_mode``          "max" (accuracy-like) or "min" (loss-like)
      ``best_value``         current best (init -inf for max, +inf for min)

    and methods:
      ``run_period(period, guard) -> (train_metrics: dict, steps: int)``
          run one period; poll ``guard.requested`` at step boundaries and
          stop early when set.
      ``evaluate_period(period) -> dict | None``
          eval metrics for this period boundary, or None to skip.
      ``save_snapshot(period) -> None``
          write a resumable snapshot for this period.
      ``wait_for_saves() -> None``
          block until async snapshot writes commit (default no-op).

    Optional overrides: ``rate_metrics``, ``snapshot_due``,
    ``format_train_line`` / ``format_eval_line``, ``period_label``,
    ``best_label``, ``resume_hint``, ``last_snapshot_hint``,
    ``_snapshot_store`` / ``_rollback_restore`` (rollback),
    ``_scale_updates`` (the grace window), ``opt_state_bytes``.
    """

    period_label = "Epoch"
    # CSV name for the per-period wall time; step-based families relabel it
    time_metric = "epoch_time"
    periods_run = 0
    device = None
    logger = None
    is_logging_process = True
    preemption_save = False
    profile_dir = None
    save_best = False
    best_metric = None
    best_mode = "max"
    best_value = -float("inf")
    # Structured event tracing (obs/steptrace.StepTrace), set by families
    # through _init_obs; None runs the loop untraced.
    obs = None
    # Hung-step watchdog deadline in seconds (0/None = off); the
    # DDL_WATCHDOG_S env var is the operator override.
    watchdog_s = None
    # In-loop non-finite-loss recovery (train/recovery.RecoveryPolicy) or
    # None; with None, halt_on_nan decides.
    recovery = None
    # Update scaling during a post-rollback grace window.
    update_scale = 1.0
    # True after a preemption-triggered early exit.
    preempted = False
    # Snapshot GC: keep the newest K *valid* snapshots; 0 = unlimited.
    keep_snapshots = 0
    # The best-eval-metric snapshot's store key: GC never deletes it.
    best_snapshot_epoch = None
    # The data-stream position the NEXT snapshot represents, set by the
    # loop before every save_snapshot call: {"period", "offset"} where
    # offset is the number of batches this period had consumed when the
    # state was captured (0 for a period-boundary save, partial for a
    # preemption save).
    data_cursor = None
    # Batches of the resume period already consumed by the snapshot being
    # restored (from its cursor); the family's run_period skips them.
    _resume_offset = 0

    def consume_resume_offset(self) -> int:
        """The batch offset the first resumed period starts at; one-shot
        (subsequent periods start at 0)."""
        offset, self._resume_offset = self._resume_offset, 0
        return offset

    # ---------------------------------------------------------- overrides

    def rate_metrics(self, steps: int, elapsed: float) -> dict:
        """Extra per-period throughput metrics (tokens/sec, ...)."""
        return {}

    def opt_state_bytes(self) -> int | None:
        """Bytes of this run's live optimizer state (stamped into every
        period event's rates as ``opt_hbm_bytes``), or None."""
        return None

    def snapshot_due(self, period: int) -> bool:
        """Fixed-cadence snapshots, independent of the best-metric gate."""
        return False

    def log_due(self, period: int) -> bool:
        """Whether a period prints its train line and writes its rows."""
        return True

    def log_index(self, period: int) -> int:
        """The CSV 'epoch' column of a period's rows."""
        return period

    def wait_for_saves(self) -> None:
        return None

    def _snapshot_store(self) -> tuple | None:
        """``(checkpoint_dir, job_id)`` when this trainer checkpoints,
        else None (checkpoint-less runs stay on the halt path)."""
        return None

    def _rollback_restore(self, epoch: int) -> None:
        """Restore the state from the (already-verified) snapshot
        ``epoch`` in place and rewind the family's resume cursor."""
        raise NotImplementedError

    def _scale_updates(self, scale: float) -> None:
        """Apply a new update scale to the family's optimizer."""

    def last_snapshot_hint(self):
        return "none"

    def rollback_to_snapshot(self) -> bool:
        """Restore the latest *valid* snapshot and rewind the resume
        cursor; return False when there is nothing to roll back to."""
        store = self._snapshot_store()
        if store is None:
            return False
        self.wait_for_saves()  # commit any in-flight async snapshot first
        from ddl_tpu_torch import checkpoint as ckpt

        epoch = ckpt.latest_valid_epoch(*store)
        if epoch is None:
            return False
        self._rollback_restore(epoch)
        print(f"[recovery] restored snapshot {epoch}")
        return True

    def _gc_snapshots(self) -> None:
        """Keep-last-K snapshot GC after a save (no-op unless the family
        checkpoints and ``keep_snapshots`` > 0)."""
        store = self._snapshot_store()
        if not self.keep_snapshots or store is None or not self.is_logging_process:
            return
        from ddl_tpu_torch import checkpoint as ckpt

        protect = (self.best_snapshot_epoch,) if self.best_snapshot_epoch is not None else ()
        for path, reason in ckpt.gc_snapshots(*store, keep=self.keep_snapshots,
                                              protect=protect):
            print(f"[gc] removed snapshot {path}: {reason}")

    def set_update_scale(self, scale: float) -> None:
        """Scale subsequent optimizer updates by ``scale`` (the reduced-LR
        grace after a rollback)."""
        if scale == self.update_scale:
            return
        self.update_scale = scale
        self._scale_updates(scale)

    def _note_io_retry(self, exc: BaseException, attempt: int) -> None:
        """Data-loader retry callback: count transient-I/O retries into
        the obs event stream so a degrading NAS is visible before it
        becomes an outage."""
        self.io_retries = getattr(self, "io_retries", 0) + 1
        if self.obs is not None:
            self.obs.writer.emit("io_retry", error=str(exc), attempt=attempt)

    def _init_obs(self, log_dir, job_id: str, family: str) -> None:
        """The event stream (``obs/events.py``); no-op without a log dir,
        so the obs story tracks the CSV one."""
        if log_dir:
            from ddl_tpu_torch.obs import StepTrace

            self.obs = StepTrace.create(log_dir, job_id, family, device=self.device)

    def _emit_snapshot_restore(self, dur: float, epoch, period: int, offset: int = 0) -> None:
        """One ``snapshot_restore`` event per startup restore: how long it
        took and the resume cursor the restored state represents.  The
        in-loop rollback emits ``rollback`` instead."""
        if self.obs is None:
            return
        self.obs.writer.emit("snapshot_restore", dur=dur, epoch=epoch,
                             period=int(period), offset=int(offset))

    @property
    def best_label(self) -> str:
        return (self.best_metric or "metric").upper()

    def resume_hint(self, period: int) -> str:
        return f"job_id={self.job_id} {self.period_label.lower()}={period}"

    def format_train_line(self, period: int, elapsed: float, steps: int, metrics: dict) -> str:
        body = " | ".join(f"{k}: {v:.4f}" for k, v in metrics.items())
        return (f"{self.period_label} {period} | Time: {elapsed:.2f}s | "
                f"Steps: {steps} | {body}")

    def format_eval_line(self, period: int, metrics: dict) -> str:
        body = " | ".join(f"{k}: {v:.4f}" for k, v in metrics.items())
        return f"{self.period_label} {period} | {body}"

    # ------------------------------------------------------------- gating

    def _improved(self, eval_metrics: dict | None) -> bool:
        if (not self.save_best or self.best_metric is None or not eval_metrics
                or self.best_metric not in eval_metrics):
            return False
        value = float(eval_metrics[self.best_metric])
        better = (value > self.best_value if self.best_mode == "max"
                  else value < self.best_value)
        if better:
            self.best_value = value
            print(f"New Best Validation {self.best_label}: {value:.4f}")
        return better

    # ---------------------------------------------------------- the loop

    def train(self, max_periods: int | None = None, guard=None) -> None:
        """Run periods ``periods_run .. max_periods - 1`` (default: the
        configured count), under a SIGTERM/SIGINT guard when
        ``preemption_save`` and none is given."""
        from ddl_tpu_torch.utils.preemption import PreemptionGuard

        if guard is None and self.preemption_save:
            with PreemptionGuard() as installed:
                return self._train_loop(max_periods, installed)
        return self._train_loop(max_periods, guard)

    def _train_loop(self, max_periods: int | None, guard) -> None:
        max_periods = max_periods or self.num_periods
        obs = self.obs
        watchdog = None
        if obs is not None:
            # the env var is the operator OVERRIDE, so it wins over a
            # family-set watchdog_s
            env = os.environ.get("DDL_WATCHDOG_S")
            deadline = float(env) if env not in (None, "") else (self.watchdog_s or 0)
            if deadline > 0:
                from ddl_tpu_torch.obs.watchdog import Watchdog

                action = os.environ.get("DDL_WATCHDOG_ACTION", "dump")
                watchdog = Watchdog(obs.writer, deadline, on_stall=action).start()
                obs.watchdog = watchdog
        try:
            self._run_periods(max_periods, guard, obs)
        finally:
            if watchdog is not None:
                watchdog.stop()
            if obs is not None:
                obs.finish(verbose=self.is_logging_process)

    def _run_periods(self, max_periods: int, guard, obs) -> None:
        # Profile one post-warm-up period when configured.
        profile_period = None
        if self.profile_dir:
            profile_period = min(self.periods_run + 1, max_periods - 1)
        prof = None
        # a while over the resume cursor, not a for over a frozen range:
        # the recovery policy's rollback rewinds periods_run mid-run
        while self.periods_run < max_periods:
            period = self.periods_run
            if period == profile_period:
                prof = self._start_profile()
            if obs is not None:
                obs.begin_period(period)
            start = perf_counter()
            # where this period's data stream starts (nonzero only for the
            # first period after an exact mid-period resume) — a
            # preemption cursor must record skip + steps, not just steps
            offset_base = self._resume_offset
            train_metrics, steps = self.run_period(period, guard)
            elapsed = perf_counter() - start
            if prof is not None:
                self._stop_profile(prof)
                prof = None
            train_metrics = faultinject.poison_loss(train_metrics)
            loss = train_metrics.get("loss")
            idx = self.log_index(period)
            # one rate_metrics call per period, shared by the CSV rows and
            # the period obs event
            rates = self.rate_metrics(steps, elapsed)
            opt_bytes = self.opt_state_bytes()
            if opt_bytes:
                rates.setdefault("opt_hbm_bytes", opt_bytes)
            if loss is not None and not np.isfinite(loss):
                if self._handle_nonfinite(period, idx, loss, obs):
                    # the bad period is not logged/evaluated/snapshotted;
                    # its period event still flows
                    if obs is not None:
                        obs.end_period(period, idx, elapsed, steps, train_metrics,
                                       rates=rates, offset=offset_base)
                    if guard is not None and guard.requested:
                        # preempted mid-recovery: exit inside the grace
                        # window NOW, without snapshotting the poisoned
                        # period — the relaunch resumes from the last
                        # good snapshot
                        self.preempted = True
                        self.wait_for_saves()
                        print(
                            f"Preempted during non-finite-loss recovery at "
                            f"{self.period_label.lower()} {period}; exiting without "
                            f"snapshotting the poisoned period. Last good snapshot: "
                            f"{self.last_snapshot_hint()}"
                        )
                        return
                    continue
                if self.halt_on_nan:
                    raise RuntimeError(
                        f"Non-finite training loss {loss} at "
                        f"{self.period_label.lower()} {period}; halting. "
                        f"Last snapshot: {self.last_snapshot_hint()}"
                    )
            elif self.recovery is not None and self.recovery.on_finite():
                self.set_update_scale(1.0)
                print("[recovery] grace window over; update scale back to 1.0")
            if self.log_due(period):
                with _phase(obs, "logging", step=idx):
                    print(self.format_train_line(period, elapsed, steps, train_metrics))
                    if self.logger is not None and self.is_logging_process:
                        self.logger.log_many(train_metrics, idx)
                        self.logger.log(self.time_metric, elapsed, idx)
                        self.logger.log("steps_per_sec", steps / elapsed, idx)
                        self.logger.log_many(rates, idx)
                        mem = hbm_stats(self.device) if self.device is not None else None
                        if mem is not None:
                            self.logger.log("hbm_peak_bytes", mem["peak_bytes_in_use"], idx)

            with _phase(obs, "eval", step=idx):
                eval_metrics = self.evaluate_period(period)
            if eval_metrics:
                with _phase(obs, "logging", step=idx):
                    print(self.format_eval_line(period, eval_metrics))
                    if self.logger is not None and self.is_logging_process:
                        self.logger.log_many(eval_metrics, idx)

            improved = self._improved(eval_metrics)
            if improved or self.snapshot_due(period):
                with _phase(obs, "checkpoint", step=idx):
                    # a boundary save: the period's data is fully consumed
                    self.data_cursor = {"period": period + 1, "offset": 0}
                    self.save_snapshot(period)
                    if improved:
                        # GC must never reap the best model
                        self.best_snapshot_epoch = idx
                    self._gc_snapshots()
            preempted = guard is not None and guard.requested
            if preempted:
                # Preempted: checkpoint what we have and exit cleanly.
                # Save BEFORE end_period so the blocking final commit lands
                # in this period's checkpoint phase total.
                with _phase(obs, "checkpoint", step=idx):
                    # a mid-period save: record how far into the period's
                    # data stream the state got, so the resumed run
                    # re-enters THIS period at that offset
                    self.data_cursor = {"period": period, "offset": offset_base + steps}
                    self.save_snapshot(period)
                    self.wait_for_saves()
                    self._gc_snapshots()
            if obs is not None:
                obs.end_period(period, idx, elapsed, steps, train_metrics,
                               rates=rates, offset=offset_base)
            self.periods_run = period + 1
            if preempted:
                self.preempted = True
                print(
                    f"Preempted at {self.period_label.lower()} {period}; "
                    f"snapshot committed. Resume with {self.resume_hint(period)}"
                )
                return
        self.wait_for_saves()

    def _start_profile(self):
        """``torch.profiler`` over one period: CPU and, on a GPU, CUDA
        activity."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device is not None and self.device.type == "cuda" and torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
        return prof

    def _stop_profile(self, prof) -> None:
        """Close the profiled period, export its Chrome trace into
        ``profile_dir`` and print the five ops with the most device time
        (self time on the CPU without a card).  Digest failures never cost
        the run: the trace is already on disk."""
        prof.__exit__(None, None, None)
        os.makedirs(self.profile_dir, exist_ok=True)
        trace = os.path.join(self.profile_dir, f"{self.job_id}-trace.json")
        prof.export_chrome_trace(trace)
        if not self.is_logging_process:
            return
        try:
            events = prof.key_averages()
            on_device = any(e.self_device_time_total > 0 for e in events)
            key = "self_device_time_total" if on_device else "self_cpu_time_total"
            top = sorted(events, key=lambda e: -getattr(e, key))[:5]
            total = sum(getattr(e, key) for e in events) / 1e3
            ops = "  ".join(f"{e.key[:40]}={getattr(e, key) / 1e3:.1f}ms" for e in top)
            where = "device" if on_device else "host (no device time)"
            print(f"[profile] trace {trace}: {where} total {total:.1f}ms — {ops}")
        except Exception as e:  # a digest failure must never kill a training run
            print(f"[profile] digest unavailable ({e}); trace in {trace}")

    def _handle_nonfinite(self, period, idx, loss, obs) -> bool:
        """Recovery-policy reaction to a non-finite period loss; returns
        True when the policy absorbed it (skip or rollback), False to
        fall through to halt_on_nan."""
        if self.recovery is None:
            return False
        pol = self.recovery
        action = pol.on_nonfinite()
        if obs is not None:
            obs.anomaly.record(idx, "nonfinite_loss", value=float(loss),
                               consecutive=pol.consecutive, action=action)
        label = self.period_label.lower()
        if action == "skip":
            print(
                f"[recovery] non-finite loss ({loss}) at {label} {period}: skipping the "
                f"period ({pol.consecutive}/{pol.max_consecutive} consecutive)"
            )
            self.periods_run = period + 1
            return True
        if pol.rollbacks >= pol.max_rollbacks:
            raise RuntimeError(
                f"Non-finite training loss persisted through {pol.rollbacks} "
                f"rollback(s); giving up. Last snapshot: {self.last_snapshot_hint()}"
            )
        restore_t0 = perf_counter()
        if not self.rollback_to_snapshot():
            raise RuntimeError(
                f"Non-finite training loss for {pol.consecutive} consecutive {label}s "
                f"and no snapshot to roll back to. Last snapshot: "
                f"{self.last_snapshot_hint()}"
            )
        hits = pol.consecutive
        pol.on_rollback()
        self.set_update_scale(pol.grace_scale)
        if obs is not None:
            obs.writer.emit(
                "rollback",
                step=idx,
                period=period,
                resumed_at=self.periods_run,
                restore_dur=perf_counter() - restore_t0,
                grace_scale=pol.grace_scale,
                grace_periods=pol.grace_periods,
            )
        print(
            f"[recovery] non-finite loss for {hits} consecutive {label}s: rolled back "
            f"to {label} {self.periods_run}; reduced-LR grace x{pol.grace_scale} for "
            f"{pol.grace_periods} {label}(s)"
        )
        return True
