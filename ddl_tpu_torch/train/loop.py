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

In a data-parallel world (a family's ``mesh`` of several ranks) the
rollback snapshot is rank 0's choice, broadcast to every rank, and
``train`` ends with a barrier, so no rank leaves before rank 0 has
committed its last snapshot.  Under pod supervision the choice is first
agreed across the hosts through the rendezvous
(``coord.agreed_rollback_epoch``, the JAX package's), by one process per
host (``_first_on_host``); for hosts with no process group between them
(one process each) that file agreement is the only one.

A pipelined family emits one ``pipe_schedule`` event per run
(``_emit_pipe_schedule``, the modeled per-stage accounting of
``obs/schedule_model.py``).

The HBM ledger (``obs/hbm.py``): one ``hbm_sample`` a period (and one
after a startup restore) with this rank's parameter and optimizer bytes
(``param_hbm_bytes``, ``opt_state_hbm_bytes``: ZeRO's shard, not the
whole) against the watermark; one ``hbm_plan`` per program label, taken
over the program's first dispatch (``emit_hbm_plan``; ``DDL_HBM_PLAN=
off|aval``); and, when the periods die of a device allocation failure,
one ``hbm_oom_dump`` before the exception propagates.
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
    ``_scale_updates`` (the grace window), ``_rebuild_step_fns`` (after
    it), ``param_hbm_bytes`` / ``opt_state_hbm_bytes`` (the ledger's
    tracked bytes).
    """

    period_label = "Epoch"
    # CSV name for the per-period wall time; step-based families relabel it
    time_metric = "epoch_time"
    periods_run = 0
    device = None
    # this rank's parallel.mesh.Mesh (None: one process, no agreement)
    mesh = None
    # in-loop rollbacks this process performed (the pod agreement's key)
    _rollback_seq = 0
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

    def opt_state_hbm_bytes(self) -> int | None:
        """This rank's bytes of the live optimizer state (ZeRO's shard, not
        the whole), stamped into every period event's rates as
        ``opt_hbm_bytes`` and into the ``hbm_sample`` events; or None."""
        return None

    def param_hbm_bytes(self) -> int | None:
        """This rank's bytes of the live parameters (the ledger's second
        tracked category), or None."""
        return None

    # program labels this trainer has already stamped an hbm_plan for
    _hbm_planned = None

    def emit_hbm_plan(self, label: str, fn, *args, resident=None, **kwargs):
        """Dispatch ``fn(*args, **kwargs)`` and return its output; the
        first dispatch of each ``label`` in this trainer goes through
        ``obs/hbm.plan_program``, which measures it and emits one
        ``hbm_plan`` (``resident``: the state ``fn`` updates in place).
        ``DDL_HBM_PLAN=off`` disables the plans, ``=aval`` keeps the
        shape arithmetic without synchronising the device."""
        if self.obs is None:
            return fn(*args, **kwargs)
        if self._hbm_planned is None:
            self._hbm_planned = set()
        if label in self._hbm_planned:
            return fn(*args, **kwargs)
        self._hbm_planned.add(label)
        from ddl_tpu_torch.obs import hbm

        mode = hbm.plan_mode()
        if mode == "off":
            return fn(*args, **kwargs)
        out, _ = hbm.plan_program(self.obs.writer, label, fn, args, kwargs, mode=mode,
                                  resident=resident, device=self.device)
        return out

    def _emit_hbm_sample(self, step=None, context=None) -> None:
        """One ``hbm_sample``: the tracked parameter and optimizer bytes
        against the device watermark (``obs/hbm.live_sample``)."""
        if self.obs is None:
            return
        from ddl_tpu_torch.obs import hbm

        hbm.live_sample(self.obs.writer, params_bytes=self.param_hbm_bytes(),
                        opt_bytes=self.opt_state_hbm_bytes(), step=step, context=context,
                        device=self.device)

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

    def _rebuild_step_fns(self) -> None:
        """Rebuild the family's step functions after the update scale
        changed (grace entry and exit), as the JAX package recompiles
        them; the default keeps them.  A family whose step reads a
        build-time fault (``faultinject.traced_nan_step``) rebuilds, so
        the replay after a rollback runs clean."""

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
        from ddl_tpu_torch import coord

        # agree keys are write-once, and a rollback can fire again in one
        # incarnation: the key carries this process's rollback count,
        # which advances in lock-step on every host (each sees the same
        # non-finite loss at the same period)
        seq = self._rollback_seq
        self._rollback_seq = seq + 1
        mine = None
        if self._first_on_host():
            mine = coord.agreed_rollback_epoch(
                store[1], lambda: ckpt.latest_valid_epoch(*store), seq)
        epoch = self._agree(lambda: mine)
        if epoch is None:
            return False
        self._rollback_restore(epoch)
        print(f"[recovery] restored snapshot {epoch}")
        return True

    def _agree(self, fn):
        """``fn()`` decided on rank 0 and broadcast to every rank."""
        return fn() if self.mesh is None else self.mesh.agree(fn)

    def _first_on_host(self) -> bool:
        """Whether this process speaks for its host in the pod's file
        agreements: local rank 0 of a world (``launch.local_rank``, which
        the launcher sets on every rank it starts), or the one process of
        a run without a world."""
        if self.mesh is None or self.mesh.size == 1:
            return True
        from ddl_tpu_torch import launch

        return launch.local_rank() == 0

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
        self._rebuild_step_fns()

    def _note_io_retry(self, exc: BaseException, attempt: int) -> None:
        """Data-loader retry callback: count transient-I/O retries into
        the obs event stream so a degrading NAS is visible before it
        becomes an outage."""
        self.io_retries = getattr(self, "io_retries", 0) + 1
        if self.obs is not None:
            self.obs.writer.emit("io_retry", error=str(exc), attempt=attempt)

    def _init_obs(self, log_dir, job_id: str, family: str, host: int | None = None) -> None:
        """The event stream (``obs/events.py``), one file per ``host``
        (default ``launch.host_id``); no-op without a log dir, so the obs
        story tracks the CSV one."""
        if log_dir:
            from ddl_tpu_torch.obs import StepTrace

            self.obs = StepTrace.create(log_dir, job_id, family, host=host,
                                        device=self.device)

    def _emit_snapshot_restore(self, dur: float, epoch, period: int, offset: int = 0) -> None:
        """One ``snapshot_restore`` event per startup restore: how long it
        took and the resume cursor the restored state represents.  The
        in-loop rollback emits ``rollback`` instead."""
        if self.obs is None:
            return
        self.obs.writer.emit("snapshot_restore", dur=dur, epoch=epoch,
                             period=int(period), offset=int(offset))
        # the restored state is the startup-resident memory: account it
        # before the first period's sample
        self._emit_hbm_sample(context="restore")

    def _emit_pipe_schedule(self, schedule: str, pipe: int, microbatches: int) -> None:
        """One ``pipe_schedule`` event per run when pipeline parallelism is
        active: the schedule's identity and the modeled per-stage F/B/W/
        idle accounting (``obs/schedule_model.py``; the JAX event's fields,
        ``virtual`` always 1: the port's schedules have no virtual
        stages).  The schedule is static for the whole run, so one event
        suffices."""
        if self.obs is None or pipe <= 1:
            return
        from ddl_tpu_torch.obs.schedule_model import schedule_summary

        summ = schedule_summary(schedule, pipe, microbatches)
        self.obs.writer.emit(
            "pipe_schedule", schedule=schedule, pipe=pipe, microbatches=microbatches,
            virtual=1, makespan=summ["makespan"], idle_units=summ["idle_units"],
            bubble_fraction=summ["bubble_fraction"], per_stage=summ["per_stage"],
        )

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
            if self.is_logging_process:
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
            if self.mesh is not None:
                self.mesh.barrier()
        except Exception as exc:
            # an allocation failure: the memory snapshot (resident tensors
            # and the plans that predicted them) goes into the event stream
            # before the process dies, the memory analogue of the
            # watchdog's stack dump
            if obs is not None:
                from ddl_tpu_torch.obs import hbm

                if hbm.is_oom_error(exc):
                    hbm.dump_oom(obs.writer, exc, params_bytes=self.param_hbm_bytes(),
                                 opt_bytes=self.opt_state_hbm_bytes(), device=self.device)
            raise
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
            opt_bytes = self.opt_state_hbm_bytes()
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
                    if self.is_logging_process:  # the ranks' metrics are equal
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
                    if self.is_logging_process:
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
                # one live per-category breakdown a period beside the period
                # event's bare watermark
                self._emit_hbm_sample(step=idx)
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
        rank = "" if self.mesh is None or self.mesh.size == 1 else f"-h{self.mesh.rank:03d}"
        trace = os.path.join(self.profile_dir, f"{self.job_id}{rank}-trace.json")
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
