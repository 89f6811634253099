"""The LM trainer: the transformer LM on the shared period loop
(counterpart of ``ddl_tpu/train/lm_trainer.py``, one device).

The LM is step-based, not epoch-based, so a loop *period* is a step
window ending at the next cadence boundary -- the union of the logging,
eval and (with a checkpoint directory) snapshot cadences' multiples -- so
each cadence fires exactly at its own multiples (coprime cadences do not
collapse the window to one step).  The CSV 'epoch' column carries the
global step at the period's end; per-window walls log as ``window_time``
while ``epoch_time`` keeps its whole-run meaning (one row at the end of
``train``).

Data: the synthetic Markov byte stream (``data/synthetic_lm``, batch
``step`` drawn from ``default_rng(1000 + step)``) or a token corpus
(``data/lm_corpus``: memmapped windows, a held-out tail for
``val_loss``/``val_ppl``), one process.  Either stream is pure in the
global step, so the step is the exact-resume cursor.

Snapshots (``checkpoint.py``, synchronous as in the JAX trainer) hold the
model's ``state_dict``, the ``Optimizer.state_dict()`` and the step, and
are labelled with the true optimizer step (a preemption can end a window
early).  The manifest's cursor records the step and, on a corpus, the
shuffle position (``TokenBatches.cursor_state``), which a resume or a
rollback re-anchors (``_anchor_shuffle``).  A run resumes from
``resume_step`` or by itself from its job id's newest valid snapshot; a
restore loads in place, so the optimizer keeps pointing at the live
parameters.  ``nan_policy="recover"`` rolls back to the newest valid
snapshot with a reduced-LR grace window (``Optimizer.update_scale``);
SIGTERM leaves a snapshot; the event stream and the profiler hook are the
loop's.  Snapshots are gated on ``save_every`` and on held-out perplexity
improvements, and pruned to ``keep_snapshots``.

MoE runs anneal the capacity factor once (``_maybe_anneal_capacity``): the
running model's ``MoeMlp``s take ``capacity_factor_min`` when the live
``moe_drop_frac`` falls to ``capacity_anneal_drop`` or the step reaches
``capacity_anneal_step``.  A resumed run starts from the configured
capacity and anneals by the same rule, as the JAX trainer, which builds
its config afresh, does.

Not here (the ROADMAP items that bring them): the HBM ledger events
(item 9), a resume across pipeline layouts and the pipeline-schedule
event (item 11: the port has no pipe axis, so a snapshot always has the
one-device layout), and MFU in ``rate_metrics`` (item 13).
"""

from __future__ import annotations

import bisect
import dataclasses
import math
import os
from time import perf_counter

import numpy as np
import torch

from ddl_tpu_torch import checkpoint as ckpt
from ddl_tpu_torch.models.transformer import LMConfig, set_capacity_factor
from ddl_tpu_torch.parallel.sharding import LMMeshSpec
from ddl_tpu_torch.train.lm_steps import make_lm_step_fns
from ddl_tpu_torch.train.loop import BaseTrainer, _phase
from ddl_tpu_torch.train.recovery import make_policy
from ddl_tpu_torch.utils import MetricLogger, faultinject

__all__ = ["LMRunConfig", "LMTrainer"]


@dataclasses.dataclass
class LMRunConfig:
    """Run-level settings for the LM family: the JAX ``LMRunConfig``'s
    fields and defaults (the notes on each are there)."""

    batch: int = 16
    seq_len: int = 256
    steps: int = 100
    num_microbatches: int = 0
    accum_steps: int = 1
    pipeline_schedule: str = "gpipe"
    virtual_stages: int = 1
    zero_sharding: bool = False
    # token corpus path (.npy or raw text, encoded on first use) or None
    # for the synthetic Markov-chain byte stream
    corpus: str | None = None
    eval_every: int = 0  # held-out eval cadence in steps (0 = off)
    eval_frac: float = 0.05  # tail fraction of corpus windows held out
    checkpoint_dir: str | None = None
    save_every: int = 50
    keep_snapshots: int = 0
    resume_step: int | None = None
    auto_resume: bool = True
    job_id: str = "lm"
    log_dir: str | None = "training_logs"
    log_every: int = 10  # console/CSV cadence in steps
    halt_on_nan: bool = True
    nan_policy: str = "halt"
    nan_max_consecutive: int = 3
    nan_grace_scale: float = 0.1
    nan_grace_periods: int = 2
    preemption_save: bool = True
    profile_dir: str | None = None


class LMTrainer(BaseTrainer):
    period_label = "window"
    time_metric = "window_time"  # epoch_time logs once, as whole-run wall
    best_metric = "val_ppl"
    best_mode = "min"
    best_label = "PPL"

    def __init__(self, cfg: LMConfig, spec: LMMeshSpec, tx, run: LMRunConfig, seed: int = 0,
                 device=None) -> None:
        self.cfg, self.run = cfg, run
        self.job_id = run.job_id
        self.fns = make_lm_step_fns(
            cfg, spec, tx, seed, run.batch, run.seq_len, device=device,
            num_microbatches=run.num_microbatches, accum_steps=run.accum_steps,
            pipeline_schedule=run.pipeline_schedule, virtual_stages=run.virtual_stages,
            zero_sharding=run.zero_sharding,
        )
        self.device = self.fns.device

        # periods end at the union of the cadences' multiples, so each
        # cadence fires exactly at its own multiples (log 10 / eval 4 ->
        # boundaries 4, 8, 10, 12, ...)
        if run.log_every < 1:
            raise ValueError(f"log_every must be >= 1, got {run.log_every}")
        cadences = [run.log_every]
        if run.eval_every:
            cadences.append(run.eval_every)
        if run.checkpoint_dir and run.save_every:
            cadences.append(run.save_every)
        bounds = {run.steps}
        for c in cadences:
            bounds.update(range(c, run.steps + 1, c))
        self._boundaries = sorted(bounds)
        self.num_periods = len(self._boundaries)

        self._build_data()
        self.logger = MetricLogger(run.log_dir, run.job_id) if run.log_dir else None
        self._init_obs(run.log_dir, run.job_id, "lm")
        self.halt_on_nan = run.halt_on_nan
        self.recovery = make_policy(run)
        self.keep_snapshots = run.keep_snapshots
        self.preemption_save = run.preemption_save
        self.profile_dir = run.profile_dir
        self.save_best = bool(run.checkpoint_dir) and bool(run.eval_every)
        self.best_value = float("inf")

        self.state = self.fns.init_state()
        self._start_step = 0
        resume_step = ckpt.resolve_resume(run.checkpoint_dir, run.job_id, run.resume_step,
                                          run.auto_resume, unit="step")
        restore_dur = None
        if run.checkpoint_dir and resume_step is not None:
            t0 = perf_counter()
            ckpt.run_resume_load(
                lambda: self._resume(resume_step),
                auto=run.resume_step is None,
                desc=f"job {run.job_id!r} step {resume_step}",
                hint="pass --fresh (auto_resume=False)",
            )
            restore_dur = perf_counter() - t0
        # first period whose boundary lies beyond the resume step
        self.periods_run = bisect.bisect_right(self._boundaries, self._start_step)
        if restore_dur is not None:
            # the steps of the resume window the snapshot already covers
            # (the mid-period cursor's analog): stamped into that window's
            # period event; _period_bounds resumes by _start_step
            window_start = self._boundaries[self.periods_run - 1] if self.periods_run else 0
            self._resume_offset = max(0, self._start_step - window_start)
            self._emit_snapshot_restore(restore_dur, resume_step, self.periods_run,
                                        self._resume_offset)

    # --------------------------------------------------------- snapshots

    def snapshot_state(self) -> dict:
        """What a snapshot holds: the live tensors (a save copies them)
        and the optimizer step."""
        return {"model": self.state.model.state_dict(),
                "optimizer": self.state.optimizer.state_dict(), "step": self.state.step}

    def load_state(self, state: dict) -> None:
        """Restore a snapshot state in place: the model's tensors and the
        optimizer's state, which keeps pointing at the parameters."""
        self.state.model.load_state_dict(state["model"])
        self.state.optimizer.load_state_dict(state["optimizer"])
        self.state.step = self._start_step = int(state["step"])

    def _restore(self, step: int, verify: bool) -> None:
        run = self.run
        state, _ = ckpt.load_snapshot(run.checkpoint_dir, run.job_id, step,
                                      map_location=self.device, verify=verify)
        self.load_state(state)
        self._anchor_shuffle(step)

    def _resume(self, resume_step: int) -> None:
        # an auto-discovered step was verified by resolve_resume moments
        # ago; only an explicit resume_step verifies again
        self._restore(resume_step, verify=self.run.resume_step is not None)
        print(f"resumed from step {resume_step}; continuing from step {self._start_step}")

    def _anchor_shuffle(self, snap_step: int) -> None:
        """Re-anchor the corpus shuffle at the restored snapshot's cursor:
        the persisted (shuffle_epoch, epoch_pos) pins the epoch reshuffle
        trajectory across restarts.  A cursor without them anchors
        nothing."""
        if self._batches is None:
            return
        cur = ckpt.read_cursor(self.run.checkpoint_dir, self.run.job_id, snap_step)
        if cur and "shuffle_epoch" in cur:
            self._batches.anchor_resume(snap_step, cur["shuffle_epoch"], cur.get("epoch_pos", 0))

    def _snapshot_store(self):
        run = self.run
        return (run.checkpoint_dir, run.job_id) if run.checkpoint_dir else None

    def _rollback_restore(self, step: int) -> None:
        self._restore(step, verify=False)
        self.periods_run = bisect.bisect_right(self._boundaries, self._start_step)

    def _scale_updates(self, scale: float) -> None:
        self.state.optimizer.update_scale = scale

    def snapshot_due(self, period: int) -> bool:
        if not self.run.checkpoint_dir or not self.run.save_every:
            return False
        return self._period_bounds(period)[1] % self.run.save_every == 0

    def save_snapshot(self, period: int) -> None:
        # labelled with the true optimizer step (a preemption can end a
        # window early), so resume_step and the data stream line up; the
        # stream is pure in the step, so the step is the cursor, and the
        # corpus's shuffle position rides along
        step = self.state.step
        cursor = dict(self.data_cursor or {}, step=step)
        if self._batches is not None:
            cursor.update(self._batches.cursor_state(step))
        path = ckpt.save_snapshot(self.run.checkpoint_dir, self.job_id, step,
                                  self.snapshot_state(), cursor=cursor)
        print(f"step {step} | saved snapshot to {path}")

    def last_snapshot_hint(self):
        if not self.run.checkpoint_dir:
            return "none (set checkpoint_dir)"
        return ckpt.latest_epoch(self.run.checkpoint_dir, self.job_id)

    def resume_hint(self, period: int) -> str:
        return f"--job-id {self.job_id} --resume-step {self.state.step}"

    def opt_state_bytes(self) -> int:
        return self.state.optimizer.state_bytes()

    # ------------------------------------------------------------- data

    def _build_data(self) -> None:
        run = self.run
        self._eval_batches = None
        self._batches = None  # the corpus's TokenBatches: the shuffle cursor
        if run.corpus:
            from ddl_tpu_torch.data.lm_corpus import TokenBatches, TokenCorpus, encode_text_file

            path = run.corpus
            if not path.endswith(".npy"):
                npy = path + ".npy"
                if not os.path.exists(npy) or os.path.getmtime(npy) < os.path.getmtime(path):
                    encode_text_file(path, npy)
                path = npy
            corpus = TokenCorpus(path, run.seq_len)
            if corpus.max_token() >= self.cfg.vocab_size:
                raise ValueError(
                    f"corpus has token id {corpus.max_token()} but the model's vocab_size "
                    f"is {self.cfg.vocab_size}; out-of-range ids would index past the "
                    "embedding table"
                )
            train_view, eval_view = corpus, None
            if run.eval_every:
                train_view, ev = corpus.split(run.eval_frac)
                if len(ev) >= run.batch:
                    eval_view = ev
                else:
                    print(
                        f"note: eval split ({len(ev)} windows) smaller than one batch of "
                        f"{run.batch}; held-out eval disabled -- grow eval_frac or shrink batch"
                    )
                    train_view = corpus
            batches = self._batches = TokenBatches(train_view, run.batch, seed=0)
            if eval_view is not None:
                self._eval_batches = TokenBatches(eval_view, run.batch, shuffle=False, seed=0)
            print(
                f"corpus: {len(corpus)} windows of {run.seq_len}+1 tokens, "
                f"{len(batches)} train batches/epoch"
                + (f", {len(self._eval_batches)} eval batches" if self._eval_batches else "")
            )

            def sample_batch(step):
                # pure in step: a resumed run continues the stream
                return batches.batch_at(step)

        else:
            from ddl_tpu_torch.data.synthetic_lm import MarkovChain

            if self.cfg.vocab_size < 256:
                raise ValueError(
                    f"synthetic Markov stream emits byte ids 0..255 but vocab_size is "
                    f"{self.cfg.vocab_size}; out-of-range targets corrupt the loss -- use "
                    "vocab_size >= 256 or pass a corpus"
                )
            chain = MarkovChain()

            def sample_batch(step):
                # seeded by step, as the JAX trainer: the same stream there
                seqs = chain.sample(np.random.default_rng(1000 + step), run.batch,
                                    run.seq_len + 1)
                return seqs[:, :-1], seqs[:, 1:]

        self._sample_batch = sample_batch

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True).long()

    # ------------------------------------------------------- loop hooks

    def _period_bounds(self, period: int) -> tuple[int, int]:
        p0 = self._boundaries[period - 1] if period else 0
        return max(p0, self._start_step), self._boundaries[period]

    def run_period(self, period: int, guard=None):
        """The period's steps; the last step's metrics fetched to the host
        once, at the end (the ``fence`` phase).  ``guard`` (a
        ``PreemptionGuard``) stops the window after the in-flight step
        when a preemption signal has arrived."""
        # one-shot: the resume offset describes only the first resumed
        # window (the loop stamps it into that window's period event)
        self.consume_resume_offset()
        p0, p1 = self._period_bounds(period)
        metrics, m, steps = {}, None, 0
        for i in range(p0, p1):
            # data_wait covers the batch's making and its copy to the
            # device; step is the dispatch, whose device time surfaces in
            # the window-end fence
            with _phase(self.obs, "data_wait", step=i):
                inp, tgt = self._sample_batch(i)
                inp, tgt = self._to_device(inp), self._to_device(tgt)
            with _phase(self.obs, "step", step=i):
                self.state, m = self.fns.train(self.state, inp, tgt)
            steps += 1
            faultinject.check_step(i, guard)
            if guard is not None and guard.requested:
                break
        if steps:
            with _phase(self.obs, "fence", step=p0 + steps - 1):
                metrics = {k: float(v) for k, v in m.items()}
            self._maybe_anneal_capacity(metrics)
        return metrics, steps

    def _maybe_anneal_capacity(self, m: dict) -> None:
        """The post-warm-up MoE capacity anneal: once the period's
        ``moe_drop_frac`` is at or under ``cfg.capacity_anneal_drop`` (or
        the step reaches ``capacity_anneal_step``, when set), the running
        model's capacity factor drops to ``capacity_factor_min``; the
        weights and the optimizer state do not depend on it and carry
        over."""
        cfg = self.cfg
        if not cfg.num_experts:
            return
        target = min(cfg.capacity_factor_min, cfg.capacity_factor)
        if cfg.capacity_factor <= target:
            return
        step = self.state.step
        drop = m.get("moe_drop_frac")
        by_metric = drop is not None and drop <= cfg.capacity_anneal_drop
        by_step = cfg.capacity_anneal_step and step >= cfg.capacity_anneal_step
        if not (by_metric or by_step):
            return
        reason = (f"router drop_frac {drop:.4f} <= {cfg.capacity_anneal_drop}" if by_metric
                  else f"step {step} >= capacity_anneal_step {cfg.capacity_anneal_step}")
        self.cfg = dataclasses.replace(cfg, capacity_factor=target)
        set_capacity_factor(self.state.model, target)
        print(f"step {step:4d} | capacity anneal: {reason} — capacity_factor "
              f"{cfg.capacity_factor} -> {target}")

    def log_index(self, period: int) -> int:
        return self._period_bounds(period)[1]

    def log_due(self, period: int) -> bool:
        # log only at log_every multiples (and the final step), so eval
        # and snapshot boundaries don't densify the CSV/console cadence
        p1 = self._period_bounds(period)[1]
        return p1 % self.run.log_every == 0 or p1 == self.run.steps

    def format_train_line(self, period, elapsed, steps, m) -> str:
        _, p1 = self._period_bounds(period)
        body = " ".join(f"{k} {v:.4f}" for k, v in m.items())
        return f"step {p1 - 1:4d} {body} ({steps / elapsed:.2f} steps/s)"

    def format_eval_line(self, period, m) -> str:
        return f"  heldout: ce {m['val_loss']:.4f} ppl {m['val_ppl']:.2f}"

    def rate_metrics(self, steps: int, elapsed: float) -> dict:
        # MFU waits for the port of bench/mfu.py (ROADMAP item 13)
        return {"tokens_per_sec": (steps / elapsed) * self.run.batch * self.run.seq_len}

    def evaluate_period(self, period: int) -> dict | None:
        """Held-out ``val_loss`` (the mean of the eval batches' CE) and
        ``val_ppl`` at ``eval_every`` multiples, with a corpus."""
        run = self.run
        p1 = self._period_bounds(period)[1]
        if self._eval_batches is None or not run.eval_every or p1 % run.eval_every:
            return None
        ces = [self.fns.evaluate(self.state, self._to_device(inp), self._to_device(tgt))["ce"]
               for inp, tgt in self._eval_batches]
        ce = float(np.mean([float(c) for c in ces]))
        return {"val_loss": ce, "val_ppl": math.exp(ce)}

    # --------------------------------------------------------------- run

    def train(self, max_periods: int | None = None, guard=None) -> None:
        if self.run.checkpoint_dir is None and self.preemption_save:
            # nothing to save into: a guard would catch SIGTERM and then
            # fail in save_snapshot, so the run goes unguarded
            self.preemption_save = False
        t0 = perf_counter()
        super().train(max_periods, guard)
        dt = perf_counter() - t0
        steps_run = self.state.step - self._start_step
        if steps_run:
            print(f"{steps_run} steps in {dt:.1f}s ({steps_run / dt:.2f} steps/s)")
        if self.logger is not None:
            # the whole run as one epoch row, so epoch_time keeps one unit
            # across the families
            self.logger.log("epoch_time", dt, 0)
