"""Per-step phase attribution for the shared training loop (port of
``ddl_tpu/obs/steptrace.py``).

Splits each step/period of a run into a fixed phase vocabulary —

    data_wait    host-side batch production (the loader)
    h2d          host-to-device copy
    step         dispatch of the train step
    fence        blocking on device completion / metric fetch
    eval         period-boundary evaluation
    checkpoint   snapshot writes
    logging      console + CSV emission

— as ``span`` events (``obs/events.py``), accumulated per period and
emitted as one ``period`` event carrying the phase-total breakdown,
throughput and the device-memory watermark (``utils/memory.hbm_stats``).
CUDA launches are asynchronous, so ``step`` measures *dispatch* and the
device time it hides surfaces in ``fence``: the loop adds no
synchronisation per step for its spans.

Differences from the JAX package: the ``compiles``/``compile_s`` fields
of the period event count XLA backend compiles there; the port compiles
nothing per step (its kernels are built once, before the run), so they
stay 0.  The profile-on-anomaly capturer (``obs/profiler.py``) is ROADMAP
item 13, so an anomaly arms no trace window.

``AnomalyMonitor`` rides along: every ``end_period`` feeds the rolling
detectors, and ``finish()`` surfaces everything they caught.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager

from ddl_tpu_torch.obs.anomaly import AnomalyMonitor
from ddl_tpu_torch.obs.events import EventWriter
from ddl_tpu_torch.utils.memory import hbm_stats

__all__ = ["PER_STEP_PHASES", "PHASES", "StepTrace"]

PHASES = (
    "data_wait",
    "h2d",
    "step",
    "fence",
    "eval",
    "checkpoint",
    "logging",
)

# Phases that occur once per TRAINING STEP — the only ones the 1-in-N
# span sampler thins.  eval/checkpoint/logging fire once per period
# boundary, so they always emit.
PER_STEP_PHASES = frozenset({"data_wait", "h2d", "step", "fence"})

_relaunch_consumed = False


def _consume_relaunch_ts() -> float | None:
    """DDL_RELAUNCH_TS, handed out at most once per process (the first
    StepTrace built after a relaunch owns the measurement)."""
    global _relaunch_consumed
    if _relaunch_consumed:
        return None
    raw = os.environ.get("DDL_RELAUNCH_TS")
    if not raw:
        return None
    _relaunch_consumed = True
    try:
        return float(raw)
    except ValueError:
        return None


class StepTrace:
    """The object a trainer threads through its loop.

    ``phase(name)`` is the single instrumentation primitive: a context
    manager that times the region, emits a ``span`` event, adds the
    duration to the current period's totals, and beats the watchdog
    (when one is attached) so the stall deadline bounds a phase, not a
    whole period.  ``device`` is the device whose memory the period
    events report.
    """

    def __init__(
        self,
        writer: EventWriter,
        anomaly: AnomalyMonitor | None = None,
        emit_step_spans: bool | int = True,
        device=None,
    ) -> None:
        self.writer = writer
        self.anomaly = anomaly if anomaly is not None else AnomalyMonitor(writer)
        # span emission policy: False/0 = no per-step spans, True/1 =
        # every step, N > 1 = a 1-in-N sampler (steps where step % N == 0
        # emit their phase spans).  Period events always flow.
        self.emit_step_spans = int(emit_step_spans)
        self.device = device
        self.watchdog = None
        self._period = None
        self._totals: dict[str, float] = defaultdict(float)
        self.run_totals: dict[str, float] = defaultdict(float)
        self._needs_run_start = False  # set by finish() for train() reuse
        # restart-latency origin: the relauncher's decision wall clock
        # (DDL_RELAUNCH_TS).  The first completed "step" phase of this
        # process emits one `restart_latency` event against it.
        self._relaunch_ts = _consume_relaunch_ts()

    @classmethod
    def create(
        cls,
        log_dir,
        job_id: str,
        family: str,
        host: int | None = None,
        emit_step_spans: bool | int | None = None,
        device=None,
        **writer_kwargs,
    ) -> "StepTrace":
        """One-line trainer wiring: build the writer, emit ``run_start``.

        ``emit_step_spans=None`` reads the ``DDL_OBS_STEP_SPANS`` env var
        — ``0``/``false`` disables per-step spans, an integer ``N`` samples
        1-in-N steps; period events keep flowing either way."""
        if emit_step_spans is None:
            env = os.environ.get("DDL_OBS_STEP_SPANS", "").lower()
            if env in ("0", "false", "off"):
                emit_step_spans = 0
            elif env.isdigit():
                emit_step_spans = int(env)
            else:
                emit_step_spans = 1
        writer = EventWriter(log_dir, job_id, host=host, **writer_kwargs)
        writer.emit("run_start", family=family, job_id=job_id)
        return cls(writer, emit_step_spans=emit_step_spans, device=device)

    def _span_due(self, name: str, step: int | None) -> bool:
        """The 1-in-N step-span sampler.  Only per-step phases are
        thinned; period-boundary phases follow the all-or-nothing
        setting regardless of their step tag."""
        n = self.emit_step_spans
        if n <= 0:
            return False
        if n == 1 or step is None or name not in PER_STEP_PHASES:
            return True
        return step % n == 0

    @contextmanager
    def phase(self, name: str, step: int | None = None, **fields):
        t0 = time.perf_counter()
        completed = False
        try:
            if self._span_due(name, step):
                with self.writer.span(name, step=step, period=self._period, **fields):
                    yield
            else:
                yield
            completed = True
        finally:
            dur = time.perf_counter() - t0
            self._totals[name] += dur
            self.run_totals[name] += dur
            if completed and name == "step" and self._relaunch_ts is not None:
                # first COMPLETED step after a relaunch: stamp decision ->
                # first-step wall time, once
                latency = time.time() - self._relaunch_ts
                origin, self._relaunch_ts = self._relaunch_ts, None
                self.writer.emit(
                    "restart_latency", step=step, latency=latency, decision_ts=origin,
                )
            if self.watchdog is not None:
                self.watchdog.beat(step)

    def begin_period(self, period: int) -> None:
        if self._needs_run_start:
            # a second train() on the same trainer: mark the new segment
            self.writer.emit("run_start", resumed=True)
            self._needs_run_start = False
        self._period = period
        self._totals = defaultdict(float)
        if self.watchdog is not None:
            self.watchdog.beat()

    def end_period(
        self,
        period: int,
        idx: int,
        elapsed: float,
        steps: int,
        metrics: dict | None = None,
        rates: dict | None = None,
        offset: int = 0,
    ) -> dict:
        """Emit the per-period summary event and feed the anomaly
        detectors; returns the phase-total dict.  ``offset`` is the batch
        offset this period's data stream STARTED at (nonzero only for the
        first period after an exact mid-period resume)."""
        phases = dict(self._totals)
        mem = hbm_stats(self.device) if self.device is not None else None
        loss = None
        if metrics:
            raw = metrics.get("loss")
            loss = float(raw) if raw is not None else None
        steps_per_sec = steps / elapsed if elapsed > 0 else 0.0
        self.writer.emit(
            "period",
            step=idx,
            period=period,
            steps=steps,
            offset=offset,
            elapsed=elapsed,
            steps_per_sec=steps_per_sec,
            phases=phases,
            loss=loss,
            compiles=0,
            compile_s=0.0,
            hbm_bytes_in_use=mem["bytes_in_use"] if mem else None,
            hbm_peak_bytes=mem["peak_bytes_in_use"] if mem else None,
            **({"rates": dict(rates)} if rates else {}),
        )
        self.anomaly.observe_period(
            idx,
            loss=loss,
            steps_per_sec=steps_per_sec,
            hbm_bytes=mem["bytes_in_use"] if mem else None,
        )
        self._period = None
        return phases

    def finish(self, verbose: bool = True) -> list[dict]:
        """End-of-run: emit ``run_end`` with the whole-run phase totals
        and anomaly count, print what the detectors caught, close the
        stream.  Returns the anomaly list."""
        anomalies = self.anomaly.anomalies
        self.writer.emit(
            "run_end",
            phases=dict(self.run_totals),
            anomalies=len(anomalies),
            stalls=self.watchdog.stalls if self.watchdog else 0,
        )
        if verbose and anomalies:
            print(f"[obs] {len(anomalies)} anomalies detected this run:")
            for line in self.anomaly.summary_lines():
                print(f"[obs]   {line}")
        self.writer.close()
        # reset per-run state so a second train() on the same trainer
        # reports its own segment, not cumulative double-counted totals
        self.run_totals = defaultdict(float)
        self.anomaly = AnomalyMonitor(self.writer)
        self._needs_run_start = True
        return anomalies
