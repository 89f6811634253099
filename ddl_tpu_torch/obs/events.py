"""Structured JSONL event/span writer (own copy of ``ddl_tpu/obs/events.py``,
same file layout and JSON schema, so the JAX package's ``read_events`` and
its ``obs`` tools read the port's streams).

One file per host at ``<log_dir>/by_job_id/<job_id>/events-h<host>.jsonl``
— beside the reference-schema metric CSVs, so a run directory carries
both views of the same run.  Every line is one JSON object with a fixed
envelope:

    ts    wall-clock unix seconds (cross-host alignment, NTP precision)
    mono  monotonic seconds (exact ordering/durations within a host)
    run   run id — one per trainer/process launch (DDL_RUN_ID or random)
    host  process index (DDL_HOST_ID / DDL_PROCESS_ID, else 0)
    step  step/period context, or null
    kind  event kind ("span", "period", "heartbeat", "stall", ...)

plus kind-specific fields.  Spans add ``name``/``dur`` and record their
nesting (``parent``/``depth``) from a per-thread span stack.  Writes are
line-buffered and flushed per event — a hung or SIGKILLed job keeps
everything up to its last completed event, which is the point (the
watchdog's stall dump must survive the death it predicts).
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
import warnings
from contextlib import contextmanager
from pathlib import Path

__all__ = [
    "ANOMALY_TYPES",
    "EVENT_KINDS",
    "EventWriter",
    "events_path",
    "host_id",
    "read_events",
]

# The kinds the port emits, each under the JAX package's name (its
# registry, ``ddl_tpu/obs/events.py``, lists them with the rest).  The JAX
# package's other training kinds: ``compile_cache`` (XLA's persistent
# cache: not ported) and ``profile_capture`` (ROADMAP item 13).
EVENT_KINDS = (
    # events.py / steptrace.py envelope
    "span", "run_start", "run_end", "period",
    # watchdog.py liveness
    "heartbeat", "stall", "watchdog_exit",
    # anomaly.py detectors + loop recovery
    "anomaly", "rollback",
    # loop.py data-path retries
    "io_retry",
    # snapshot restore at trainer startup: dur + the resume cursor
    # (period/offset) the restored state represents
    "snapshot_restore",
    # relaunch-decision -> first-step wall time (DDL_RELAUNCH_TS)
    "restart_latency",
    # supervisor.py single-host relaunch decisions (train --supervise)
    "supervisor_start", "supervisor_relaunch", "supervisor_done",
    # pod-level coordinated recovery (coord.py + PodSupervisor): barriers,
    # stale and lost peers (the elastic eviction), the agreed restart
    # epochs, and the elastic scale-up's join request and leader decision
    "coord_barrier", "peer_stale", "peer_lost", "pod_restart",
    "join_request", "peer_join",
    # one per pipelined run: the schedule and its modeled per-stage
    # F/B/W/idle accounting (train/loop.BaseTrainer._emit_pipe_schedule)
    "pipe_schedule",
    # serving (serve/engine.py, serve/admission.py, infer/decode.py with
    # obs): one "decode" per request (latency, queue delay, TTFT, tokens/s:
    # obs/serving.py's percentiles), the engine's admission, shedding,
    # retirement, pool, prefix-cache and copy-on-write events, the drain
    # and the resume of parked requests, and the per-request causal trace
    "decode", "serve_admit", "serve_shed", "serve_retire", "kv_pool_stats",
    "prefix_hit", "prefix_insert", "kv_cow_copy", "serve_drain", "serve_resume",
    "trace_span", "trace_mark",
    # HBM ledger (obs/hbm.py): hbm_plan is a per-program budget taken over
    # the program's first dispatch; hbm_sample is the live per-category
    # breakdown against the device watermark; hbm_oom_dump is the
    # allocation-failure snapshot (resident tensors + the plans that
    # predicted them) emitted before the process dies
    "hbm_plan", "hbm_sample", "hbm_oom_dump",
)

# ``type`` values carried by "anomaly" events (AnomalyMonitor.record and
# the rolling detectors in obs/anomaly.py).
ANOMALY_TYPES = (
    "loss_spike", "throughput_regression", "hbm_growth", "nonfinite_loss",
)

_warned_kinds: set[str] = set()


def events_path(log_dir: str | os.PathLike, job_id: str, host: int = 0) -> Path:
    return Path(log_dir) / "by_job_id" / job_id / f"events-h{host:03d}.jsonl"


def host_id() -> int:
    """This process's host index for telemetry: the launcher env
    (``DDL_HOST_ID``, falling back to ``DDL_PROCESS_ID``, the rank the
    port's launcher gives each process), else 0.  Set-but-empty variables
    count as unset."""
    env = os.environ.get("DDL_HOST_ID") or os.environ.get("DDL_PROCESS_ID")
    return int(env) if env else 0


class EventWriter:
    """Append JSON event lines; thread-safe (the watchdog thread emits
    through the same writer as the training loop)."""

    def __init__(
        self,
        log_dir: str | os.PathLike,
        job_id: str,
        host: int | None = None,
        run_id: str | None = None,
    ) -> None:
        self.job_id = job_id
        self.host = host_id() if host is None else int(host)
        self.run_id = run_id or os.environ.get("DDL_RUN_ID") or uuid.uuid4().hex[:12]
        # pod restart epoch (DDL_RESTART_EPOCH): stamped into every event
        # so telemetry attributes cleanly to an incarnation; omitted
        # entirely when unset
        try:
            self.restart_epoch = int(os.environ.get("DDL_RESTART_EPOCH") or 0)
        except ValueError:
            self.restart_epoch = 0
        self.path = events_path(log_dir, job_id, self.host)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self._file = open(self.path, "a", buffering=1)
        self._spans = threading.local()  # per-thread open-span name stack

    def emit(self, kind: str, step: int | None = None, **fields) -> dict:
        if kind not in EVENT_KINDS and kind not in _warned_kinds:
            # warn (once per kind), don't drop: ad-hoc kinds in probes and
            # tests still flow
            _warned_kinds.add(kind)
            warnings.warn(
                f"obs event kind {kind!r} is not registered in "
                "ddl_tpu_torch.obs.events.EVENT_KINDS; consumers matching by "
                "name will not see it",
                stacklevel=2,
            )
        event = {
            "ts": time.time(),
            "mono": time.monotonic(),
            "run": self.run_id,
            "host": self.host,
            "step": step,
            "kind": kind,
            **({"repoch": self.restart_epoch} if self.restart_epoch else {}),
            **fields,
        }
        line = json.dumps(event, default=_jsonable)
        with self._lock:
            if self._file.closed:  # e.g. a second train() after finish()
                self._file = open(self.path, "a", buffering=1)
            self._file.write(line + "\n")
            self._file.flush()
        return event

    @contextmanager
    def span(self, name: str, step: int | None = None, **fields):
        """Time a region and emit one ``span`` event on exit, recording
        its parent/depth from this thread's open-span stack."""
        stack = getattr(self._spans, "stack", None)
        if stack is None:
            stack = self._spans.stack = []
        parent = stack[-1] if stack else None
        stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dur = time.perf_counter() - t0
            stack.pop()
            self.emit(
                "span", step=step, name=name, dur=dur,
                parent=parent, depth=len(stack), **fields,
            )

    def close(self) -> None:
        with self._lock:
            if not self._file.closed:
                self._file.close()


def _jsonable(x):
    """Fallback encoder: numpy scalars and anything else stringifiable."""
    try:
        return float(x)
    except (TypeError, ValueError):
        return str(x)


def read_events(path: str | os.PathLike) -> list[dict]:
    """Parse one event file; tolerates a torn final line (the writer may
    have died mid-write — everything before it is still valid)."""
    events = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    except FileNotFoundError:
        pass
    return events
