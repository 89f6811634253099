"""Per-host liveness heartbeat + hung-step stack dumps (port of
``ddl_tpu/obs/watchdog.py``).

A wedged kernel or a hung host-side wait kills a run *silently*: the
process sits inside a device wait with nothing on stdout.  The watchdog is
a daemon thread that (a) emits ``heartbeat`` events — last completed step,
seconds since — and (b) when no beat arrives within ``deadline_s``, dumps
every Python thread's stack plus the last-completed step as a ``stall``
event *before* the job dies.  In its default ``on_stall="dump"`` mode it
never kills anything itself — the stall may be a one-off (slow storage, a
first kernel build) and the deadline is the operator's call; with
``on_stall="exit"`` (``DDL_WATCHDOG_ACTION=exit``) it escalates to
dump-then-``os._exit(EXIT_PREEMPTED)`` so a relauncher restarts the run
from its last snapshot.

The training loop calls ``beat(step)`` at step granularity (wired through
``StepTrace.phase``), so the deadline bounds one phase, not one period.
The JAX package's pod escalation (announcing the exit to peer hosts
through ``coord``) is ROADMAP item 7, and its profile-on-anomaly capture
of a hung step item 13.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
import warnings

__all__ = ["EXIT_PREEMPTED", "Watchdog", "thread_stacks"]

# The resumable exit code (the JAX package's ``supervisor.EXIT_PREEMPTED``,
# EX_TEMPFAIL): a relauncher restarts the run and it auto-resumes.
EXIT_PREEMPTED = 75


def thread_stacks() -> dict[str, str]:
    """Formatted stacks of every live Python thread, keyed by thread
    name (the caller's marked with ``*``)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    me = threading.get_ident()
    out = {}
    for ident, frame in sys._current_frames().items():
        name = names.get(ident, f"thread-{ident}")
        if ident == me:
            name = f"*{name}"
        out[name] = "".join(traceback.format_stack(frame))
    return out


class Watchdog:
    def __init__(
        self,
        writer,
        deadline_s: float,
        interval_s: float | None = None,
        on_stall: str = "dump",
        exit_fn=None,
    ) -> None:
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        if on_stall not in ("dump", "exit"):
            warnings.warn(
                f"unknown watchdog action {on_stall!r}; using 'dump'",
                stacklevel=2,
            )
            on_stall = "dump"
        # os._exit, not sys.exit, on escalation: the main thread is wedged
        # inside a device wait and will never unwind an exception
        self.on_stall = on_stall
        self._exit_fn = exit_fn
        self.writer = writer
        self.deadline_s = float(deadline_s)
        # poll fast enough that a stall is caught within ~1.25 deadlines
        self.interval_s = (
            float(interval_s) if interval_s is not None
            else max(self.deadline_s / 4.0, 0.01)
        )
        self._lock = threading.Lock()
        self._last_beat = time.monotonic()
        self._last_step: int | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._dumped = False
        self.stalls = 0

    def beat(self, step: int | None = None) -> None:
        with self._lock:
            self._last_beat = time.monotonic()
            if step is not None:
                self._last_step = step

    def start(self) -> "Watchdog":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="ddl-watchdog", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5 * self.interval_s)
            self._thread = None

    __enter__ = start

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            with self._lock:
                age = time.monotonic() - self._last_beat
                step = self._last_step
            self.writer.emit("heartbeat", step=step, age=age)
            if age > self.deadline_s:
                if not self._dumped:
                    # one dump per stall: the stacks won't change while
                    # the process is wedged, and re-arming on recovery
                    # keeps a flaky run from flooding the stream
                    self._dumped = True
                    self.stalls += 1
                    self.writer.emit(
                        "stall",
                        step=step,
                        age=age,
                        deadline=self.deadline_s,
                        action=self.on_stall,
                        stacks=thread_stacks(),
                    )
                    if self.on_stall == "exit":
                        self._escalate(step, age)
            else:
                self._dumped = False

    def _escalate(self, step, age) -> None:
        self.writer.emit(
            "watchdog_exit", step=step, age=age, code=EXIT_PREEMPTED
        )
        print(
            f"[watchdog] no step progress for {age:.1f}s (deadline "
            f"{self.deadline_s:.1f}s); stacks dumped, exiting resumable "
            f"({EXIT_PREEMPTED}) for a relaunch"
        )
        exit_fn = self._exit_fn if self._exit_fn is not None else os._exit
        exit_fn(EXIT_PREEMPTED)
