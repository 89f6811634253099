"""Preemption detection: turn SIGTERM into a clean checkpoint-and-exit
(own copy of ``ddl_tpu/utils/preemption.py``).

The reference has no failure or preemption handling at all (SURVEY.md §5):
a Kubernetes eviction kills the pod and recovery is a manual re-submit with
``snapshot_job_id``/``snapshot_epoch`` (``ddp.py:109-110``).  Schedulers and
preemptible/spot VMs deliver SIGTERM with a grace window before the kill;
this guard catches it, the trainer finishes the in-flight step, writes a
snapshot, and exits cleanly — the relaunched job resumes from it.
SIGINT gets the same treatment: an operator's Ctrl-C on a dev run should
leave a resumable snapshot, not a KeyboardInterrupt traceback mid-write.

Signal handlers can only be installed from the main thread
(``signal.signal`` raises ValueError elsewhere); when a trainer runs on
a worker thread (notebook executors, test harnesses), the guard degrades
to a cooperative no-op — ``request()``/``requested`` still work — with a
warning, instead of crashing the thread.
"""

from __future__ import annotations

import signal
import threading
import warnings

__all__ = ["PreemptionGuard"]


class PreemptionGuard:
    """Context manager: while active, the given signals set a flag instead
    of killing the process.  Poll ``requested`` at step/epoch boundaries."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)) -> None:
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._previous: dict[int, object] = {}
        self._sigint_seen = False
        self.installed = False

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def request(self) -> None:
        """Mark preemption as requested (what the signal handler does);
        public so tests and cooperative shutdown paths can trigger it."""
        self._event.set()

    def _handler(self, signum, frame) -> None:
        if signum == signal.SIGINT:
            # track Ctrl-C on its own flag — a SIGTERM (or cooperative
            # request()) must not turn the operator's FIRST Ctrl-C into
            # a KeyboardInterrupt that aborts the in-flight preemption
            # snapshot
            if self._sigint_seen:
                # second Ctrl-C: the operator means it — a wedged main
                # thread never polls the cooperative flag, so give them
                # the standard interrupt instead of an unkillable process
                raise KeyboardInterrupt
            self._sigint_seen = True
        self._event.set()

    def __enter__(self) -> "PreemptionGuard":
        try:
            for sig in self._signals:
                self._previous[sig] = signal.signal(sig, self._handler)
            self.installed = True
        except ValueError:
            # not the main thread: restore anything partially installed
            # (only possible if we ARE the main thread mid-loop, so this
            # rollback is itself safe) and run cooperatively unguarded
            for sig, prev in self._previous.items():
                signal.signal(sig, prev)
            self._previous.clear()
            self.installed = False
            warnings.warn(
                "PreemptionGuard: signal handlers can only be installed "
                "from the main thread; running without OS-signal "
                "preemption detection (cooperative request() still works)",
                stacklevel=2,
            )
        return self

    def __exit__(self, *exc) -> None:
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()
        self.installed = False
        return None
