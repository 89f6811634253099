"""Auto-resume supervisor: relaunch the trainer until the run completes
(the single-host half of ``ddl_tpu/supervisor.py``).

``python -m ddl_tpu_torch.cli train --supervise --max-restarts N ...``
runs the trainer as a child process and relaunches it after a
preemption or a crash.  Resume needs no arguments: the Trainer finds the
newest valid snapshot of its job id by itself (``train.auto_resume``),
so a relaunch is a resume.

Exit-code protocol (how the child tells the supervisor what happened):

    0                run complete: stop
    EXIT_PREEMPTED   resumable interruption: a preemption after its
    (75, EX_TEMPFAIL) snapshot, or the stall watchdog's dump-then-exit.
                     Relaunched at once and not charged to the crash
                     budget; a *streak* of them with no progress in
                     between backs off, and ``max_preemptions`` (default
                     1000) bounds an always-75 loop.
    anything else    a crash: relaunched after exponential backoff with
                     jitter (``utils/backoff.Backoff``), up to
                     ``max_restarts`` crash relaunches.

``Supervisor`` drives any ``attempt_fn(restart_index) -> exit_code``
(tests give it callables and fake clocks); ``supervise_command`` runs a
child process per attempt.  The child gets ``DDL_SUPERVISED=1`` (the CLI
then exits ``EXIT_PREEMPTED`` after a preemption snapshot instead of 0),
``DDL_RESTART_COUNT``, ``DDL_WATCHDOG_ACTION=exit`` unless the caller set
it (a hung step becomes a relaunch), and, on a relaunch,
``DDL_RELAUNCH_TS``: the wall clock of the relaunch decision, against
which the child's first completed step emits ``restart_latency``.

Injected faults (``DDL_FAULT``) are consumed when they fire: the child
records each fired spec in ``DDL_FAULT_STATE`` (``utils/faultinject``),
and a relaunch keeps only the specs that have not fired;
``DDL_FAULT_PERSIST=1`` keeps the whole spec on every attempt.

The supervisor process never touches the card (the child owns it).  Pod
supervision (``PodSupervisor``, ``supervise_pod_command``: restarts of
every host together through a shared-directory rendezvous, elastic
membership) is ROADMAP item 7b; a supervised ``dp`` run on one host
relaunches its whole world (the command line's ranks exit together).
"""

from __future__ import annotations

import collections
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable

from ddl_tpu_torch.utils.backoff import Backoff

__all__ = ["EXIT_PREEMPTED", "EXIT_REJOIN", "Supervisor", "supervise_command"]

# EX_TEMPFAIL from sysexits.h: "temporary failure, retry later", a
# preemption's meaning, and distinct from crash codes (1, 2, 134, 139).
EXIT_PREEMPTED = 75
# An elastic pod's leave-and-return request (ROADMAP item 7b); outside
# elastic pods it is a plain crash.
EXIT_REJOIN = 76


class Supervisor:
    """Run ``attempt_fn`` until it returns 0 or restarts are exhausted.

    ``attempt_fn(restart_index)`` returns the attempt's exit code; an
    exception it raises counts as a crash (exit code 1).  ``sleep``,
    ``clock`` and ``backoff`` are injectable so tests run in virtual time;
    ``events`` is an ``obs.EventWriter`` (or None) that receives the
    lifecycle events.
    """

    def __init__(
        self,
        attempt_fn: Callable[[int], int],
        max_restarts: int = 5,
        max_preemptions: int = 1000,
        backoff: Backoff | None = None,
        sleep: Callable[[float], None] = time.sleep,
        log: Callable[[str], None] = print,
        streak_window_s: float = 60.0,
        clock: Callable[[], float] = time.monotonic,
        events=None,
    ) -> None:
        self.attempt_fn = attempt_fn
        self.events = events
        self.max_restarts = max_restarts
        self.max_preemptions = max_preemptions
        # an attempt that ran at least this long before its resumable exit
        # made progress, and ends the backoff streak
        self.streak_window_s = streak_window_s
        self.clock = clock
        self.backoff = backoff if backoff is not None else Backoff(
            base=1.0, factor=2.0, max_delay=120.0, jitter=0.5
        )
        self.sleep = sleep
        self.log = log
        self.restarts = 0
        self.crashes = 0
        self.preemptions = 0
        # wall clock (time.time(), not the injectable clock: it crosses
        # process boundaries) of the latest relaunch decision
        self.last_relaunch_ts: float | None = None
        # consecutive resumable exits with no crash in between
        self._consec_resumable = 0

    def _emit(self, kind: str, **fields) -> None:
        if self.events is not None:
            self.events.emit(
                kind,
                restarts=self.restarts,
                crashes=self.crashes,
                preemptions=self.preemptions,
                **fields,
            )

    def _relaunch(self, reason: str, rc: int, delay: float) -> None:
        self.last_relaunch_ts = time.time()
        self._emit("supervisor_relaunch", reason=reason, rc=rc, delay=delay,
                   decision_ts=self.last_relaunch_ts)
        if delay > 0:
            self.sleep(delay)

    def _give_up(self, rc: int, why: str) -> int:
        self.log(f"[supervisor] giving up: {why}")
        self._emit("supervisor_done", rc=rc, gave_up=True)
        return rc

    def run(self) -> int:
        self._emit("supervisor_start", max_restarts=self.max_restarts,
                   max_preemptions=self.max_preemptions)
        while True:
            t0 = self.clock()
            try:
                rc = int(self.attempt_fn(self.restarts))
            # whatever the runner throws IS the crash signal (rc 1): the
            # supervisor outlives it
            except Exception as e:
                self.log(f"[supervisor] attempt raised {type(e).__name__}: {e}")
                rc = 1
            if self.clock() - t0 >= self.streak_window_s:
                self._consec_resumable = 0
            if rc == 0:
                if self.restarts:
                    self.log(
                        f"[supervisor] run complete after {self.restarts} relaunch(es) "
                        f"({self.preemptions} preemption(s), {self.crashes} crash(es))"
                    )
                self._emit("supervisor_done", rc=0, gave_up=False)
                return 0
            self.restarts += 1
            if rc == EXIT_PREEMPTED:
                self.preemptions += 1
                self._consec_resumable += 1
                if self.preemptions > self.max_preemptions:
                    return self._give_up(
                        rc, f"{self.max_preemptions} resumable exits: something "
                        "re-preempts every attempt")
                delay = (0.0 if self._consec_resumable == 1
                         else self.backoff.delay(self._consec_resumable - 2))
                self.log(
                    f"[supervisor] resumable exit ({rc}); relaunching"
                    + (f" in {delay:.1f}s" if delay else "")
                    + f" (preemption {self.preemptions}, crash budget untouched at "
                    f"{self.crashes}/{self.max_restarts})"
                )
                self._relaunch("preempt", rc, delay)
                continue
            self._consec_resumable = 0
            self.crashes += 1
            if self.crashes > self.max_restarts:
                return self._give_up(
                    rc, f"exit code {rc} after {self.max_restarts} crash relaunches")
            delay = self.backoff.delay(self.crashes - 1)
            self.log(f"[supervisor] crash (exit {rc}); relaunching in {delay:.1f}s "
                     f"(crash {self.crashes}/{self.max_restarts})")
            self._relaunch("crash", rc, delay)


def _supervisor_events(env_map, host: int = 0):
    """An EventWriter on the log tree the child writes (``DDL_LOG_DIR`` /
    ``DDL_JOB_ID``, the config's environment defaults), so the relaunch
    decisions land in the job's stream; None when the directory cannot be
    written (events are telemetry, not a reason to refuse supervision)."""
    from ddl_tpu_torch.obs.events import EventWriter

    log_dir = env_map.get("DDL_LOG_DIR", "training_logs")
    job_id = (env_map.get("DDL_JOB_ID") or env_map.get("TORCHX_JOB_ID")
              or "local").split("/")[-1]
    try:
        return EventWriter(log_dir, job_id, host=host)
    except OSError as e:
        print(f"[supervisor] obs events disabled ({e})")
        return None


def _surviving_faults(spec_text: str, state_path) -> str:
    """The ``DDL_FAULT`` specs not recorded as fired in ``state_path`` (one
    canonical spec key per line).  Identical specs are matched one for
    one; a missing or unreadable state file means nothing fired."""
    from ddl_tpu_torch.utils.faultinject import FaultSpec

    consumed: collections.Counter = collections.Counter()
    try:
        for line in Path(state_path).read_text().splitlines():
            if line.strip():
                consumed[line.strip()] += 1
    except OSError:
        pass
    kept = []
    for part in spec_text.split(","):
        part = part.strip()
        if not part:
            continue
        key = FaultSpec.parse(part).key
        if consumed[key] > 0:
            consumed[key] -= 1
        else:
            kept.append(part)
    return ",".join(kept)


def _prepare_fault_env(child_env: dict, restart_index: int, state_path) -> None:
    """The consume-on-fire rule on a child's environment: fired specs are
    dropped on a relaunch, unfired ones kept; ``DDL_FAULT_PERSIST`` keeps
    them all."""
    if not child_env.get("DDL_FAULT") or child_env.get("DDL_FAULT_PERSIST"):
        return
    if state_path is None:
        # no record of what fired: injected faults are one-off events
        if restart_index > 0:
            child_env.pop("DDL_FAULT", None)
        return
    child_env["DDL_FAULT_STATE"] = str(state_path)
    if restart_index > 0:
        kept = _surviving_faults(child_env["DDL_FAULT"], state_path)
        if kept:
            child_env["DDL_FAULT"] = kept
        else:
            child_env.pop("DDL_FAULT", None)
            child_env.pop("DDL_FAULT_STATE", None)


def _fault_state_path(base_env: dict, hint: str):
    """A fresh fault-state file, or None when no fault is armed (or the
    spec is pinned)."""
    if not base_env.get("DDL_FAULT") or base_env.get("DDL_FAULT_PERSIST"):
        return None
    fd, path = tempfile.mkstemp(prefix=f"ddl_fault_state_{hint}_")
    os.close(fd)
    return path


def supervise_command(
    argv: list[str],
    max_restarts: int = 5,
    env: dict | None = None,
    **kwargs,
) -> int:
    """Supervise ``argv`` as a child process (the CLI's ``--supervise``);
    ``kwargs`` go to ``Supervisor``."""
    base_env = dict(os.environ if env is None else env)
    fault_state = _fault_state_path(base_env, "h0")
    sup_ref: list = []  # filled after construction; attempt reads it

    def attempt(restart_index: int) -> int:
        child_env = dict(base_env)
        child_env["DDL_SUPERVISED"] = "1"
        child_env["DDL_RESTART_COUNT"] = str(restart_index)
        child_env.setdefault("DDL_WATCHDOG_ACTION", "exit")
        # a value inherited from an outer supervisor must not reach attempt 0
        child_env.pop("DDL_RELAUNCH_TS", None)
        if restart_index > 0 and sup_ref and sup_ref[0].last_relaunch_ts:
            child_env["DDL_RELAUNCH_TS"] = repr(sup_ref[0].last_relaunch_ts)
        _prepare_fault_env(child_env, restart_index, fault_state)
        return subprocess.call(argv, env=child_env)

    kwargs.setdefault("events", _supervisor_events(base_env))
    sup = Supervisor(attempt, max_restarts=max_restarts, **kwargs)
    sup_ref.append(sup)
    try:
        return sup.run()
    finally:
        if sup.events is not None:
            sup.events.close()
        if fault_state is not None:
            try:
                os.unlink(fault_state)
            except OSError:
                pass
