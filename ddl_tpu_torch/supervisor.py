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

The supervisor process never touches the card (the child owns it).  A
supervised ``dp`` run on one host relaunches its whole world (the command
line's ranks exit together).

**Pod mode** (``PodSupervisor`` / ``supervise_pod_command``, command line
``train --supervise --pod DIR --hosts N --host-id I [--elastic]``): the
hosts of a pod train ONE world, so restarting one host's ranks alone
leaves them waiting at their first collective.  Each host runs a
PodSupervisor over a shared-directory rendezvous (``coord.py``, the JAX
package's protocol and marker files): heartbeats while the child runs,
exit-intent markers when it stops, a first-writer-wins restart-epoch
ledger (crash budgets, the backoff delay and the membership are fields of
one atomically created record), a join barrier so every host kills and
relaunches together, stale-peer detection, and a pod-wide abort marker.
The child is the host's launcher (``launch.run_pod_host``): it starts the
host's local ranks of the world, whose store the leader host hosts anew
for each restart epoch.

**Elastic mode** (``--elastic``): a peer silent past ``stale_after_s +
elastic_grace_s``, or absent from a restart epoch's join barrier, is
evicted: the survivors agree a smaller membership through the same ledger
and relaunch with ``DDL_COORD_MEMBERS`` (and the JAX package's
``DDL_NUM_PROCESSES``/``DDL_PROCESS_ID`` renumbering).  An evicted or
returning host publishes ``joins/h<i>.json`` and the leader grows the pod
back at the next restart boundary.  ``EXIT_REJOIN`` (76) is the drill
hook: an elastic child exiting with it asks its own host to step out and
return through the join path (``DDL_FAULT=rejoin@epoch:K``).
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

__all__ = [
    "EXIT_PREEMPTED",
    "EXIT_REJOIN",
    "PodSupervisor",
    "Supervisor",
    "supervise_command",
    "supervise_pod_command",
]

# EX_TEMPFAIL from sysexits.h: "temporary failure, retry later", a
# preemption's meaning, and distinct from crash codes (1, 2, 134, 139).
EXIT_PREEMPTED = 75
# An elastic pod's leave-and-return request (the rejoin drill, pod mode
# below); outside elastic pods it is a plain crash.
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


# ---------------------------------------------------------------------------
# pod mode: N hosts, one world, all-together restarts
# ---------------------------------------------------------------------------


class PodSupervisor:
    """One host's share of a pod-wide coordinated-restart protocol (the
    JAX package's ``PodSupervisor``, decision for decision).

    ``spawn_fn(restart_epoch, restart_index)`` launches this host's
    child (the host's launcher, which starts its local ranks of the
    pod's world) and returns a handle with ``poll()`` / ``terminate()``
    / ``kill()`` / ``wait(timeout=...)`` (a ``subprocess.Popen`` in
    production; tests inject scripted fakes).  ``rv`` is the shared
    ``coord.Rendezvous``.

    The invariant the protocol maintains: **children of different
    restart epochs never coexist.**  Any host's resumable exit, crash,
    watchdog hang, or aged-out heartbeat leads every host through the
    same sequence — kill the local child, agree on restart epoch E (one
    atomically-created ledger record carrying reason, cumulative crash/
    preemption counts, and the backoff delay), wait at the ``e<E>-join``
    barrier until all hosts have killed theirs, sleep the agreed delay,
    relaunch.  Budget enforcement applies the same rule to the same
    record on every host, so give-up is pod-wide too (``abort.json``).
    A host whose run completes (child exit 0) parks at the epoch's done
    barrier and still joins any restart proposed while it waits — a
    finished host must retrain alongside its peers, because the resumed
    collective needs all of them.
    """

    def __init__(
        self,
        spawn_fn: Callable,
        rv,
        max_restarts: int = 5,
        max_preemptions: int = 1000,
        backoff: Backoff | None = None,
        poll_s: float = 0.05,
        signal_poll_s: float | None = None,
        heartbeat_s: float = 1.0,
        stale_after_s: float = 30.0,
        elastic: bool = False,
        elastic_grace_s: float | None = None,
        rejoin_timeout_s: float | None = None,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
        log: Callable[[str], None] = print,
        events=None,
    ) -> None:
        self.spawn_fn = spawn_fn
        self.rv = rv
        self.max_restarts = max_restarts
        self.max_preemptions = max_preemptions
        # elastic scale-down: a peer silent past stale_after_s gets an
        # extra grace window to come back before the pod agrees it is
        # PERMANENTLY gone and continues on the survivors; non-elastic
        # pods keep the all-or-nothing protocol (stale peer -> pod
        # restart, absent peer at the join barrier -> abort)
        self.elastic = elastic
        self.elastic_grace_s = (
            2.0 * stale_after_s if elastic_grace_s is None
            else float(elastic_grace_s)
        )
        # elastic scale-up: how long an evicted/returning host keeps its
        # join_request alive waiting for a grow epoch before giving up
        # and exiting the way a plain eviction would (default: the
        # rendezvous timeout — the same patience as a barrier)
        self.rejoin_timeout_s = rejoin_timeout_s
        # (epoch, host) pairs already logged as stale-within-grace, so
        # the hold-the-grace decision is announced once, not per poll
        self._grace_noted: set = set()
        self.backoff = backoff if backoff is not None else Backoff(
            base=1.0, factor=2.0, max_delay=120.0, jitter=0.5
        )
        self.poll_s = poll_s
        # the child is polled at poll_s (local, free); the NAS signals
        # (abort/epoch/intents/heartbeats — four metadata reads) at the
        # slower signal_poll_s, so steady-state supervision doesn't load
        # the same NAS the checkpoints ride on.  The real signal cadence
        # is bounded by heartbeat_s/stale_after_s anyway.
        self.signal_poll_s = (
            10.0 * poll_s if signal_poll_s is None else signal_poll_s
        )
        self.heartbeat_s = heartbeat_s
        self.stale_after_s = stale_after_s
        self.sleep = sleep
        self.clock = clock
        self.log = log
        self.events = events
        self.restarts = 0
        # wall clock of the latest restart decision (the epoch record's
        # proposal stamp — one pod-wide instant, so every host's
        # restart_latency measures against the SAME origin); stamped
        # into relaunched children as DDL_RELAUNCH_TS by
        # supervise_pod_command's spawn
        self.last_relaunch_ts: float | None = None

    def _emit(self, kind: str, **fields) -> None:
        if self.events is not None:
            self.events.emit(kind, pod_host=self.rv.host, **fields)

    def _log(self, msg: str) -> None:
        self.log(f"[pod-supervisor h{self.rv.host}] {msg}")

    # -------------------------------------------------------------- watch

    def _signals(self, epoch: int):
        """A pod-level reason to stop waiting, or None: pod abort, a
        newer restart epoch, a peer's exit intent, a stale peer."""
        rv = self.rv
        ab = rv.aborted()
        if ab is not None:
            return ("abort", ab)
        rec = rv.epoch_record(epoch + 1)
        if rec is not None:
            return ("peer_epoch", rec)
        intents = rv.intents(epoch)
        if intents:
            return ("peer_intent", intents[0])
        if self.elastic and rv.host == rv.leader:
            # scale-up: a non-member published a fresh join_request.
            # Only the leader answers (one proposer, not a racing herd),
            # and the restart boundary it proposes resumes from the last
            # committed snapshot — the "next safe boundary" by
            # construction.  Staler-than-stale_after_s requests are a
            # joiner that died mid-wait; ignored.
            joins = rv.join_requests(fresh_s=self.stale_after_s or None)
            if joins:
                hosts = sorted({int(r["host"]) for r in joins})
                self._emit("peer_join", join_hosts=hosts, epoch=epoch)
                self._log(
                    f"join request(s) from host(s) {hosts}; growing the "
                    "pod at the next restart boundary"
                )
                return ("peer_join", hosts)
        if self.stale_after_s:
            stale = rv.stale_peers(self.stale_after_s)
            if stale and self.elastic:
                # elastic: a stale peer gets elastic_grace_s to come
                # back before eviction.  Restarting the pod meanwhile
                # would not help — staleness means the peer's SUPERVISOR
                # is silent, so it could not rejoin a restart anyway.
                lost = rv.stale_peers(
                    self.stale_after_s + self.elastic_grace_s
                )
                if lost:
                    self._emit("peer_lost", lost_hosts=lost, epoch=epoch)
                    self._log(
                        f"peer(s) {lost} silent past the eviction grace "
                        f"(> {self.stale_after_s + self.elastic_grace_s:.0f}s"
                        "); continuing on the survivors"
                    )
                    return ("peer_lost", lost)
                for h in stale:
                    if (epoch, h) not in self._grace_noted:
                        self._grace_noted.add((epoch, h))
                        self._emit(
                            "peer_stale", stale_host=h, epoch=epoch,
                            in_grace=True,
                        )
                        self._log(
                            f"peer h{h} heartbeat aged out "
                            f"(> {self.stale_after_s:.0f}s); holding "
                            f"{self.elastic_grace_s:.0f}s eviction grace "
                            "before scaling down"
                        )
                return None
            if stale:
                self._emit("peer_stale", stale_host=stale[0], epoch=epoch)
                self._log(
                    f"peer h{stale[0]} heartbeat aged out "
                    f"(> {self.stale_after_s:.0f}s); escalating to pod "
                    "restart instead of hanging in its collective"
                )
                return ("peer_stale", stale[0])
        return None

    def _watch(self, child, epoch: int):
        """Run until the local child exits or a pod signal arrives."""
        last_hb = -float("inf")
        # the first signal poll waits a full signal_poll_s: a freshly
        # relaunched incarnation must get past child startup before a
        # pending join_request (or any other non-fatal signal) can pull
        # the pod through ANOTHER restart — otherwise a joiner that
        # asked during the previous boundary preempts the epoch it was
        # excluded from before that epoch runs a single step
        last_sig = self.clock()
        while True:
            rc = child.poll()
            if rc is not None:
                return ("exit", int(rc))
            now = self.clock()
            if now - last_hb >= self.heartbeat_s:
                self.rv.publish_heartbeat("running", epoch)
                last_hb = now
            if now - last_sig >= self.signal_poll_s:
                sig = self._signals(epoch)
                if sig is not None:
                    return sig
                last_sig = now
            self.sleep(self.poll_s)

    def _wait_done(self, epoch: int):
        """Completed host: park at the done barrier, but keep watching —
        a restart proposed while we wait pulls us back in."""
        rv = self.rv
        rv.publish_heartbeat("done", epoch)
        name = f"done-e{epoch}"
        rv.arrive(name)
        # nothing local to poll here — everything is a NAS read, so the
        # whole loop runs at the slower signal cadence
        while True:
            if rv.barrier_complete(name):
                return ("done", None)
            sig = self._signals(epoch)
            if sig is not None:
                return sig
            self.sleep(self.signal_poll_s)

    def _await_rejoin(self, rec: dict) -> dict | None:
        """Elastic scale-up, joiner side: this host is outside ``rec``'s
        membership (evicted earlier, or a replacement supervisor started
        into a shrunken launch).  Publish a join_request — refreshed
        like a heartbeat, so the leader can tell a live joiner from a
        dead one's leftover marker — and watch the epoch ledger for a
        record whose ``hosts`` re-admits this host.  Returns that record
        (the caller joins it like any other restart epoch), or None when
        the pod aborted/finished or the rejoin timeout lapsed."""
        rv = self.rv
        evict_epoch = int(rec["epoch"])
        self._log(
            f"evicted by restart epoch {evict_epoch} (membership "
            f"{rec.get('hosts')}); publishing join_request and waiting "
            "to be re-admitted"
        )
        self._emit(
            "join_request", epoch=evict_epoch, members=rec.get("hosts"),
        )
        timeout = (
            rv.timeout_s if self.rejoin_timeout_s is None
            else self.rejoin_timeout_s
        )
        deadline = self.clock() + timeout
        last_pub = -float("inf")
        seen = evict_epoch  # newest ledger epoch this joiner has read
        while True:
            now = self.clock()
            if now - last_pub >= self.heartbeat_s:
                rv.publish_join_request(seen)
                rv.publish_heartbeat("joining", seen)
                last_pub = now
            if rv.aborted() is not None or rv.finished() is not None:
                self._log("pod ended while waiting to rejoin; giving up")
                rv.clear_join_request()
                return None
            # scan forward: the pod may restart several times (even
            # shrink further) before an epoch admits us
            while True:
                nxt = rv.epoch_record(seen + 1)
                if nxt is None:
                    break
                seen += 1
                if rv.host in (nxt.get("hosts") or []):
                    self._log(
                        f"re-admitted by restart epoch {seen} "
                        f"(membership {nxt.get('hosts')})"
                    )
                    rv.clear_join_request()
                    return nxt
            if now > deadline:
                self._log(
                    f"no grow epoch admitted this host within "
                    f"{timeout:.0f}s; giving up the rejoin"
                )
                rv.clear_join_request()
                return None
            self.sleep(self.signal_poll_s)

    def _reap(self, child) -> None:
        try:
            if child.poll() is None:
                child.terminate()
                try:
                    child.wait(timeout=10.0)
                except subprocess.TimeoutExpired:
                    child.kill()
                    child.wait(timeout=10.0)
        except (OSError, subprocess.TimeoutExpired):
            pass

    def _finish_abort(self, record: dict) -> int:
        rc = int(record.get("rc", 1))
        self._log(
            f"pod aborted by h{record.get('host')}: "
            f"{record.get('reason')} (exit {rc})"
        )
        self._emit("supervisor_done", rc=rc, gave_up=True, pod_abort=True)
        return rc

    # ---------------------------------------------------------------- run

    def run(self) -> int:
        from ddl_tpu_torch.coord import BarrierTimeout, PodAborted

        rv = self.rv
        # a pre-existing abort marker is STALE state from a previous run
        # of this coord dir: silently returning its rc (or silently
        # clearing it) would hide that coordination never started — be
        # loud and actionable instead
        stale = rv.aborted()
        if stale is not None:
            raise RuntimeError(
                f"coordination dir {rv.root} carries an abort marker from "
                f"a previous run (h{stale.get('host')}: "
                f"{stale.get('reason')}); use a fresh --pod directory per "
                "launch (or delete the old one) so stale markers cannot "
                "poison this pod's protocol"
            )
        self._emit(
            "supervisor_start",
            pod=True,
            hosts=rv.n_hosts,
            max_restarts=self.max_restarts,
            max_preemptions=self.max_preemptions,
        )
        epoch = rv.current_epoch()
        rv.publish_heartbeat("booting", epoch)
        try:
            t0 = self.clock()
            done_ts = rv.barrier("start")
            # completed_ts: the wall-clock instant this host OBSERVED the
            # barrier complete — every host sees it within one poll
            # interval of the same true instant, which is what the
            # obs-side clock-skew fit regresses on (obs/fold.py)
            self._emit(
                "coord_barrier", name="start", wait=self.clock() - t0,
                completed_ts=done_ts, arrive_ts=rv.last_arrive_ts,
            )
        except BarrierTimeout as e:
            ab = rv.abort(f"h{rv.host}: start barrier: {e}", 1)
            return self._finish_abort(ab)
        except PodAborted as e:
            return self._finish_abort(e.record)
        restart_index = 0
        if epoch > 0:
            # starting into a launch that already restarted: adopt the
            # current membership.  A host OUTSIDE it (a replacement, or
            # this same host's supervisor restarted after eviction) is
            # the scale-up entry point — under --elastic it publishes a
            # join_request and waits to be grown back in instead of
            # exiting.
            rec0 = rv.epoch_record(epoch)
            if rec0 is not None:
                try:
                    rv.adopt_membership(rec0.get("hosts") or rv.members)
                except ValueError:
                    if self.elastic:
                        rec0 = self._await_rejoin(rec0)
                    else:
                        self._log(
                            f"evicted by restart epoch {rec0['epoch']} "
                            f"(membership {rec0.get('hosts')}); exiting "
                            "cleanly — the pod continues without us"
                        )
                        rec0 = None
                    if rec0 is None:
                        self._emit(
                            "supervisor_done", rc=0, gave_up=False,
                            evicted=True, epoch=epoch,
                        )
                        return 0
                    status, res = self._join_restart(rec0, epoch)
                    if status == "exit":
                        return res
                    rec0 = res
                    if rec0["delay"] > 0:
                        self.sleep(rec0["delay"])
                    self.last_relaunch_ts = float(
                        rec0.get("ts") or time.time()
                    )
                    epoch = int(rec0["epoch"])
                    restart_index = 1
                    self.restarts = restart_index
        while True:
            ab = rv.aborted()
            if ab is not None:
                return self._finish_abort(ab)
            child = self.spawn_fn(epoch, restart_index)
            self._log(
                f"launched child (restart epoch {epoch}, "
                f"attempt {restart_index})"
            )
            kind, detail = self._watch(child, epoch)
            if kind == "exit" and detail == 0:
                self._log("child complete; waiting for the pod")
                kind, detail = self._wait_done(epoch)
                if kind == "done":
                    self._log("pod complete")
                    # close the launch: coord.acquire_launch refuses to
                    # re-admit hosts into a finished launch's markers, so
                    # a lone relaunch opens a fresh subdir instead of
                    # sailing through this run's start barrier
                    rv.mark_finished(0)
                    self._emit("supervisor_done", rc=0, gave_up=False)
                    return 0
            if kind == "abort":
                self._reap(child)
                return self._finish_abort(detail)

            # ---- coordinate a pod-wide restart -------------------------
            survivors = None  # elastic: a shrunken membership to propose
            if kind == "exit":
                rc = int(detail)
                if (
                    self.elastic and rc == EXIT_REJOIN
                    and len(rv.members) > 1
                ):
                    # voluntary leave-and-return (the rejoin drill): the
                    # child asked to leave the pod, so propose our OWN
                    # eviction — the pod continues at N-1 — and then
                    # take the joiner path to be re-admitted.  Burns no
                    # budget: leaving on purpose is neither a crash nor
                    # a preemption.
                    crash = False
                    preempt = False
                    reason = "rejoin"
                    survivors = [m for m in rv.members if m != rv.host]
                else:
                    crash = rc not in (0, EXIT_PREEMPTED)
                    preempt = rc == EXIT_PREEMPTED
                    reason = "crash" if crash else (
                        "preempt" if preempt else "complete"
                    )
                # tell peers promptly — they kill their children off this
                # marker instead of waiting for our heartbeat to age out
                rv.publish_intent(reason, rc, epoch)
            elif kind == "peer_intent":
                rc = int(detail.get("rc", 1))
                if self.elastic and detail.get("reason") == "rejoin":
                    # the peer is leaving on purpose to rejoin later:
                    # continue without it, no budget consumed — mirrors
                    # the leaver's own classification so the agreed
                    # record is identical whoever wins the proposal race
                    crash = False
                    preempt = False
                    reason = "peer_rejoin"
                    gone = int(detail.get("host", -1))
                    survivors = [m for m in rv.members if m != gone]
                else:
                    # classify from the INTENT (the peer that actually
                    # died), so the crash budget is consumed even when a
                    # bystander host wins the proposal race
                    crash = rc not in (0, EXIT_PREEMPTED)
                    preempt = rc == EXIT_PREEMPTED
                    reason = f"peer_{detail.get('reason', 'exit')}"
                self._reap(child)
            elif kind == "peer_join":
                # elastic scale-UP: the leader observed fresh
                # join_request markers.  Propose the next epoch WITH the
                # joiners — the atomically-created record IS the
                # membership agreement (coord.propose_restart), exactly
                # the shrink protocol run in reverse.
                rc = EXIT_PREEMPTED
                crash = False
                preempt = False
                reason = "peer_join"
                survivors = sorted(set(rv.members) | set(detail))
                self._reap(child)
            elif kind == "peer_lost":
                # elastic eviction: propose the next epoch WITHOUT the
                # lost hosts — the atomically-created record IS the
                # membership agreement (coord.propose_restart)
                rc = EXIT_PREEMPTED
                crash = False
                preempt = True
                reason = "peer_lost"
                gone = set(detail)
                survivors = [m for m in rv.members if m not in gone]
                self._reap(child)
            else:
                rc = EXIT_PREEMPTED
                crash = False
                # a wedged peer consumes the preemption budget, so a host
                # that wedges every epoch eventually aborts the pod
                preempt = kind == "peer_stale"
                reason = kind
                self._reap(child)
            rv.publish_heartbeat("restarting", epoch)
            if kind == "peer_epoch":
                rec = detail
            else:
                try:
                    rec = rv.propose_restart(
                        epoch, reason, crash, preempt, rc=rc,
                        delay_fn=lambda c: self.backoff.delay(c - 1),
                        hosts=survivors,
                    )
                except BarrierTimeout as e:
                    ab = rv.abort(f"h{rv.host}: {e}", 1)
                    return self._finish_abort(ab)
            status, res = self._join_restart(rec, epoch)
            if status == "exit":
                return res
            rec = res
            if rec["delay"] > 0:
                self.sleep(rec["delay"])
            # the restart decision instant: the epoch record's proposal
            # stamp (rv.clock — wall time), identical on every host
            self.last_relaunch_ts = float(rec.get("ts") or time.time())
            epoch = int(rec["epoch"])
            restart_index += 1
            self.restarts = restart_index

    def _join_restart(self, rec: dict, epoch: int):
        """Join the agreed restart epoch ``rec``: adopt its membership,
        enforce the budgets its record carries, and meet the pod at its
        join barrier.  Returns ``("ok", rec)`` with the (possibly
        re-proposed) record to relaunch under, or ``("exit", rc)``.

        This is a loop only in elastic mode, in two directions: a join
        barrier that times out on a host whose supervisor died outright
        is answered by proposing the NEXT epoch over the hosts that DID
        arrive; and a host EVICTED by the adopted record — instead of
        exiting — publishes a join_request and, when a later epoch
        re-admits it, loops back to join that grow epoch."""
        from ddl_tpu_torch.coord import BarrierTimeout, PodAborted

        rv = self.rv
        while True:
            try:
                # the record's membership is the pod's truth: adopt
                # it BEFORE judging the join barrier, so a shrunken
                # epoch only waits on its survivors
                rv.adopt_membership(rec.get("hosts") or rv.members)
            except ValueError:
                if self.elastic:
                    # scale-up, joiner side: stay around, ask back in
                    newrec = self._await_rejoin(rec)
                    if newrec is not None:
                        rec = newrec
                        continue
                else:
                    self._log(
                        f"evicted by restart epoch {rec['epoch']} "
                        f"(membership {rec.get('hosts')}); exiting — the "
                        "pod continues without this host"
                    )
                self._emit(
                    "supervisor_done", rc=0, gave_up=False,
                    evicted=True, epoch=rec["epoch"],
                )
                return ("exit", 0)
            if rec["crashes"] > self.max_restarts:
                # the abort rc comes from the RECORD, not this
                # host's local view: a bystander that adopted a
                # peer's proposal must still surface the crashing
                # child's exit code
                ab = rv.abort(
                    f"crash budget exhausted "
                    f"({rec['crashes']} > {self.max_restarts})",
                    int(rec.get("rc", 1)) if rec.get("crash") else 1,
                )
                return ("exit", self._finish_abort(ab))
            if rec["preemptions"] > self.max_preemptions:
                ab = rv.abort(
                    f"resumable-exit budget exhausted "
                    f"({rec['preemptions']} > {self.max_preemptions})",
                    EXIT_PREEMPTED,
                )
                return ("exit", self._finish_abort(ab))
            self._emit(
                "pod_restart",
                epoch=rec["epoch"],
                reason=rec["reason"],
                proposer=rec["proposer"],
                crashes=rec["crashes"],
                preemptions=rec["preemptions"],
                delay=rec["delay"],
                hosts=rec.get("hosts"),
                world=rec.get("world"),
                # the pod-wide decision instant (epoch-record
                # proposal stamp) — the flow-arrow origin the
                # incident trace draws to every host's join-barrier
                # span
                decision_ts=rec.get("ts"),
            )
            self._log(
                f"joining restart epoch {rec['epoch']} "
                f"(reason={rec['reason']} by h{rec['proposer']}, "
                f"world {rec.get('world', rv.world)}, "
                f"crashes {rec['crashes']}/{self.max_restarts}, "
                f"delay {rec['delay']:.1f}s)"
            )
            # heartbeat while waiting at the join barrier —
            # throttled to heartbeat_s (on_wait fires every poll
            # iteration, and an unthrottled atomic write per poll
            # would load the NAS the signal_poll_s split exists to
            # protect)
            last_hb = [-float("inf")]

            def _hb_while_waiting(epoch=epoch):
                now = self.clock()
                if now - last_hb[0] >= self.heartbeat_s:
                    rv.publish_heartbeat("restarting", epoch)
                    last_hb[0] = now

            join = f"e{rec['epoch']}-join"
            try:
                t0 = self.clock()
                done_ts = rv.barrier(join, on_wait=_hb_while_waiting)
                self._emit(
                    "coord_barrier",
                    name=join,
                    wait=self.clock() - t0,
                    completed_ts=done_ts,
                    arrive_ts=rv.last_arrive_ts,
                )
                return ("ok", rec)
            except BarrierTimeout as e:
                arrivals = rv.barrier_arrivals(join)
                if not self.elastic or not arrivals or (
                    len(arrivals) >= len(rv.members)
                ):
                    # a peer never joined: its supervisor is gone,
                    # and a partial relaunch would just hang — give
                    # the pod up
                    ab = rv.abort(f"h{rv.host}: {e}", 1)
                    return ("exit", self._finish_abort(ab))
                # elastic: the arrived hosts ARE the pod now.  All
                # of them hit this timeout within a poll interval of
                # each other and race the same next-epoch proposal;
                # first writer wins, the rest adopt.
                self._log(
                    f"join barrier {join} timed out with arrivals "
                    f"{arrivals}; proposing continue-on-survivors"
                )
                self._emit(
                    "peer_lost", epoch=rec["epoch"],
                    lost_hosts=[
                        m for m in rv.members if m not in arrivals
                    ],
                    at_barrier=join,
                )
                try:
                    rec = rv.propose_restart(
                        int(rec["epoch"]), "peer_lost",
                        crash=False, preempt=True, rc=EXIT_PREEMPTED,
                        delay_fn=lambda c: self.backoff.delay(c - 1),
                        hosts=arrivals,
                    )
                except BarrierTimeout as e2:
                    ab = rv.abort(f"h{rv.host}: {e2}", 1)
                    return ("exit", self._finish_abort(ab))
                continue
            except PodAborted as e:
                return ("exit", self._finish_abort(e.record))


def supervise_pod_command(
    argv: list[str],
    coord_dir: str | os.PathLike,
    host: int,
    n_hosts: int,
    max_restarts: int = 5,
    env: dict | None = None,
    **kwargs,
) -> int:
    """Pod-mode supervision of ``argv`` (the CLI's ``--supervise --pod``).

    ``coord_dir`` must be one directory every host of the pod sees (the
    checkpoint/log NAS), scoped by job (``/nas/<job>/coord``).  The
    rendezvous state itself is run-scoped below it:
    ``coord.acquire_launch`` places each launch's markers (barriers,
    epoch ledger, abort) in their own ``launches/`` subdir — joined by
    token when the operator/scheduler provides ``DDL_LAUNCH_TOKEN``
    (same value on every host, fresh per launch), else agreed
    leaderlessly by atomic create — so a completed previous run's
    markers can never admit a lone relaunched host into a pod that
    isn't there (it opens a fresh launch, times out at its start
    barrier, and aborts loudly).  An *unfinished* previous launch is
    still joined as-is — relaunching into a crashed pod's directory
    remains "use a fresh --pod dir" territory, and its stale abort
    marker is refused loudly.  Children additionally get the rendezvous
    env (``DDL_COORD_*``, pointing at the launch subdir) so the stall
    watchdog can publish exit intent and ``checkpoint.resolve_resume``
    can run the rank-0 resume agreement, plus ``DDL_RESTART_EPOCH`` for
    obs metadata."""
    from ddl_tpu_torch import coord

    base_env = dict(os.environ if env is None else env)
    try:
        launch_root = coord.acquire_launch(
            coord_dir, token=base_env.get("DDL_LAUNCH_TOKEN")
        )
    except RuntimeError as e:
        # stale DDL_LAUNCH_TOKEN naming a closed launch: an operator
        # error, not a crash — report it without a traceback
        print(f"[pod-supervisor h{host}] {e}", file=sys.stderr)
        return 1
    rv = coord.Rendezvous(
        launch_root, host, n_hosts,
        timeout_s=float(
            base_env.get(coord.ENV_TIMEOUT) or coord.DEFAULT_TIMEOUT_S
        ),
    )
    fault_state = _fault_state_path(base_env, f"h{host}")

    sup_ref: list = []  # filled after construction; spawn closes over it

    def spawn(restart_epoch: int, restart_index: int):
        child_env = dict(base_env)
        child_env["DDL_SUPERVISED"] = "1"
        child_env["DDL_RESTART_COUNT"] = str(restart_index)
        child_env.pop("DDL_RELAUNCH_TS", None)
        if restart_index > 0 and sup_ref and sup_ref[0].last_relaunch_ts:
            # restart-latency origin: the pod-wide restart decision
            # (epoch-record proposal time) — the child's first completed
            # step emits `restart_latency` against it
            child_env["DDL_RELAUNCH_TS"] = repr(sup_ref[0].last_relaunch_ts)
        child_env[coord.ENV_EPOCH] = str(restart_epoch)
        child_env[coord.ENV_DIR] = str(launch_root)
        child_env[coord.ENV_HOSTS] = str(n_hosts)
        child_env[coord.ENV_HOST] = str(host)
        # live membership (elastic scale-down may have shrunk it): the
        # child's own Rendezvous (watchdog intent, resume agreement)
        # must judge barriers over the SAME member set the supervisors
        # agreed, or it would wait on evicted hosts forever
        child_env[coord.ENV_MEMBERS] = ",".join(
            str(m) for m in rv.members
        )
        if rv.world < n_hosts:
            # the JAX package's respec: survivors renumber contiguously
            # while keeping their pod host ids for coordination.  The
            # launcher (launch.run_pod_host) numbers its ranks from
            # DDL_COORD_MEMBERS itself and overrides these per rank; a
            # child that is one host's only process reads them as they are
            child_env["DDL_NUM_PROCESSES"] = str(rv.world)
            child_env["DDL_PROCESS_ID"] = str(rv.members.index(host))
        # the launcher is no rank: it starts them (launch.run_pod_host)
        child_env.pop("DDL_LOCAL_RANK", None)
        child_env.setdefault("DDL_HOST_ID", str(host))
        child_env.setdefault("DDL_WATCHDOG_ACTION", "exit")
        _prepare_fault_env(child_env, restart_index, fault_state)
        return subprocess.Popen(argv, env=child_env)

    kwargs.setdefault("events", _supervisor_events(base_env, host=host))
    sup = PodSupervisor(
        spawn, rv, max_restarts=max_restarts, **kwargs
    )
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
