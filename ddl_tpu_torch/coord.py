"""Pod-level coordination over a shared directory (port of
``ddl_tpu/coord.py``; the same marker files, JSON fields and environment
contract, so a JAX host and a port host read each other's markers).

A pod's hosts train one world: every host's launcher starts its local
ranks of one ``torch.distributed`` process group spanning all hosts
(``launch.spawn_pod``).  Restarting one host's ranks alone leaves them
waiting at their first collective while the surviving hosts block in the
*previous* incarnation's all-reduce, so recovery must be a coordinated,
all-hosts-together event, and the layer must also notice a host that
stopped making progress without ever exiting.

This module is that layer, built on the one medium every host of a pod
already shares: the checkpoint/log directory.  ``Rendezvous`` is a small
marker-file protocol under one directory (no sockets, no leader
election, no extra service) with four primitives:

``hosts/h<i>.json``      liveness heartbeats (wall-clock ts + status +
                         current restart epoch).  A peer whose heartbeat
                         ages past ``stale_after_s`` while "running" is
                         presumed wedged or dead: grounds for escalation
                         instead of an eternal collective hang.
``intents/h<i>.e<E>.json``  exit-intent markers, scoped to restart epoch
                         ``E``.  Published by a supervisor whose child
                         exited, and by the stall watchdog *before* its
                         ``os._exit(75)``, so peers learn a host is going
                         down even if that host's supervisor is wedged.
``epochs/e<E>.json``     the restart-epoch ledger.  Proposing epoch ``E``
                         is an atomic create of ``e<E>.json``: exactly one
                         proposer wins, and losers adopt the winner's
                         record (reason, cumulative crash/preemption
                         counts, agreed backoff delay, membership).
``barriers/<name>/h<i>`` arrival markers; a barrier completes when every
                         live member's file exists.  Every host kills its
                         child and arrives before *any* host relaunches,
                         and completed hosts wait for the whole pod.

plus ``agree/<key>.json`` (the leader publishes a value, peers wait: the
resume snapshot, the rollback target and each restart epoch's
coordinator address), ``abort.json`` (a give-up is pod-wide, never one
host quietly exiting), ``joins/h<i>.json`` (elastic scale-up: a
returning host outside the membership asks to be admitted), and under
``launches/`` one subdirectory per launch (``acquire_launch``).

Every marker is written tmp-file + ``os.replace``, so readers never see a
torn JSON.  Heartbeat freshness uses the *writer's* wall clock in the
payload, compared against the reader's: pod hosts are NTP-synced and
``stale_after_s`` is tens of seconds.

This module imports neither torch nor anything that does: it runs in
supervisor processes (which never touch the card their children own) and
inside the watchdog's escalation path.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

__all__ = [
    "BarrierTimeout",
    "PodAborted",
    "Rendezvous",
    "acquire_launch",
    "active_launch_root",
    "agreed_resume_epoch",
    "agreed_rollback_epoch",
    "from_env",
    "publish_exit_intent_from_env",
]

# Environment contract (set by supervise_pod_command for both the
# supervisor's own helpers and the trainer child it spawns):
ENV_DIR = "DDL_COORD_DIR"
ENV_HOSTS = "DDL_COORD_HOSTS"
ENV_HOST = "DDL_COORD_HOST"
ENV_EPOCH = "DDL_RESTART_EPOCH"
ENV_TIMEOUT = "DDL_COORD_TIMEOUT_S"
# Comma-separated live host ids after an elastic scale-down (e.g.
# "0,2").  ENV_HOSTS stays the ORIGINAL pod size and ENV_HOST the
# original host id — membership shrinks, identities do not renumber —
# so host ids in barriers/heartbeats/intents stay stable across
# evictions.
ENV_MEMBERS = "DDL_COORD_MEMBERS"
# How stale an OPEN launch's markers may be before acquire_launch
# refuses to join it (seconds; see _launch_stale).
ENV_LAUNCH_STALE = "DDL_LAUNCH_STALE_S"
# A scheduler incarnation id shared by every host and fresh per launch:
# the launch subdirectory's name (acquire_launch).
ENV_LAUNCH_TOKEN = "DDL_LAUNCH_TOKEN"

DEFAULT_TIMEOUT_S = 300.0
DEFAULT_LAUNCH_STALE_S = 600.0


class BarrierTimeout(RuntimeError):
    """A peer never reached the barrier — its supervisor is gone, not
    merely slow.  The caller aborts the pod rather than hanging."""


class PodAborted(RuntimeError):
    """The pod-wide give-up marker exists; stop waiting."""

    def __init__(self, record: dict) -> None:
        super().__init__(record.get("reason", "pod aborted"))
        self.record = record


def _write_json(path: Path, payload: dict) -> None:
    """Atomic marker write: a reader sees the old file or the new one,
    never a torn line (tmp + rename, the write_manifest pattern).  The
    tmp name carries pid AND thread id so two writers racing on the
    same marker (idempotent ones: barriers, finished) never clobber
    each other's tmp — the in-process pod tests run N "hosts" as
    threads of one pid, where pid alone collides."""
    import threading

    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(
        f".{path.name}.{os.getpid()}.{threading.get_ident()}.tmp"
    )
    tmp.write_text(json.dumps(payload))
    os.replace(tmp, path)


def _read_json(path: Path) -> dict | None:
    """None for missing or torn-beyond-parse markers (the writer is
    mid-replace or the NAS flaked; the caller polls again)."""
    try:
        return json.loads(path.read_text())
    except (OSError, ValueError):
        return None


class Rendezvous:
    """One host's handle on the shared coordination directory."""

    def __init__(
        self,
        root: str | os.PathLike,
        host: int,
        n_hosts: int,
        timeout_s: float = DEFAULT_TIMEOUT_S,
        poll_s: float = 0.05,
        sleep=time.sleep,
        clock=time.time,
        members=None,
    ) -> None:
        if not 0 <= host < n_hosts:
            raise ValueError(f"host {host} out of range for {n_hosts}")
        self.root = Path(root)
        self.host = int(host)
        self.n_hosts = int(n_hosts)
        # live membership (elastic scale-down): host ids still in the
        # pod.  ``n_hosts`` stays the ORIGINAL pod size — ids never
        # renumber — while barriers/peers/agreement run over members
        # only.  Default: everyone.
        if members is None:
            members = range(n_hosts)
        self.members = tuple(sorted({int(m) for m in members}))
        if self.host not in self.members:
            raise ValueError(
                f"host {host} not in membership {self.members}"
            )
        if any(not 0 <= m < n_hosts for m in self.members):
            raise ValueError(
                f"membership {self.members} out of range for {n_hosts}"
            )
        self.timeout_s = float(timeout_s)
        self.poll_s = float(poll_s)
        # wall clock, not monotonic: heartbeat ages are compared across
        # processes/hosts, which share NTP time but not a monotonic base
        self.clock = clock
        self.sleep = sleep
        # wall-clock instant of this host's most recent barrier arrival
        # (barrier()/arrive()): paired with barrier()'s completion stamp
        # it bounds the barrier span in ONE clock domain (the
        # ``coord_barrier`` event's ``arrive_ts``/``completed_ts``),
        # instead of mixing a monotonic wait duration into wall time
        self.last_arrive_ts: float | None = None
        self.root.mkdir(parents=True, exist_ok=True)

    # --------------------------------------------------------- membership

    @property
    def world(self) -> int:
        """Live pod size — the data-axis world after any scale-down."""
        return len(self.members)

    @property
    def leader(self) -> int:
        """The agreement publisher: the lowest LIVE host id, so rank-0
        duties survive rank 0's own eviction."""
        return self.members[0]

    def adopt_membership(self, hosts) -> None:
        """Shrink, GROW, or restate the live membership — called after
        an epoch record carrying an agreed ``hosts`` set wins the
        ledger race (a grow epoch's set is larger than the current
        one; nothing here is direction-sensitive).  Raises if this host
        is not among the members (its supervisor must exit — or, under
        ``--elastic``, publish a join_request and wait to be grown back
        in instead of relaunching)."""
        members = tuple(sorted({int(h) for h in hosts}))
        if self.host not in members:
            raise ValueError(
                f"host {self.host} evicted by membership {members}"
            )
        if any(not 0 <= m < self.n_hosts for m in members):
            raise ValueError(
                f"membership {members} out of range for {self.n_hosts}"
            )
        self.members = members

    # --------------------------------------------------------- join intake
    #
    # The grow half of elasticity: a returning (or replacement) host is
    # OUTSIDE the live membership, so none of the member-scoped
    # primitives can carry its voice — its heartbeats are invisible and
    # it may not arrive at barriers.  It announces itself through a
    # dedicated ``joins/h<i>.json`` marker instead; the leader folds
    # pending requests into the next restart epoch's ``hosts`` set (the
    # same atomically-created ledger record that agrees shrink
    # memberships agrees grown ones), and the joiner watches the ledger
    # for an epoch that admits it.

    def publish_join_request(self, epoch: int, **fields) -> None:
        """Ask to be (re-)admitted to the pod.  ``epoch`` is the newest
        restart epoch the joiner has observed.  Refreshed periodically
        while waiting — the leader ignores requests whose writer went
        silent (``fresh_s`` below), so a joiner that died after asking
        cannot drag the pod through a grow epoch it will never join."""
        _write_json(
            self.root / "joins" / f"h{self.host:03d}.json",
            {
                "ts": self.clock(),
                "host": self.host,
                "epoch": int(epoch),
                **fields,
            },
        )

    def join_requests(self, fresh_s: float | None = None) -> list[dict]:
        """Pending join requests from live NON-members (a member's
        leftover marker is void by definition), each with an ``age``;
        requests staler than ``fresh_s`` are dropped."""
        joins_dir = self.root / "joins"
        if not joins_dir.is_dir():
            return []
        now = self.clock()
        out = []
        for p in sorted(joins_dir.glob("h*.json")):
            rec = _read_json(p)
            if rec is None:
                continue
            h = int(rec.get("host", -1))
            if h in self.members or not 0 <= h < self.n_hosts:
                continue
            rec["age"] = now - float(rec.get("ts", 0.0))
            if fresh_s is not None and rec["age"] > fresh_s:
                continue
            out.append(rec)
        return out

    def clear_join_request(self, host: int | None = None) -> None:
        """Withdraw a join request (the joiner's own, by default) —
        called once an epoch record admits the host, or when it gives
        up.  Best-effort: a leftover marker from an admitted host is
        filtered by ``join_requests`` anyway."""
        h = self.host if host is None else int(host)
        try:
            (self.root / "joins" / f"h{h:03d}.json").unlink()
        except OSError:
            pass

    # ------------------------------------------------------------ liveness

    def publish_heartbeat(self, status: str, epoch: int, **fields) -> None:
        _write_json(
            self.root / "hosts" / f"h{self.host:03d}.json",
            {
                "ts": self.clock(),
                "host": self.host,
                "pid": os.getpid(),
                "status": status,
                "epoch": int(epoch),
                **fields,
            },
        )

    def peers(self) -> dict[int, dict]:
        """Other LIVE hosts' latest heartbeats, keyed by host id, each
        with an ``age`` (seconds since the writer stamped it).  Evicted
        hosts' leftover heartbeat files are invisible — a scaled-down
        pod must not keep re-judging its casualty."""
        out: dict[int, dict] = {}
        hosts_dir = self.root / "hosts"
        if not hosts_dir.is_dir():
            return out
        now = self.clock()
        for p in hosts_dir.iterdir():
            rec = _read_json(p)
            if rec is None or rec.get("host") == self.host:
                continue
            if int(rec.get("host", -1)) not in self.members:
                continue
            rec["age"] = now - float(rec.get("ts", 0.0))
            out[int(rec["host"])] = rec
        return out

    def stale_peers(self, stale_after_s: float) -> list[int]:
        """Peers presumed wedged or dead: still marked ``running`` but
        silent past the deadline.  Hosts in any other status ("done",
        "restarting", "booting") are between beats by design and judged
        by barriers instead."""
        return sorted(
            h for h, rec in self.peers().items()
            if rec.get("status") == "running"
            and rec["age"] > stale_after_s
        )

    # --------------------------------------------------------- exit intent

    def publish_intent(self, reason: str, rc: int, epoch: int) -> None:
        """Announce this host is going down (or its child already did).
        Scoped to the restart epoch so a stale intent from a previous
        incarnation cannot retrigger a restart after everyone moved on."""
        _write_json(
            self.root / "intents" / f"h{self.host:03d}.e{int(epoch)}.json",
            {
                "ts": self.clock(),
                "host": self.host,
                "reason": reason,
                "rc": int(rc),
                "epoch": int(epoch),
            },
        )

    def intents(self, epoch: int, include_self: bool = False) -> list[dict]:
        intents_dir = self.root / "intents"
        if not intents_dir.is_dir():
            return []
        out = []
        for p in sorted(intents_dir.glob(f"*.e{int(epoch)}.json")):
            rec = _read_json(p)
            if rec is None:
                continue
            if not include_self and rec.get("host") == self.host:
                continue
            out.append(rec)
        return out

    # ------------------------------------------------- restart-epoch ledger

    def _epoch_path(self, epoch: int) -> Path:
        return self.root / "epochs" / f"e{int(epoch)}.json"

    def epoch_record(self, epoch: int) -> dict | None:
        return _read_json(self._epoch_path(epoch))

    def current_epoch(self) -> int:
        """Highest restart epoch any host has proposed (0 = the initial
        launch, which has no ledger entry)."""
        epochs_dir = self.root / "epochs"
        if not epochs_dir.is_dir():
            return 0
        best = 0
        for p in epochs_dir.glob("e*.json"):
            try:
                best = max(best, int(p.stem[1:]))
            except ValueError:
                continue
        return best

    def propose_restart(
        self,
        cur_epoch: int,
        reason: str,
        crash: bool,
        preempt: bool,
        rc: int = 1,
        delay_fn=None,
        hosts=None,
    ) -> dict:
        """First-writer-wins proposal of restart epoch ``cur_epoch + 1``.

        The winning record carries everything the pod must agree on to
        avoid split-brain: cumulative crash/preemption counts (rolled
        forward from the previous epoch's record) and the backoff delay
        every host sleeps before relaunching (``delay_fn(crash_count)``,
        computed once by the proposer — N hosts must not each draw their
        own jitter).  Losers adopt the winner's record unchanged, even if
        they raced with a different reason: one restart event, one
        classification.

        ``hosts`` (elastic) proposes a CHANGED membership — shrunken
        (scale-down: survivors of an eviction) or GROWN (scale-up: the
        current members plus admitted joiners, see ``join_requests``):
        the record carries the agreed live host set and world size, and
        because the record is atomically created, the membership
        agreement rides the same first-writer-wins ledger — no second
        agreement round, no split-brain window between "which epoch" and
        "who is still in it", in either direction.  Omitted, the
        proposer's current membership is recorded (a plain same-world
        restart)."""
        nxt = int(cur_epoch) + 1
        prev = self.epoch_record(cur_epoch) if cur_epoch else None
        crashes = (prev or {}).get("crashes", 0) + (1 if crash else 0)
        preemptions = (prev or {}).get("preemptions", 0) + (
            1 if preempt else 0
        )
        delay = float(delay_fn(crashes) if (crash and delay_fn) else 0.0)
        members = (
            sorted({int(h) for h in hosts}) if hosts is not None
            else list(self.members)
        )
        record = {
            "ts": self.clock(),
            "epoch": nxt,
            "proposer": self.host,
            "reason": reason,
            "crash": bool(crash),
            # the triggering exit code rides in the record so budget
            # aborts carry it no matter WHICH host trips the budget (an
            # adopting bystander must not replace rc=7 with a generic 1)
            "rc": int(rc),
            "crashes": int(crashes),
            "preemptions": int(preemptions),
            "delay": delay,
            "hosts": members,
            "world": len(members),
        }
        path = self._epoch_path(nxt)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f".{path.name}.{self.host}.tmp")
        tmp.write_text(json.dumps(record))
        try:
            # hard link onto the final name: atomic create-if-absent even
            # on NFS (O_EXCL open is not reliably atomic there)
            os.link(tmp, path)
        except FileExistsError:
            # lost the race: the winner's record is the pod's truth
            os.unlink(tmp)
            won = None
            deadline = self.clock() + self.timeout_s
            while won is None:  # the winner may still be mid-replace
                won = _read_json(path)
                if won is None:
                    if self.clock() > deadline:
                        raise BarrierTimeout(
                            f"unreadable epoch record {path}"
                        )
                    self.sleep(self.poll_s)
            return won
        os.unlink(tmp)
        return record

    # ------------------------------------------------------------ barriers

    def barrier(
        self, name: str, timeout_s: float | None = None, on_wait=None
    ) -> float:
        """Mark arrival and wait until all ``n_hosts`` arrive; returns
        the wall-clock instant THIS host observed the barrier complete.
        All hosts observe completion within one poll interval of the
        same true instant, which makes the returned stamp the input to
        the cross-host clock-skew fit (``obs/fold.estimate_clock_offsets``
        — per-host offsets are least squares over the shared barriers).
        Raises ``BarrierTimeout`` if a peer never shows (its supervisor
        is gone — the caller aborts the pod instead of hanging the way
        the collective it replaces would have), and ``PodAborted`` if
        the give-up marker appears while waiting."""
        d = self.root / "barriers" / name
        self.last_arrive_ts = self.clock()
        _write_json(d / f"h{self.host:03d}", {"ts": self.last_arrive_ts})
        deadline = self.clock() + (
            self.timeout_s if timeout_s is None else timeout_s
        )
        while True:
            missing = self._missing_members(d)
            if not missing:
                return self.clock()
            ab = self.aborted()
            if ab is not None:
                raise PodAborted(ab)
            if self.clock() > deadline:
                raise BarrierTimeout(
                    f"barrier {name!r}: "
                    f"{len(self.members) - len(missing)}/{len(self.members)}"
                    " hosts after "
                    f"{self.timeout_s if timeout_s is None else timeout_s:.0f}s"
                    f" (missing {missing})"
                )
            if on_wait is not None:
                on_wait()
            self.sleep(self.poll_s)

    def _missing_members(self, barrier_dir: Path) -> list[int]:
        """Live members with no arrival marker yet.  Presence is judged
        per member id (not a count): an evicted host's stale marker in a
        reused barrier name must neither complete a barrier early nor
        block one."""
        return [
            m for m in self.members
            if not (barrier_dir / f"h{m:03d}").exists()
        ]

    def barrier_arrivals(self, name: str) -> list[int]:
        """Host ids with an arrival marker at ``name`` (members only) —
        what an elastic supervisor scales down to when the join barrier
        times out on a host whose supervisor died outright."""
        d = self.root / "barriers" / name
        if not d.is_dir():
            return []
        return [
            m for m in self.members if (d / f"h{m:03d}").exists()
        ]

    def arrive(self, name: str) -> None:
        """Mark arrival at a barrier WITHOUT waiting (callers that must
        keep watching other signals poll ``barrier_complete``)."""
        self.last_arrive_ts = self.clock()
        _write_json(
            self.root / "barriers" / name / f"h{self.host:03d}",
            {"ts": self.last_arrive_ts},
        )

    def barrier_complete(self, name: str) -> bool:
        d = self.root / "barriers" / name
        return d.is_dir() and not self._missing_members(d)

    # ----------------------------------------------- rank-0 value agreement

    def agree(self, key: str, compute_fn, timeout_s: float | None = None):
        """The LEADER (lowest live host id — rank 0 until rank 0 is
        evicted) computes and publishes a value; every other host waits
        for it and returns the same value.  The single-decider shape that
        keeps a torn NAS view (hosts disagreeing on ``latest_valid_epoch``)
        from restoring different snapshots on different hosts."""
        path = self.root / "agree" / f"{key}.json"
        if self.host == self.leader:
            value = compute_fn()
            _write_json(path, {"ts": self.clock(), "value": value})
            return value
        deadline = self.clock() + (
            self.timeout_s if timeout_s is None else timeout_s
        )
        while True:
            rec = _read_json(path)
            if rec is not None and "value" in rec:
                return rec["value"]
            ab = self.aborted()
            if ab is not None:
                raise PodAborted(ab)
            if self.clock() > deadline:
                raise BarrierTimeout(
                    f"host 0 never published agreement {key!r}"
                )
            self.sleep(self.poll_s)

    # ------------------------------------------------------------ finished

    def mark_finished(self, rc: int, reason: str = "complete") -> dict:
        """Stamp this launch as over (clean completion).  First writer
        wins, like ``abort``; ``acquire_launch`` treats a launch with
        either marker as closed, so a lone relaunched host can never
        join a completed run's stale barriers."""
        path = self.root / "finished.json"
        existing = _read_json(path)
        if existing is not None:
            return existing
        record = {
            "ts": self.clock(),
            "host": self.host,
            "reason": reason,
            "rc": int(rc),
        }
        _write_json(path, record)
        return record

    def finished(self) -> dict | None:
        return _read_json(self.root / "finished.json")

    # --------------------------------------------------------------- abort

    def abort(self, reason: str, rc: int) -> dict:
        """Pod-wide give-up.  First writer wins; later aborts keep the
        original record (one coherent story in the logs)."""
        path = self.root / "abort.json"
        existing = _read_json(path)
        if existing is not None:
            return existing
        record = {
            "ts": self.clock(),
            "host": self.host,
            "reason": reason,
            "rc": int(rc),
        }
        _write_json(path, record)
        return record

    def aborted(self) -> dict | None:
        return _read_json(self.root / "abort.json")


# ---------------------------------------------------------------------------
# run-scoped rendezvous state (launch-token subdirs)
# ---------------------------------------------------------------------------


def _launch_closed(root: Path) -> bool:
    return (root / "finished.json").is_file() or (root / "abort.json").is_file()


def _launch_stale(root: Path, stale_after_s: float) -> bool:
    """An OPEN launch whose markers have all gone silent: every
    heartbeat's writer-stamped ts (and the creation stamp) is older than
    ``stale_after_s``.  Such a launch is a dead pod's leftover — its
    supervisors crashed without closing it — and joining it would trust
    fully-arrived barriers no live peer will ever re-cross (the same
    hang ``acquire_launch`` scoping defused for CLOSED launches).  A
    launch with no markers at all is a peer mid-creation, not stale."""
    newest = None
    for p in (root / "hosts").glob("h*.json") if (
        root / "hosts"
    ).is_dir() else ():
        rec = _read_json(p)
        if rec is not None:
            ts = float(rec.get("ts", 0.0))
            newest = ts if newest is None else max(newest, ts)
    if newest is None:
        rec = _read_json(root / "launch.json")
        if rec is None:
            return False  # nothing written yet: a fresh launch, joinable
        newest = float(rec.get("ts", 0.0))
    return (time.time() - newest) > stale_after_s


def acquire_launch(
    pod_dir: str | os.PathLike,
    token: str | None = None,
    stale_after_s: float | None = None,
) -> Path:
    """The rendezvous root for THIS launch: a token subdir under
    ``<pod_dir>/launches/``, so one ``--pod`` directory can serve
    successive launches without stale markers crossing between them.

    The failure this closes (ROADMAP): the protocol's markers describe
    one pod lifetime, and with everything at the pod root a lone host
    relaunched after a COMPLETED run would sail through the previous
    run's fully-arrived start barrier and hang alone at its first
    collective.  Scoped, that host opens a *new* launch subdir (the old
    one carries ``finished.json``/``abort.json``), waits at a fresh
    start barrier its absent peers never arrive at, and aborts loudly.

    With an explicit ``token`` (the ``DDL_LAUNCH_TOKEN`` env —
    a scheduler incarnation id the operator guarantees is shared across
    hosts and fresh per launch) the subdir is exactly that token.
    Otherwise hosts agree leaderlessly: join the highest-numbered launch
    that is not yet closed, else atomically ``mkdir`` the next number —
    losers of the create race re-read and join the winner's.

    An UNFINISHED launch is only joinable while its markers are alive:
    heartbeat ages are re-validated first (``stale_after_s``, default
    ``DDL_LAUNCH_STALE_S`` env or 10 minutes), so a host restarted after
    every supervisor of a crashed pod is long gone opens a fresh launch
    (numbered path) or errors loudly (explicit token) instead of sailing
    into the dead pod's rendezvous state."""
    launches = Path(pod_dir) / "launches"
    launches.mkdir(parents=True, exist_ok=True)
    if stale_after_s is None:
        try:
            stale_after_s = float(
                os.environ.get(ENV_LAUNCH_STALE)
                or DEFAULT_LAUNCH_STALE_S
            )
        except ValueError:
            stale_after_s = DEFAULT_LAUNCH_STALE_S
    if token:
        d = launches / f"t-{token}"
        if _launch_closed(d):
            # same staleness the numbered path defuses: a host relaunched
            # with the finished run's token must not re-enter its barriers
            raise RuntimeError(
                f"launch token {token!r} names a finished/aborted launch "
                f"({d}) — DDL_LAUNCH_TOKEN must be fresh per launch; "
                "refusing to rejoin a closed run's rendezvous state"
            )
        if d.is_dir() and _launch_stale(d, stale_after_s):
            raise RuntimeError(
                f"launch token {token!r} names an open launch ({d}) whose "
                f"markers have been silent > {stale_after_s:.0f}s — the "
                "pod that owned it is gone.  Use a fresh DDL_LAUNCH_TOKEN "
                "(or raise DDL_LAUNCH_STALE_S if the pod is merely slow); "
                "refusing to trust a dead launch's barriers"
            )
        d.mkdir(exist_ok=True)
        return d
    while True:
        nums = sorted(
            int(p.name[1:]) for p in launches.glob("L*")
            if p.name[1:].isdigit()
        )
        cur = nums[-1] if nums else 0
        if cur:
            d = launches / f"L{cur:04d}"
            if not _launch_closed(d) and not _launch_stale(
                d, stale_after_s
            ):
                return d
        nxt = launches / f"L{cur + 1:04d}"
        try:
            nxt.mkdir()
        except FileExistsError:
            continue  # lost the create race: re-read, join the winner's
        _write_json(
            nxt / "launch.json",
            {"ts": time.time(), "creator_pid": os.getpid()},
        )
        return nxt


def active_launch_root(pod_dir: str | os.PathLike) -> Path | None:
    """The newest launch subdir of a ``--pod`` directory (for
    inspection/tests), or None when nothing ever launched there."""
    launches = Path(pod_dir) / "launches"
    if not launches.is_dir():
        return None
    dirs = [p for p in launches.iterdir() if p.is_dir()]
    # newest by creation order (mtime), so numbered and token launches
    # rank together
    return max(dirs, key=lambda p: p.stat().st_mtime, default=None)


# ---------------------------------------------------------------------------
# environment-driven entry points (trainer children, watchdog escalation)
# ---------------------------------------------------------------------------


def from_env(env=os.environ) -> Rendezvous | None:
    """The rendezvous this process belongs to, or None outside pod mode.
    ``supervise_pod_command`` sets the env for both the supervisor's own
    helpers and the trainer child it spawns.  ``DDL_COORD_MEMBERS``
    (set after an elastic scale-down) restricts barriers/agreement to
    the surviving hosts while ids keep their original numbering."""
    root = env.get(ENV_DIR)
    if not root:
        return None
    n_hosts = int(env.get(ENV_HOSTS) or 1)
    host = int(env.get(ENV_HOST) or env.get("DDL_HOST_ID") or 0)
    timeout = float(env.get(ENV_TIMEOUT) or DEFAULT_TIMEOUT_S)
    members = None
    raw = env.get(ENV_MEMBERS)
    if raw:
        try:
            members = [int(x) for x in raw.split(",") if x.strip() != ""]
        except ValueError:
            members = None  # malformed: fall back to full membership
    return Rendezvous(
        root, host, n_hosts, timeout_s=timeout, members=members
    )


def restart_epoch(env=os.environ) -> int:
    """The pod restart epoch this process was launched under (0 for the
    initial launch / non-pod runs) — stamped into obs metadata."""
    try:
        return int(env.get(ENV_EPOCH) or 0)
    except ValueError:
        return 0


def publish_exit_intent_from_env(reason: str, rc: int) -> bool:
    """Best-effort exit-intent publication for escalation paths that are
    about to hard-exit (the stall watchdog's ``os._exit(75)``): peers'
    supervisors react to the marker instead of waiting for this host's
    heartbeat to age out.  No-op outside pod mode; NOTHING here may
    escape — the caller is about to ``os._exit`` a wedged process, and
    an exception (unwritable NAS, malformed env) that aborts the
    escalation leaves the hang this path exists to break."""
    try:
        rv = from_env()
        if rv is None:
            return False
        rv.publish_intent(reason, rc, restart_epoch())
        return True
    # deliberate catch-all: see the docstring; failing to publish must
    # degrade to heartbeat-ageout detection, never to a live hang
    except Exception:
        return False


def agreed_resume_epoch(job_id: str, compute_fn):
    """Pod-consistent resume target: rank 0 computes (its view of
    ``checkpoint.latest_valid_epoch``) and publishes through the
    rendezvous; every host restores the same snapshot.  Scoped by restart
    epoch so each coordinated relaunch re-agrees against the then-current
    snapshot store.  Falls back to the local computation outside pod mode
    or on a single-host pod."""
    rv = from_env()
    if rv is None or rv.world < 2:
        return compute_fn()
    key = f"resume-{job_id}-e{restart_epoch()}"
    return rv.agree(key, compute_fn)


def agreed_rollback_epoch(job_id: str, compute_fn, seq: int):
    """Pod-consistent IN-LOOP rollback target (the NaN-recovery path):
    the leader computes which snapshot to roll back to and publishes it;
    every host restores the same one.  The same single-decider shape as
    ``agreed_resume_epoch``, but rollback can fire repeatedly within one
    incarnation and ``agree`` keys are write-once — so the key carries a
    per-process rollback sequence number.  ``seq`` is identical across
    hosts because the rollback decision is SPMD: every host sees the
    same non-finite loss at the same step, so their counters advance in
    lock-step.  Falls back to the local computation outside pod mode."""
    rv = from_env()
    if rv is None or rv.world < 2:
        return compute_fn()
    key = f"rollback-{job_id}-e{restart_epoch()}-{int(seq)}"
    return rv.agree(key, compute_fn)
