"""The port's pod coordination (ddl_tpu_torch/coord.py + PodSupervisor)
held to the JAX package's.

The port's copies of ``tests/test_coord.py``'s unit and supervisor tests,
run against ``ddl_tpu_torch.coord`` and ``ddl_tpu_torch.supervisor``: the
rendezvous primitives (barrier, stale-peer ageout, split-brain-free
restart-epoch proposal under a real race, the leader's resume agreement)
and the PodSupervisor protocol driven by scripted fake children over one
tmpdir standing in for the shared directory.  Then the two packages in
one pod: a JAX host's and a port host's Rendezvous in one directory race
one restart proposal, complete one barrier and read each other's
agreement and abort markers; and the same scripted children fed to the
JAX PodSupervisor and the port's (backoff jitter 0, a fake supervisor
clock) give the same epoch ledger and the same supervisor event kinds.
The three process-level simulations are in test_torch_pod_sim.py.
"""

import json
import threading
import time
from pathlib import Path

import pytest

from ddl_tpu_torch.coord import (
    BarrierTimeout,
    Rendezvous,
    agreed_resume_epoch,
    from_env,
)
from ddl_tpu_torch.supervisor import EXIT_PREEMPTED, EXIT_REJOIN, PodSupervisor
from ddl_tpu_torch.utils.backoff import Backoff


def _rv(root, host, n, **kw):
    kw.setdefault("timeout_s", 10.0)
    kw.setdefault("poll_s", 0.005)
    return Rendezvous(root, host, n, **kw)


# ---------------------------------------------------------------------------
# rendezvous primitives
# ---------------------------------------------------------------------------


def test_barrier_completes_when_all_arrive(tmp_path):
    done = []

    def host(i):
        rv = _rv(tmp_path, i, 3)
        rv.barrier("go")
        done.append(i)

    threads = [threading.Thread(target=host, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert sorted(done) == [0, 1, 2]


def test_barrier_times_out_when_a_peer_never_arrives(tmp_path):
    rv = _rv(tmp_path, 0, 2, timeout_s=0.2)
    with pytest.raises(BarrierTimeout, match="1/2 hosts"):
        rv.barrier("lonely")


def test_stale_peer_ageout_only_for_running_hosts(tmp_path):
    a, b, c = _rv(tmp_path, 0, 3), _rv(tmp_path, 1, 3), _rv(tmp_path, 2, 3)
    b.publish_heartbeat("running", 0)
    c.publish_heartbeat("done", 0)
    time.sleep(0.15)
    # b aged out while "running"; c is parked "done" and never stale
    assert a.stale_peers(0.1) == [1]
    assert a.stale_peers(10.0) == []
    b.publish_heartbeat("running", 0)  # a fresh beat clears it
    assert a.stale_peers(0.1) == []


def test_membership_scopes_barriers_peers_and_agreement(tmp_path):
    """Elastic membership: barriers complete over the LIVE member set,
    evicted hosts' heartbeats go invisible, and the agreement leader is
    the lowest surviving id."""
    a = _rv(tmp_path, 0, 3)
    c = _rv(tmp_path, 2, 3)
    # host 1 beat once, then was evicted
    _rv(tmp_path, 1, 3).publish_heartbeat("running", 0)
    a.adopt_membership([0, 2])
    c.adopt_membership([0, 2])
    assert a.world == 2 and a.leader == 0 and a.members == (0, 2)
    time.sleep(0.15)
    assert a.stale_peers(0.1) == []  # the casualty is not re-judged
    # a 2-member barrier completes without host 1
    done = []

    def arrive(rv):
        rv.barrier("shrunk")
        done.append(rv.host)

    t = threading.Thread(target=arrive, args=(c,))
    t.start()
    arrive(a)
    t.join(timeout=10)
    assert sorted(done) == [0, 2]
    assert sorted(a.barrier_arrivals("shrunk")) == [0, 2]
    # eviction is loud: an excluded host cannot adopt the membership
    with pytest.raises(ValueError, match="evicted"):
        _rv(tmp_path, 1, 3).adopt_membership([0, 2])


def test_restart_epoch_proposal_is_split_brain_free(tmp_path):
    """N hosts racing to propose the same restart epoch converge on ONE
    record: one proposer, one cumulative crash count, one agreed
    delay."""
    records = {}

    def propose(i):
        rv = _rv(tmp_path, i, 4)
        records[i] = rv.propose_restart(
            0, reason=f"crash-h{i}", crash=True, preempt=False,
            delay_fn=lambda c: 1.0 + i,  # would differ per host if raced
        )

    threads = [threading.Thread(target=propose, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len({r["proposer"] for r in records.values()}) == 1
    assert len({r["delay"] for r in records.values()}) == 1
    for r in records.values():
        assert r["epoch"] == 1
        assert r["crashes"] == 1  # one restart event, counted once
    # the ledger rolls counts forward epoch over epoch
    rv = _rv(tmp_path, 0, 4)
    rec2 = rv.propose_restart(1, "crash", crash=True, preempt=False)
    assert rec2["epoch"] == 2 and rec2["crashes"] == 2


def test_rank0_resume_agreement_overrides_divergent_views(tmp_path, monkeypatch):
    """Torn-NAS shape: hosts compute different latest_valid_epoch; every
    host must restore rank 0's answer."""
    values = {0: 12, 1: 4}  # host 1's local view lags (torn write)
    got = {}

    def host(i):
        rv = _rv(tmp_path, i, 2)
        got[i] = rv.agree("resume-job-e1", lambda: values[i])

    t1 = threading.Thread(target=host, args=(1,))
    t1.start()
    time.sleep(0.05)  # host 1 is already waiting when rank 0 decides
    host(0)
    t1.join(timeout=10)
    assert got == {0: 12, 1: 12}

    # the env-driven wrapper used by checkpoint.resolve_resume
    monkeypatch.setenv("DDL_COORD_DIR", str(tmp_path))
    monkeypatch.setenv("DDL_COORD_HOSTS", "2")
    monkeypatch.setenv("DDL_COORD_HOST", "0")
    monkeypatch.setenv("DDL_RESTART_EPOCH", "2")
    assert from_env().host == 0
    assert agreed_resume_epoch("job", lambda: 7) == 7
    monkeypatch.setenv("DDL_COORD_HOST", "1")
    assert agreed_resume_epoch("job", lambda: 3) == 7  # rank 0's answer
    monkeypatch.delenv("DDL_COORD_DIR")
    assert from_env() is None
    assert agreed_resume_epoch("job", lambda: 5) == 5  # non-pod fallback


def test_abort_is_pod_wide_and_first_writer_wins(tmp_path):
    a, b = _rv(tmp_path, 0, 2), _rv(tmp_path, 1, 2)
    rec = a.abort("crash budget exhausted", 9)
    assert b.aborted()["rc"] == 9
    # a later abort keeps the original story
    assert b.abort("something else", 3)["reason"] == "crash budget exhausted"
    assert rec["host"] == 0


# ---------------------------------------------------------------------------
# PodSupervisor protocol (scripted fake children, threads as hosts)
# ---------------------------------------------------------------------------


class FakeChild:
    """Scripted child: exits ``rc`` after ``delay`` seconds, or hangs
    forever (rc=None) until terminated."""

    def __init__(self, rc=None, delay=0.05):
        self.rc = rc
        self.delay = delay
        self.t0 = time.monotonic()
        self.killed = False

    def poll(self):
        if self.killed:
            return -15
        if self.rc is None:
            return None
        return self.rc if time.monotonic() - self.t0 >= self.delay else None

    def terminate(self):
        self.killed = True

    kill = terminate

    def wait(self, timeout=None):
        return self.poll()


def _run_pod(tmp_path, scripts, n_hosts=None, events=None, **sup_kwargs):
    """Run one PodSupervisor per host in threads; ``scripts[i]`` is the
    list of children host i spawns, in order.  Returns {host: exit}."""
    n_hosts = n_hosts if n_hosts is not None else len(scripts)
    sup_kwargs.setdefault("backoff", Backoff(base=0.01, jitter=0.0))
    results = {}
    sups = {}

    def host(i):
        rv = _rv(tmp_path, i, n_hosts)
        it = iter(scripts[i])
        sup = PodSupervisor(
            lambda epoch, idx: next(it), rv,
            poll_s=0.005, heartbeat_s=0.02, stale_after_s=30.0,
            log=lambda m: None,
            events=(events or {}).get(i),
            **sup_kwargs,
        )
        sups[i] = sup
        results[i] = sup.run()

    threads = [
        threading.Thread(target=host, args=(i,)) for i in range(len(scripts))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads), "pod deadlocked"
    return results


def test_pod_completes_when_all_children_succeed(tmp_path):
    results = _run_pod(tmp_path, [[FakeChild(rc=0)], [FakeChild(rc=0)]])
    assert results == {0: 0, 1: 0}
    assert _rv(tmp_path, 0, 2).current_epoch() == 0  # no restart proposed


def test_one_crash_restarts_every_host_in_the_same_epoch(tmp_path):
    """Host 1 crashes; host 0's healthy child (hanging mid-'collective')
    is killed and both hosts relaunch together in restart epoch 1."""
    h0 = [FakeChild(rc=None), FakeChild(rc=0)]
    results = _run_pod(tmp_path, [h0, [FakeChild(rc=1), FakeChild(rc=0)]])
    assert results == {0: 0, 1: 0}
    assert h0[0].killed  # the healthy child was killed, not abandoned
    rv = _rv(tmp_path, 0, 2)
    assert rv.current_epoch() == 1
    rec = rv.epoch_record(1)
    assert rec["crashes"] == 1 and rec["reason"].endswith("crash")


def test_completed_host_rejoins_a_restart_proposed_while_it_waits(tmp_path):
    """Host 0 finishes its run; host 1 then crashes.  Host 0 must leave
    the done barrier and retrain — the resumed collective needs every
    host."""
    h0 = [FakeChild(rc=0, delay=0.01), FakeChild(rc=0)]
    h1 = [FakeChild(rc=1, delay=0.3), FakeChild(rc=0)]
    results = _run_pod(tmp_path, [h0, h1])
    assert results == {0: 0, 1: 0}
    assert _rv(tmp_path, 0, 2).current_epoch() == 1


def test_resumable_exits_do_not_consume_the_crash_budget(tmp_path):
    h0 = [FakeChild(rc=EXIT_PREEMPTED, delay=0.01), FakeChild(rc=0)]
    h1 = [FakeChild(rc=None), FakeChild(rc=0)]
    results = _run_pod(tmp_path, [h0, h1], max_restarts=0)
    assert results == {0: 0, 1: 0}  # survives despite a zero crash budget
    rec = _rv(tmp_path, 0, 2).epoch_record(1)
    assert rec["crashes"] == 0 and rec["preemptions"] == 1
    assert rec["delay"] == 0.0  # preemptions relaunch without backoff


def test_crash_budget_exhaustion_aborts_the_whole_pod(tmp_path):
    h0 = [FakeChild(rc=None), FakeChild(rc=None)]
    h1 = [FakeChild(rc=7, delay=0.01), FakeChild(rc=7, delay=0.01)]
    results = _run_pod(tmp_path, [h0, h1], max_restarts=1)
    # both hosts exit with the crashing host's code, not just the crasher
    assert results == {0: 7, 1: 7}
    ab = _rv(tmp_path, 0, 2).aborted()
    assert ab is not None and "crash budget" in ab["reason"]


def test_stale_peer_triggers_escalation_not_eternal_hang(tmp_path):
    """Host 1's supervisor dies silently (no heartbeat, child hangs).
    Host 0 must detect the aged-out heartbeat, attempt a coordinated
    restart, and — when the dead peer never joins the barrier — abort
    rather than hang forever."""
    rv1 = _rv(tmp_path, 1, 2)
    rv1.arrive("start")  # host 1 made the start barrier...
    rv1.publish_heartbeat("running", 0)  # ...beat once, then died

    rv0 = _rv(tmp_path, 0, 2, timeout_s=0.5)
    child = FakeChild(rc=None)
    sup = PodSupervisor(
        lambda epoch, idx: child, rv0,
        poll_s=0.005, heartbeat_s=0.02, stale_after_s=0.1,
        backoff=Backoff(base=0.01, jitter=0.0), log=lambda m: None,
    )
    rc = sup.run()
    assert rc != 0
    assert child.killed
    ab = rv0.aborted()
    assert ab is not None and "join" in ab["reason"]


def test_pod_supervisor_emits_coordination_events(tmp_path):
    from ddl_tpu_torch.obs import EventWriter, read_events

    w0 = EventWriter(tmp_path / "logs", "podjob", host=0)
    results = _run_pod(
        tmp_path / "nas",
        [[FakeChild(rc=None), FakeChild(rc=0)],
         [FakeChild(rc=1, delay=0.01), FakeChild(rc=0)]],
        events={0: w0},
    )
    assert results == {0: 0, 1: 0}
    w0.close()
    events = read_events(w0.path)
    kinds = [e["kind"] for e in events]
    assert kinds[0] == "supervisor_start"
    assert "coord_barrier" in kinds and "pod_restart" in kinds
    restart = next(e for e in events if e["kind"] == "pod_restart")
    # either host may win the proposal race; the classification must
    # still be the crash (reason "crash" from the crasher itself or
    # "peer_crash" from the bystander that saw its intent)
    assert restart["epoch"] == 1 and restart["reason"].endswith("crash")
    assert kinds[-1] == "supervisor_done"


# ---------------------------------------------------------------------------
# elastic mode: continue on N-1 (scripted fake children)
# ---------------------------------------------------------------------------


def test_elastic_stale_peer_evicted_after_grace_and_pod_continues(tmp_path):
    """Host 1's supervisor dies permanently right after the start
    barrier.  The elastic survivors hold the eviction grace, then agree
    restart epoch 1 with membership [0, 2] / world 2 — and finish as a
    2-host pod instead of aborting."""
    rv1 = _rv(tmp_path, 1, 3)
    rv1.arrive("start")
    rv1.publish_heartbeat("running", 0)  # beat once, then silence

    scripts = {0: [FakeChild(rc=None), FakeChild(rc=0)],
               2: [FakeChild(rc=None), FakeChild(rc=0)]}
    results = {}

    def host(i):
        rv = _rv(tmp_path, i, 3)
        it = iter(scripts[i])
        sup = PodSupervisor(
            lambda epoch, idx: next(it), rv,
            poll_s=0.005, heartbeat_s=0.02,
            stale_after_s=0.15, elastic=True, elastic_grace_s=0.2,
            backoff=Backoff(base=0.01, jitter=0.0), log=lambda m: None,
        )
        results[i] = sup.run()

    threads = [threading.Thread(target=host, args=(i,)) for i in (0, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads), "elastic pod deadlocked"
    assert results == {0: 0, 2: 0}
    # the epoch-0 children (hung in the dead host's collective) were
    # killed, not abandoned
    assert scripts[0][0].killed and scripts[2][0].killed
    rv = _rv(tmp_path, 0, 3)
    assert rv.aborted() is None
    assert rv.current_epoch() == 1
    rec = rv.epoch_record(1)
    assert rec["reason"] == "peer_lost"
    assert rec["hosts"] == [0, 2] and rec["world"] == 2
    # an eviction is a preemption-class event, never a crash
    assert rec["crashes"] == 0 and rec["preemptions"] == 1


def test_elastic_join_barrier_timeout_scales_down_to_arrivals(tmp_path):
    """The second eviction route: a peer whose child crashed and whose
    supervisor then died never reaches the join barrier.  The arrived
    host proposes the NEXT epoch over the arrivals and continues
    alone."""
    rv1 = _rv(tmp_path, 1, 2)
    rv1.arrive("start")
    rv1.publish_heartbeat("running", 0)
    rv1.publish_intent("crash", 1, 0)  # child died; supervisor died too

    child0, child1 = FakeChild(rc=None), FakeChild(rc=0)
    it = iter([child0, child1])
    rv0 = _rv(tmp_path, 0, 2, timeout_s=0.4)
    sup = PodSupervisor(
        lambda epoch, idx: next(it), rv0,
        poll_s=0.005, heartbeat_s=0.02, stale_after_s=30.0,
        elastic=True,
        backoff=Backoff(base=0.01, jitter=0.0), log=lambda m: None,
    )
    assert sup.run() == 0
    assert child0.killed
    assert rv0.aborted() is None
    # epoch 1 = the crash restart (full membership, budget consumed);
    # epoch 2 = the join-timeout eviction (membership [0])
    assert rv0.current_epoch() == 2
    rec1, rec2 = rv0.epoch_record(1), rv0.epoch_record(2)
    assert rec1["crashes"] == 1
    assert rec2["reason"] == "peer_lost"
    assert rec2["hosts"] == [0] and rec2["world"] == 1
    assert rec2["crashes"] == 1  # rolled forward, not re-counted


def test_evicted_host_exits_cleanly_instead_of_aborting(tmp_path):
    """A live-but-slow host that catches up after the survivors already
    scaled down must exit 0 (evicted), never abort the pod out from
    under them."""
    from ddl_tpu_torch.obs import EventWriter, read_events

    w1 = EventWriter(tmp_path / "logs", "evictjob", host=1)
    scripts = {
        0: [FakeChild(rc=1, delay=0.05), FakeChild(rc=0)],
        1: [FakeChild(rc=None), FakeChild(rc=None)],
    }
    results = {}

    def host(i):
        rv = _rv(
            tmp_path / "nas", i, 2,
            timeout_s=(0.4 if i == 0 else 10.0),
        )
        it = iter(scripts[i])
        sup = PodSupervisor(
            lambda epoch, idx: next(it), rv,
            poll_s=0.005, heartbeat_s=0.02, stale_after_s=30.0,
            # host 1 keeps heartbeating but is slow to see signals, so
            # it misses host 0's join barrier (the barrier route, not
            # the staleness route)
            signal_poll_s=(0.05 if i == 0 else 1.5),
            elastic=True,
            backoff=Backoff(base=0.01, jitter=0.0), log=lambda m: None,
            events=(w1 if i == 1 else None),
        )
        results[i] = sup.run()

    threads = [threading.Thread(target=host, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads), "evict sim deadlocked"
    # BOTH exit 0: host 0 finished the run alone, host 1 was evicted
    assert results == {0: 0, 1: 0}
    w1.close()
    rv = _rv(tmp_path / "nas", 0, 2)
    assert rv.aborted() is None
    final = rv.epoch_record(rv.current_epoch())
    assert final["hosts"] == [0]
    done = [e for e in read_events(w1.path)
            if e["kind"] == "supervisor_done"]
    assert done and done[-1]["rc"] == 0 and done[-1].get("evicted") is True


def test_join_request_intake_filters_members_and_stale(tmp_path):
    """The leader's view of ``joins/``: a non-member's marker surfaces
    with an age, a member's own leftover marker is void, out-of-range
    hosts are ignored, and stale markers (a joiner that died mid-wait)
    are dropped under ``fresh_s``."""
    rv0 = _rv(tmp_path, 0, 3)
    rv0.adopt_membership([0, 2])  # host 1 was evicted earlier
    rv1 = _rv(tmp_path, 1, 3)
    assert rv0.join_requests() == []
    rv1.publish_join_request(1, note="back")
    (req,) = rv0.join_requests()
    assert req["host"] == 1 and req["epoch"] == 1
    assert req["age"] >= 0.0 and req["note"] == "back"
    # a member's leftover marker is void by definition
    rv2 = _rv(tmp_path, 2, 3)
    rv2.adopt_membership([0, 2])
    rv2.publish_join_request(1)
    assert [r["host"] for r in rv0.join_requests()] == [1]
    # a host outside this launch's [0, n_hosts) is ignored
    (tmp_path / "joins" / "h099.json").write_text(
        json.dumps({"ts": rv0.clock(), "host": 99, "epoch": 0})
    )
    assert [r["host"] for r in rv0.join_requests()] == [1]
    # a stale marker means the joiner went silent after asking
    (tmp_path / "joins" / "h001.json").write_text(
        json.dumps({"ts": rv0.clock() - 60.0, "host": 1, "epoch": 1})
    )
    assert rv0.join_requests(fresh_s=5.0) == []
    assert [r["host"] for r in rv0.join_requests()] == [1]  # unbounded
    # refreshing the marker (the joiner's heartbeat analogue) revives it
    rv1.publish_join_request(2)
    assert [r["host"] for r in rv0.join_requests(fresh_s=5.0)] == [1]
    rv1.clear_join_request()
    assert rv0.join_requests() == []


def test_grow_epoch_ledger_rides_first_writer_wins(tmp_path):
    """A grow proposal is the same atomically-created ledger record as
    a shrink: budgets roll forward unchanged, the record carries the
    LARGER host set, and a racing proposer adopts the winner."""
    rv = _rv(tmp_path, 0, 3)
    rec1 = rv.propose_restart(
        0, "peer_lost", crash=False, preempt=True, rc=EXIT_PREEMPTED,
        hosts=[0, 2],
    )
    rv.adopt_membership(rec1["hosts"])
    assert rv.world == 2
    rec2 = rv.propose_restart(
        1, "peer_join", crash=False, preempt=False, rc=EXIT_PREEMPTED,
        hosts=[0, 1, 2],
    )
    assert rec2["hosts"] == [0, 1, 2] and rec2["world"] == 3
    # a grow is neither a crash nor a preemption; budgets roll forward
    assert rec2["crashes"] == 0 and rec2["preemptions"] == 1
    assert rec2["delay"] == 0.0  # growth relaunches without backoff
    # a racing proposer still on the shrunken membership loses the race
    # and adopts the grown record unchanged (one restart event, one
    # classification — even when the racers disagreed on the reason)
    rv2 = _rv(tmp_path, 2, 3)
    rv2.adopt_membership([0, 2])
    won = rv2.propose_restart(
        1, "peer_stale/crash", crash=True, preempt=False,
        delay_fn=lambda n: 9.9,
    )
    assert won == rec2
    rv2.adopt_membership(won["hosts"])
    assert rv2.world == 3 and rv2.leader == 0


def test_elastic_rejoin_child_leaves_and_is_grown_back(tmp_path):
    """The full scripted grow cycle: host 1's child exits EXIT_REJOIN
    (a voluntary leave, e.g. an injected ``rejoin`` fault), the pod
    shrinks to [0], host 1's supervisor publishes a join_request from
    ``_await_rejoin``, and the leader answers with a ``peer_join``
    epoch whose membership is [0, 1] again.  Both hosts finish at the
    grown world; no budget was burned at any step."""
    scripts = {
        # epoch-0 child killed at the rejoin intent; epoch-1 child
        # (world [0]) killed at the peer_join; epoch-2 child completes
        0: [FakeChild(rc=None), FakeChild(rc=None), FakeChild(rc=0)],
        # epoch-0 child leaves voluntarily; host 1 is not a member of
        # epoch 1, so its next child runs in epoch 2
        1: [FakeChild(rc=EXIT_REJOIN, delay=0.05), FakeChild(rc=0)],
    }
    results = _run_pod(
        tmp_path, [scripts[0], scripts[1]], elastic=True, max_restarts=0,
    )
    assert results == {0: 0, 1: 0}
    assert scripts[0][0].killed and scripts[0][1].killed
    rv = _rv(tmp_path, 0, 2)
    assert rv.aborted() is None
    assert rv.current_epoch() == 2
    rec1, rec2 = rv.epoch_record(1), rv.epoch_record(2)
    assert rec1["reason"] in ("rejoin", "peer_rejoin")
    assert rec1["hosts"] == [0] and rec1["world"] == 1
    assert rec1["rc"] == EXIT_REJOIN
    assert rec1["crashes"] == 0 and rec1["preemptions"] == 0
    assert rec2["reason"] == "peer_join"
    assert rec2["hosts"] == [0, 1] and rec2["world"] == 2
    assert rec2["crashes"] == 0 and rec2["preemptions"] == 0
    # the joiner withdrew its marker once the grow epoch admitted it
    assert rv.join_requests() == []


# ---------------------------------------------------------------------------
# one pod, both packages: the marker files are the protocol
# ---------------------------------------------------------------------------


def _mixed(tmp_path, **kw):
    """Host 0 on the JAX package's Rendezvous, host 1 on the port's, over
    one directory."""
    from ddl_tpu import coord as jax_coord

    kw.setdefault("timeout_s", 10.0)
    kw.setdefault("poll_s", 0.005)
    return jax_coord.Rendezvous(tmp_path, 0, 2, **kw), Rendezvous(tmp_path, 1, 2, **kw)


def test_mixed_pod_races_one_restart_record(tmp_path):
    """A JAX host and a port host propose restart epoch 1 at once: one
    record wins, both return it, and either package reads it back."""
    hosts = _mixed(tmp_path)
    got, go = {}, threading.Barrier(2)

    def propose(rv):
        go.wait(timeout=10)
        got[rv.host] = rv.propose_restart(
            0, reason=f"crash-h{rv.host}", crash=True, preempt=False,
            delay_fn=lambda c, h=rv.host: 1.0 + h)

    threads = [threading.Thread(target=propose, args=(rv,)) for rv in hosts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert got[0] == got[1]
    assert got[0]["epoch"] == 1 and got[0]["crashes"] == 1
    assert got[0]["delay"] == 1.0 + got[0]["proposer"]
    assert all(rv.epoch_record(1) == got[0] and rv.current_epoch() == 1 for rv in hosts)
    assert len(list((tmp_path / "epochs").glob("e*.json"))) == 1


def test_mixed_pod_completes_one_barrier(tmp_path):
    done = {}

    def arrive(rv):
        done[rv.host] = rv.barrier("e1-join")

    threads = [threading.Thread(target=arrive, args=(rv,)) for rv in _mixed(tmp_path)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert sorted(done) == [0, 1]
    assert sorted(_rv(tmp_path, 1, 2).barrier_arrivals("e1-join")) == [0, 1]


def test_mixed_pod_reads_each_others_agreement_and_abort(tmp_path):
    """Whichever package leads, the other's host reads its ``agree``
    value; an abort written by either stops the other's barrier."""
    from ddl_tpu import coord as jax_coord
    from ddl_tpu_torch.coord import PodAborted

    def agree_pair(leader, follower, key, value):
        got = {}
        t = threading.Thread(target=lambda: got.update(
            follower=follower.agree(key, lambda: "the follower's own view")))
        t.start()
        time.sleep(0.05)  # the follower already waits when the leader decides
        got["leader"] = leader.agree(key, lambda: value)
        t.join(timeout=10)
        assert not t.is_alive()
        return got

    jax_rv, port_rv = _mixed(tmp_path)
    assert agree_pair(jax_rv, port_rv, "resume-job-e1", 12) == {"leader": 12, "follower": 12}
    port_leader = Rendezvous(tmp_path, 0, 2, timeout_s=10.0, poll_s=0.005)
    jax_follower = jax_coord.Rendezvous(tmp_path, 1, 2, timeout_s=10.0, poll_s=0.005)
    want = {"coordinator": "h0:1234", "world": 4, "local": 2, "hosts": [0, 1]}
    assert agree_pair(port_leader, jax_follower, "coordinator-e2", want) == {
        "leader": want, "follower": want}

    rec = port_rv.abort("crash budget exhausted", 9)
    assert jax_rv.aborted() == rec
    with pytest.raises(jax_coord.PodAborted):
        jax_rv.barrier("never")
    assert jax_rv.abort("other", 3)["reason"] == "crash budget exhausted"
    (tmp_path / "abort.json").unlink()
    jax_rv.abort("jax gave up", 7)
    with pytest.raises(PodAborted) as e:
        port_rv.barrier("never2")
    assert e.value.record["rc"] == 7 and e.value.record["host"] == 0


# ---------------------------------------------------------------------------
# the same scripted children through the JAX PodSupervisor and the port's
# ---------------------------------------------------------------------------


class Recorder:
    """An events sink keeping the kinds a supervisor emits, in order."""

    def __init__(self):
        self.kinds = []

    def emit(self, kind, **fields):
        self.kinds.append(kind)

    def close(self):
        pass


class VirtualClock:
    """A supervisor's monotonic clock in virtual time: a sleep advances it
    and yields the thread for a real moment, so the poll and heartbeat
    cadences and the agreed backoff delays cost no wall time."""

    def __init__(self):
        self.t = 0.0

    def clock(self):
        return self.t

    def sleep(self, dt):
        self.t += dt
        time.sleep(0.002)


# host -> the children it spawns in order, the PodSupervisor options
# (host -> extra options), and the hosts that die after one heartbeat
SCRIPTS = {
    # host 1 crashes; host 0 (its child hung in the collective) looks for
    # signals slowly, so the crasher's proposal is the one it adopts
    "crash": (lambda: {0: [FakeChild(rc=None), FakeChild(rc=0)],
                       1: [FakeChild(rc=1, delay=0.05), FakeChild(rc=0)]},
              {}, {0: dict(signal_poll_s=0.3)}, ()),
    "resumable-exit": (lambda: {0: [FakeChild(rc=EXIT_PREEMPTED, delay=0.05), FakeChild(rc=0)],
                                1: [FakeChild(rc=None), FakeChild(rc=0)]},
                       dict(max_restarts=0), {1: dict(signal_poll_s=0.3)}, ()),
    "crash-budget": (lambda: {0: [FakeChild(rc=None), FakeChild(rc=None)],
                              1: [FakeChild(rc=7, delay=0.05), FakeChild(rc=7, delay=0.05)]},
                     dict(max_restarts=1), {0: dict(signal_poll_s=0.3)}, ()),
    # host 1 made the start barrier, beat once and died
    "stale-peer": (lambda: {0: [FakeChild(rc=None)]},
                   dict(stale_after_s=0.1), {}, (1,)),
    "rejoin": (lambda: {0: [FakeChild(rc=None), FakeChild(rc=None), FakeChild(rc=0)],
                        1: [FakeChild(rc=EXIT_REJOIN, delay=0.05), FakeChild(rc=0)]},
               dict(elastic=True, max_restarts=0), {0: dict(signal_poll_s=0.3)}, ()),
}
LEDGER_FIELDS = ("epoch", "reason", "crashes", "preemptions", "hosts", "world", "delay", "rc")


def _scripted_pod(pkg: str, name: str, root: Path):
    """Run ``SCRIPTS[name]`` with ``pkg``'s PodSupervisor, Rendezvous and
    Backoff (jitter 0); returns each host's exit code and event kinds, the
    epoch ledger and the abort record."""
    if pkg == "jax":
        from ddl_tpu import coord as c
        from ddl_tpu import supervisor as s
        from ddl_tpu.utils.backoff import Backoff as B
    else:
        from ddl_tpu_torch import coord as c
        from ddl_tpu_torch import supervisor as s
        from ddl_tpu_torch.utils.backoff import Backoff as B
    make, common, per_host, dead = SCRIPTS[name]
    scripts = make()
    n = len(scripts) + len(dead)
    rv_timeout = 0.5 if dead else 10.0
    for h in dead:
        rv = c.Rendezvous(root, h, n, timeout_s=rv_timeout, poll_s=0.005)
        rv.arrive("start")
        rv.publish_heartbeat("running", 0)
    results, kinds = {}, {}

    def host(i):
        vc, events = VirtualClock(), Recorder()
        kinds[i] = events.kinds
        it = iter(scripts[i])
        opts = dict(poll_s=0.005, heartbeat_s=0.02, stale_after_s=30.0,
                    backoff=B(base=0.01, jitter=0.0), clock=vc.clock, sleep=vc.sleep,
                    log=lambda m: None, events=events)
        opts.update(common)
        opts.update(per_host.get(i, {}))
        sup = s.PodSupervisor(lambda epoch, idx: next(it),
                              c.Rendezvous(root, i, n, timeout_s=rv_timeout, poll_s=0.005),
                              **opts)
        results[i] = sup.run()

    threads = [threading.Thread(target=host, args=(i,)) for i in scripts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads), f"{pkg} {name}: pod deadlocked"
    rv = c.Rendezvous(root, 0, n)
    ledger = [{k: rv.epoch_record(e).get(k) for k in LEDGER_FIELDS}
              for e in range(1, rv.current_epoch() + 1)]
    abort = rv.aborted()
    return results, kinds, ledger, abort and {k: abort[k] for k in ("reason", "rc")}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_scripted_children_give_the_jax_supervisors_ledger(name, tmp_path):
    """The same scripted children (a crash, a resumable exit, a crash
    budget spent, a stale peer, an elastic leave-and-rejoin) through the
    JAX PodSupervisor and the port's: the same exit codes, the same epoch
    ledger (reason, budgets, membership, agreed delay, exit code), the
    same abort record and the same supervisor event kinds on every host."""
    want = _scripted_pod("jax", name, tmp_path / "jax")
    got = _scripted_pod("port", name, tmp_path / "port")
    assert got == want
    assert want[2], "the scenario proposed no restart epoch"


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_watchdog_escalation_publishes_the_exit_intent_first(pkg, tmp_path, monkeypatch):
    """Under the pod's environment a stalled step's watchdog writes this
    host's exit intent (``watchdog_stall``, 75, the restart epoch) before
    it exits, in both packages alike."""
    if pkg == "jax":
        from ddl_tpu.obs import EventWriter as W
        from ddl_tpu.obs.watchdog import Watchdog
    else:
        from ddl_tpu_torch.obs import EventWriter as W
        from ddl_tpu_torch.obs.watchdog import Watchdog
    root = tmp_path / pkg
    monkeypatch.setenv("DDL_COORD_DIR", str(root))
    monkeypatch.setenv("DDL_COORD_HOSTS", "2")
    monkeypatch.setenv("DDL_COORD_HOST", "1")
    monkeypatch.setenv("DDL_RESTART_EPOCH", "3")
    seen = []

    def exit_fn(code):
        seen.append((code, sorted(p.name for p in (root / "intents").iterdir())))

    writer = W(tmp_path / f"logs-{pkg}", "wd", host=1)
    wd = Watchdog(writer, deadline_s=0.05, interval_s=0.01, on_stall="exit", exit_fn=exit_fn)
    with wd:
        deadline = time.monotonic() + 10
        while not seen and time.monotonic() < deadline:
            time.sleep(0.01)
    writer.close()
    assert seen and seen[0] == (75, ["h001.e3.json"])
    rec = json.loads((root / "intents" / "h001.e3.json").read_text())
    assert (rec["host"], rec["reason"], rec["rc"], rec["epoch"]) == (1, "watchdog_stall", 75, 3)
