"""Process-level pod simulations of the port (ddl_tpu_torch/coord.py,
supervisor.PodSupervisor, launch.run_pod_host) on the CPU.

The port's copies of ``tests/test_coord.py``'s three pod simulations: real
tiny-LM trainer children (``tests/torch_pod_sim_child.py``, the port's
``LMTrainer``) under real pod supervisors sharing one tmpdir; a
``stall@step`` hang on one host escalated through the watchdog's exit
intent, a permanent host loss continued on the survivors, and that loss
followed by the host's return.  Each audits exact resume through the
consumed-batch logs and identical final weights across hosts.  The JAX
copies also read their streams through ``obs`` fold/watch/export/goodput,
which the port has not yet (ROADMAP items 9 and 13); the port's copies
check the ``restart_latency`` events in the streams instead.

The slice's main path, the ``dp`` pod through the command line, is in
test_torch_pod_world.py.

Every wait has its own time limit (thread joins).
"""

import json
import os
import sys
import threading
import time
from pathlib import Path

import pytest

from ddl_tpu_torch import checkpoint as ckpt
from ddl_tpu_torch import coord
from ddl_tpu_torch.coord import Rendezvous
from ddl_tpu_torch.obs import events_path, read_events
from ddl_tpu_torch.supervisor import supervise_pod_command
from ddl_tpu_torch.utils.backoff import Backoff

ROOT = Path(__file__).resolve().parents[1]
CHILD = Path(__file__).parent / "torch_pod_sim_child.py"


def _rv(root, host, n, **kw):
    kw.setdefault("timeout_s", 10.0)
    kw.setdefault("poll_s", 0.005)
    return Rendezvous(root, host, n, **kw)


def _clean_env() -> dict:
    """The suite's environment minus everything that would leak pod,
    fault or world state into a simulation's children."""
    return {k: v for k, v in os.environ.items()
            if not k.startswith("DDL_") and k not in ("RANK", "LOCAL_RANK", "WORLD_SIZE")}


def _read_consumed(sim: Path, host: int) -> list[tuple[int, int]]:
    out = []
    for line in (sim / f"consumed_h{host}.log").read_text().splitlines():
        e, s = line.split()
        out.append((int(e), int(s)))
    return out


def _finals(sim: Path, hosts) -> dict:
    out = {}
    for i in hosts:
        e, step, digest = (sim / f"final_h{i}.log").read_text().splitlines()[-1].split()
        out[i] = (int(e), int(step), digest)
    return out


def _run_hosts(hosts, target, timeout=300) -> None:
    threads = {i: threading.Thread(target=target, args=(i,)) for i in hosts}
    for t in threads.values():
        t.start()
    for t in threads.values():
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads.values()), "pod sim deadlocked"


def _sim_env(sim: Path, job: str, steps: int, pace: float, watchdog: float) -> dict:
    return dict(_clean_env(), OMP_NUM_THREADS="1", DDL_SIM_DIR=str(sim),
                DDL_SIM_STEPS=str(steps), DDL_SIM_PACE=str(pace), DDL_JOB_ID=job,
                DDL_LOG_DIR=str(sim / "suplogs"), DDL_WATCHDOG_S=str(watchdog))


def _agreed(launch: Path, key: str):
    return json.loads((launch / "agree" / f"{key}.json").read_text())["value"]


def _restart_latency(sim: Path, host: int, job: str, repoch: int) -> list[dict]:
    evs = read_events(events_path(sim / f"logs_h{host}", job, host=host))
    return [e for e in evs if e.get("kind") == "restart_latency" and e.get("repoch") == repoch]


def test_three_host_pod_sim_stall_escalation_and_exact_resume(tmp_path):
    """stall@step on host 1 -> its watchdog publishes the exit intent and
    exits resumable -> all three hosts kill their trainers and relaunch in
    restart epoch 1 -> every host restores the leader-agreed snapshot ->
    the same final step and identical weights on every host, each final
    incarnation consuming exactly the batches from the restored cursor to
    the end."""
    sim, nas = tmp_path / "sim", tmp_path / "nas"
    sim.mkdir()
    steps = 10
    base_env = _sim_env(sim, "podsim", steps, 0.8, 4)
    results = {}

    def host(i):
        env = dict(base_env)
        if i == 1:
            env["DDL_FAULT"] = "stall@step:2:300"  # the hang
        results[i] = supervise_pod_command(
            [sys.executable, str(CHILD)], nas, i, 3, env=env, max_restarts=3,
            backoff=Backoff(base=0.01, jitter=0.0), poll_s=0.05, heartbeat_s=0.2,
            stale_after_s=60.0, log=lambda m: None)

    _run_hosts(range(3), host)
    assert results == {0: 0, 1: 0, 2: 0}, results
    launch = coord.active_launch_root(nas)
    assert launch is not None and launch.parent == nas / "launches"
    assert (launch / "finished.json").is_file()
    rv = _rv(launch, 0, 3)
    assert rv.current_epoch() == 1, rv.current_epoch()
    rec = rv.epoch_record(1)
    assert rec["crashes"] == 0  # a hang is resumable, not a crash
    # host 1's watchdog escalated (its intent marker, published before the
    # exit, was then restated by its supervisor as the child's resumable exit)
    intent = json.loads((launch / "intents" / "h001.e0.json").read_text())
    assert intent["host"] == 1 and intent["rc"] == 75
    child1 = read_events(events_path(sim / "logs_h1", "podsim", host=1))
    assert any(e["kind"] == "watchdog_exit" for e in child1)

    finals = _finals(sim, range(3))
    assert all(e == 1 and s == steps for e, s, _ in finals.values()), finals
    assert len({d for _, _, d in finals.values()}) == 1, finals
    agreed = _agreed(launch, "resume-podsim-e1")
    # agreed None is a legal race: the coordinated kill can land before any
    # snapshot committed, and every host then retrains from scratch
    if agreed is not None:
        cursor = ckpt.read_cursor(sim / "ckpt", "podsim", agreed)
        assert cursor is not None and cursor["step"] == agreed
    resume_from = 0 if agreed is None else agreed
    for i in range(3):
        tail = [s for e, s in _read_consumed(sim, i) if e == 1]
        assert tail == list(range(resume_from, steps)), (i, tail, agreed)
        if tail:
            rls = _restart_latency(sim, i, "podsim", 1)
            assert rls and rls[-1]["latency"] > 0, i
            assert rls[-1]["decision_ts"] == pytest.approx(rec["ts"])
    sup = read_events(events_path(sim / "suplogs", "podsim", host=0))
    assert [e["epoch"] for e in sup if e["kind"] == "pod_restart"] == [1]


def test_three_host_pod_sim_permanent_host_loss_elastic_continue(tmp_path):
    """Host 1's supervisor makes the start barrier, beats once and dies
    before launching a trainer.  The elastic survivors hold the eviction
    grace, agree restart epoch 1 with membership [0, 2] / world 2, relaunch
    with ``DDL_COORD_MEMBERS=0,2`` and the survivors renumbered, resume the
    agreed snapshot and finish with identical weights, each epoch-1 tail
    exactly [resume, steps).

    Held to what the JAX supervisor does here, not to
    ``tests/test_coord.py:901``: the survivors start with host 1 already
    past its grace, so their epoch-0 children are killed at the first
    signal poll, before they log anything, and the first child that runs
    is epoch 1's (the JAX run logs the same; line 901 expects an epoch-0
    line)."""
    sim, nas = tmp_path / "sim", tmp_path / "nas"
    sim.mkdir()
    steps = 8
    base_env = _sim_env(sim, "podelastic", steps, 0.5, 30)
    launch1 = coord.acquire_launch(nas)
    rv1 = Rendezvous(launch1, 1, 3)
    rv1.arrive("start")
    rv1.publish_heartbeat("running", 0)
    time.sleep(3.2)  # past stale_after_s + elastic_grace_s
    results = {}

    def host(i):
        results[i] = supervise_pod_command(
            [sys.executable, str(CHILD)], nas, i, 3, env=dict(base_env), max_restarts=3,
            backoff=Backoff(base=0.01, jitter=0.0), poll_s=0.05, heartbeat_s=0.2,
            stale_after_s=1.5, elastic=True, elastic_grace_s=1.5, log=lambda m: None)

    _run_hosts((0, 2), host)
    assert results == {0: 0, 2: 0}, results
    launch = coord.active_launch_root(nas)
    assert launch == launch1 and (launch / "finished.json").is_file()
    rv = _rv(launch, 0, 3)
    assert rv.aborted() is None
    assert rv.current_epoch() == 1, rv.current_epoch()
    rec = rv.epoch_record(1)
    assert rec["reason"] == "peer_lost"
    assert rec["hosts"] == [0, 2] and rec["world"] == 2
    assert rec["crashes"] == 0

    finals = _finals(sim, (0, 2))
    assert all(f == (1, steps, finals[0][2]) for f in finals.values()), finals
    assert not (sim / "final_h1.log").exists()
    for i in (0, 2):
        lines = (sim / f"env_h{i}.log").read_text().splitlines()
        # the JAX package's log: the first child that runs is epoch 1's
        assert [ln.split()[0] for ln in lines] == ["1"], lines
        assert lines[0] == f"1 members=0,2 nproc=2 pid={0 if i == 0 else 1}", lines
        assert all(e == 1 for e, _ in _read_consumed(sim, i))
    agreed = _agreed(launch, "resume-podelastic-e1")
    if agreed is not None:
        cursor = ckpt.read_cursor(sim / "ckpt", "podelastic", agreed)
        assert cursor is not None and cursor["step"] == agreed
    resume_from = 0 if agreed is None else agreed
    for i in (0, 2):
        tail = [s for e, s in _read_consumed(sim, i) if e == 1]
        assert tail == list(range(resume_from, steps)), (i, tail, agreed)


def test_three_host_pod_sim_host_loss_then_rejoin(tmp_path):
    """The elastic churn cycle: host 1's supervisor dies after the start
    barrier, the survivors evict it and train on at world 2 ([0, 2],
    renumbered); then a replacement host-1 supervisor starts into the
    shrunken launch, publishes a join request, and the leader answers with
    a ``peer_join`` restart epoch at the full membership.  All three hosts
    finish epoch 2 with identical weights, and every epoch's tail runs
    exactly [agreed resume, ...)."""
    sim, nas = tmp_path / "sim", tmp_path / "nas"
    sim.mkdir()
    steps = 12
    base_env = _sim_env(sim, "podrejoin", steps, 0.35, 30)
    launch1 = coord.acquire_launch(nas)
    rv1 = Rendezvous(launch1, 1, 3)
    rv1.arrive("start")
    rv1.publish_heartbeat("running", 0)
    results = {}

    def host(i):
        results[i] = supervise_pod_command(
            [sys.executable, str(CHILD)], nas, i, 3, env=dict(base_env), max_restarts=3,
            backoff=Backoff(base=0.01, jitter=0.0), poll_s=0.05, heartbeat_s=0.2,
            stale_after_s=1.5, elastic=True, elastic_grace_s=1.5, log=lambda m: None)

    threads = {i: threading.Thread(target=host, args=(i,)) for i in (0, 2)}
    for t in threads.values():
        t.start()
    # the replacement starts once the world-2 incarnation has trained a batch
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        try:
            if any(e == 1 for e, _ in _read_consumed(sim, 0)):
                break
        except OSError:
            pass
        time.sleep(0.05)
    else:
        pytest.fail("survivors never trained at world 2")
    threads[1] = threading.Thread(target=host, args=(1,))
    threads[1].start()
    for t in threads.values():
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads.values()), "rejoin sim deadlocked"
    assert results == {0: 0, 1: 0, 2: 0}, results

    launch = coord.active_launch_root(nas)
    assert launch == launch1 and (launch / "finished.json").is_file()
    rv = _rv(launch, 0, 3)
    assert rv.aborted() is None
    assert rv.current_epoch() == 2, rv.current_epoch()
    rec1, rec2 = rv.epoch_record(1), rv.epoch_record(2)
    assert rec1["reason"] == "peer_lost", rec1
    assert rec1["hosts"] == [0, 2] and rec1["world"] == 2
    assert rec1["crashes"] == 0 and rec1["preemptions"] == 1
    assert rec2["reason"] == "peer_join", rec2
    assert rec2["hosts"] == [0, 1, 2] and rec2["world"] == 3
    assert rec2["crashes"] == 0 and rec2["preemptions"] == 1
    assert rv.join_requests() == []

    finals = _finals(sim, range(3))
    assert all(f == (2, steps, finals[0][2]) for f in finals.values()), finals
    for i in (0, 2):
        lines = (sim / f"env_h{i}.log").read_text().splitlines()
        e1 = [ln for ln in lines if ln.startswith("1 ")][-1]
        assert "members=0,2" in e1 and "nproc=2" in e1, e1
        assert f"pid={0 if i == 0 else 1}" in e1, e1
    lines1 = (sim / "env_h1.log").read_text().splitlines()
    assert all(ln.startswith("2 ") for ln in lines1), lines1
    for i in range(3):
        lines = (sim / f"env_h{i}.log").read_text().splitlines()
        e2 = [ln for ln in lines if ln.startswith("2 ")][-1]
        assert "members=0,1,2" in e2 and "nproc=-" in e2, e2
    for ep, hosts in ((1, (0, 2)), (2, (0, 1, 2))):
        agreed = _agreed(launch, f"resume-podrejoin-e{ep}")
        if agreed is not None:
            cursor = ckpt.read_cursor(sim / "ckpt", "podrejoin", agreed)
            assert cursor is not None and cursor["step"] == agreed
        start = 0 if agreed is None else agreed
        for i in hosts:
            tail = [s for e, s in _read_consumed(sim, i) if e == ep]
            assert tail == list(range(start, start + len(tail))), (i, ep, tail, agreed)
            if ep == 2:
                assert tail and tail[-1] == steps - 1, (i, tail)
    # the supervisor streams carry the grow cycle: the joiner's request and
    # the leader's decision
    kinds = {h: [e["kind"] for e in read_events(events_path(sim / "suplogs", "podrejoin",
                                                            host=h))] for h in (0, 1)}
    assert "join_request" in kinds[1] and "peer_join" in kinds[0], kinds
    # the joiner's grow-epoch incarnation stamped its relaunch-to-step time
    rls = _restart_latency(sim, 1, "podrejoin", 2)
    assert rls and rls[-1]["decision_ts"] == pytest.approx(rec2["ts"])
