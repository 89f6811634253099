"""The port's single-host supervisor (ddl_tpu_torch/supervisor.py): the
single-host tests of tests/test_fault_tolerance.py run on the port, the
port's ``Supervisor`` held to ``ddl_tpu.supervisor.Supervisor`` on
scripted exit-code sequences (the same decisions, sleeps, counters and
events under a fake clock), a supervised preempt-then-resume of the
DenseNet Trainer, and ``python -m ddl_tpu_torch.cli train --supervise``
end to end in a subprocess."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke
from ddl_tpu.obs import EventWriter as JaxEventWriter
from ddl_tpu.obs import read_events as jax_read_events
from ddl_tpu.supervisor import Supervisor as JaxSupervisor
from ddl_tpu.utils.backoff import Backoff as JaxBackoff
from ddl_tpu_torch import checkpoint as ckpt
from ddl_tpu_torch.config import preset
from ddl_tpu_torch.obs import EventWriter, events_path, read_events
from ddl_tpu_torch.supervisor import (
    EXIT_PREEMPTED,
    Supervisor,
    _surviving_faults,
    supervise_command,
)
from ddl_tpu_torch.train import Trainer
from ddl_tpu_torch.utils import faultinject
from ddl_tpu_torch.utils.backoff import Backoff

ROOT = Path(__file__).resolve().parents[1]
# a tiny DenseNet run: 3 train batches and 2 eval batches an epoch
TINY = {"model.growth_rate": "4", "model.block_config": "[2,2]",
        "model.num_init_features": "8", "model.bn_size": "2", "data.image_size": "16",
        "data.synthetic_num_train": "24", "data.synthetic_num_test": "16",
        "data.global_batch_size": "8", "data.eval_batch_size": "8", "data.num_workers": "0",
        "train.max_epochs": "2", "data.dataset_dir": ""}


@pytest.fixture(autouse=True)
def _clean_injector():
    faultinject.deactivate()
    yield
    faultinject.deactivate()


# ---------------------------------------------------------------------------
# the policy (tests/test_fault_tolerance.py's supervisor tests)
# ---------------------------------------------------------------------------


def test_restarts_after_crash_with_backoff():
    sleeps, attempts = [], []

    def attempt(restart_index):
        attempts.append(restart_index)
        if len(attempts) < 3:
            raise faultinject.InjectedCrash("boom")
        return 0

    sup = Supervisor(attempt, max_restarts=5, backoff=Backoff(base=1.0, factor=2.0, jitter=0.0),
                     sleep=sleeps.append, log=lambda m: None)
    assert sup.run() == 0
    assert attempts == [0, 1, 2]
    assert sleeps == [1.0, 2.0]
    assert sup.crashes == 2 and sup.preemptions == 0


def test_gives_up_after_max_restarts():
    sup = Supervisor(lambda i: 1, max_restarts=3, backoff=Backoff(jitter=0.0),
                     sleep=lambda d: None, log=lambda m: None)
    assert sup.run() == 1
    assert sup.restarts == 4


def test_preemption_relaunch_backoff_policy():
    sleeps = []
    codes = [EXIT_PREEMPTED, EXIT_PREEMPTED, EXIT_PREEMPTED, 0]
    sup = Supervisor(lambda i: codes[i], max_restarts=5, sleep=sleeps.append,
                     backoff=Backoff(base=1.0, factor=2.0, jitter=0.0), log=lambda m: None)
    assert sup.run() == 0
    assert sup.preemptions == 3 and sup.crashes == 0
    assert sleeps == [1.0, 2.0]


def test_preemptions_do_not_consume_the_crash_budget():
    codes = [EXIT_PREEMPTED] * 10 + [0]
    sup = Supervisor(lambda i: codes[i], max_restarts=2, sleep=lambda d: None,
                     log=lambda m: None)
    assert sup.run() == 0
    assert sup.preemptions == 10 and sup.crashes == 0
    loop = Supervisor(lambda i: EXIT_PREEMPTED, max_restarts=2, max_preemptions=5,
                      sleep=lambda d: None, log=lambda m: None)
    assert loop.run() == EXIT_PREEMPTED
    assert loop.preemptions == 6


def test_emits_lifecycle_events(tmp_path):
    w = EventWriter(tmp_path, "supjob", host=0)
    codes = iter([EXIT_PREEMPTED, 7, 0])
    sup = Supervisor(lambda i: next(codes), max_restarts=3, sleep=lambda s: None,
                     log=lambda m: None, events=w)
    assert sup.run() == 0
    w.close()
    events = read_events(w.path)
    assert events[0]["kind"] == "supervisor_start"
    relaunches = [e for e in events if e["kind"] == "supervisor_relaunch"]
    assert [e["reason"] for e in relaunches] == ["preempt", "crash"]
    assert relaunches[1]["rc"] == 7
    assert events[-1]["kind"] == "supervisor_done"
    assert events[-1]["rc"] == 0 and events[-1]["gave_up"] is False


def test_emits_give_up_event(tmp_path):
    w = EventWriter(tmp_path, "supjob2", host=0)
    sup = Supervisor(lambda i: 9, max_restarts=1, sleep=lambda s: None, log=lambda m: None,
                     events=w)
    assert sup.run() == 9
    w.close()
    done = read_events(w.path)[-1]
    assert done["kind"] == "supervisor_done"
    assert done["rc"] == 9 and done["gave_up"] is True


def test_surviving_faults_match_duplicates_one_for_one(tmp_path):
    state = tmp_path / "state"
    state.write_text("io@save:1\n")
    assert _surviving_faults("io@save:1, io@save:1", state) == "io@save:1"
    assert _surviving_faults("crash@step:3", tmp_path / "nope") == "crash@step:3"


# ---------------------------------------------------------------------------
# the port's Supervisor against the JAX package's
# ---------------------------------------------------------------------------

R = "raise"
SCRIPTS = {
    # (exit code or R, the attempt's seconds on the fake clock)
    "crash-then-done": ([(1, 1), (1, 1), (0, 1)], {}),
    "preempt-streak": ([(75, 1)] * 3 + [(0, 1)], {}),
    "evictions-past-the-budget": ([(75, 1)] * 10 + [(0, 1)], {"max_restarts": 2}),
    "always-preempted": ([(75, 1)] * 10, {"max_preemptions": 5}),
    "crash-loop-gives-up": ([(1, 1)] * 6, {"max_restarts": 3}),
    "mixed": ([(75, 1), (7, 1), (75, 1), (75, 1), (2, 1), (0, 1)], {}),
    "long-attempts-end-the-streak": ([(75, 100), (75, 1), (75, 100), (75, 1), (75, 1),
                                      (0, 1)], {}),
    "runner-raises": ([(R, 1), (R, 1), (0, 1)], {}),
    "capped-delays": ([(134, 1), (139, 1), (1, 1), (1, 1), (1, 1), (0, 1)],
                      {"max_restarts": 6}),
    "rejoin-is-a-crash": ([(76, 1), (0, 1)], {}),
}
EVENT_FIELDS = ("reason", "rc", "delay", "gave_up", "restarts", "crashes", "preemptions",
                "max_restarts", "max_preemptions")


def _drive(cls, backoff, writer, read, script, kw):
    clock, sleeps, attempts = [0.0], [], []

    def attempt(i):
        attempts.append(i)
        rc, seconds = script[len(attempts) - 1]
        clock[0] += seconds
        if rc == R:
            raise RuntimeError("the runner failed")
        return rc

    sup = cls(attempt, backoff=backoff(base=1.0, factor=2.0, max_delay=3.0, jitter=0.0),
              sleep=sleeps.append, log=lambda m: None, clock=lambda: clock[0],
              streak_window_s=60.0, events=writer, **kw)
    rc = sup.run()
    writer.close()
    events = [(e["kind"], {k: e[k] for k in EVENT_FIELDS if k in e})
              for e in read(writer.path)]
    relaunch_ts = [e["decision_ts"] for e in read(writer.path)
                   if e["kind"] == "supervisor_relaunch"]
    return {"rc": rc, "attempts": attempts, "sleeps": sleeps, "events": events,
            "counters": (sup.restarts, sup.crashes, sup.preemptions),
            "stamped": relaunch_ts[-1:] == [sup.last_relaunch_ts] if relaunch_ts else
            sup.last_relaunch_ts is None}


@pytest.mark.parametrize("name", SCRIPTS)
def test_makes_the_jax_supervisors_decisions(name, tmp_path):
    script, kw = SCRIPTS[name]
    got = _drive(Supervisor, Backoff, EventWriter(tmp_path / "port", "job", host=0),
                 read_events, script, kw)
    want = _drive(JaxSupervisor, JaxBackoff, JaxEventWriter(tmp_path / "jax", "job", host=0),
                  jax_read_events, script, kw)
    assert got == want
    assert got["stamped"]


# ---------------------------------------------------------------------------
# the subprocess runner
# ---------------------------------------------------------------------------


def _clean_env(tmp_path, **extra) -> dict:
    env = dict(os.environ, DDL_LOG_DIR=str(tmp_path / "logs"), **extra)
    for var in ("DDL_FAULT_PERSIST", "DDL_FAULT_STATE", "DDL_RELAUNCH_TS", "DDL_SUPERVISED",
                "DDL_WATCHDOG_ACTION"):
        env.pop(var, None)
    return env


def test_supervise_command_subprocess_crash_then_success(tmp_path):
    """A child that crashes once on an injected fault it consumes, then
    completes: the supervision contract is in its environment, and the
    fired fault does not recur."""
    marker = tmp_path / "attempts"
    prog = (
        "import os, pathlib, sys\n"
        "sys.path.insert(0, os.getcwd())\n"
        f"m = pathlib.Path({str(marker)!r})\n"
        "n = int(m.read_text()) if m.exists() else 0\n"
        "m.write_text(str(n + 1))\n"
        "assert os.environ['DDL_SUPERVISED'] == '1'\n"
        "assert os.environ['DDL_RESTART_COUNT'] == str(n)\n"
        "assert os.environ['DDL_WATCHDOG_ACTION'] == 'exit'\n"
        "assert ('DDL_RELAUNCH_TS' in os.environ) == (n > 0)\n"
        "assert ('DDL_FAULT' in os.environ) == (n == 0)\n"
        "from ddl_tpu_torch.utils import faultinject\n"
        "try:\n"
        "    faultinject.check_step(1)\n"
        "except faultinject.InjectedCrash:\n"
        "    sys.exit(1)\n"
        "sys.exit(0)\n"
    )
    env = _clean_env(tmp_path, DDL_FAULT="crash@step:1", DDL_JOB_ID="supcmd")
    rc = supervise_command([sys.executable, "-c", prog], max_restarts=2, env=env,
                           backoff=Backoff(base=0.01, jitter=0.0), log=lambda m: None)
    assert rc == 0 and marker.read_text() == "2"
    kinds = [e["kind"] for e in read_events(events_path(tmp_path / "logs", "supcmd"))]
    assert kinds == ["supervisor_start", "supervisor_relaunch", "supervisor_done"]


def test_relaunch_keeps_the_faults_that_have_not_fired(tmp_path):
    seen = tmp_path / "seen_faults"
    prog = (
        "import os, pathlib, sys\n"
        "sys.path.insert(0, os.getcwd())\n"
        f"s = pathlib.Path({str(seen)!r})\n"
        "with s.open('a') as fh:\n"
        "    fh.write(os.environ.get('DDL_FAULT', '<none>') + '\\n')\n"
        "from ddl_tpu_torch.utils import faultinject\n"
        "try:\n"
        "    for step in range(8):\n"
        "        faultinject.check_step(step)\n"
        "except faultinject.InjectedCrash:\n"
        "    sys.exit(1)\n"
        "sys.exit(0)\n"
    )
    env = _clean_env(tmp_path, DDL_FAULT="crash@step:2,crash@step:5")
    rc = supervise_command([sys.executable, "-c", prog], max_restarts=3, env=env,
                           backoff=Backoff(base=0.01, jitter=0.0), log=lambda m: None)
    assert rc == 0
    assert seen.read_text().splitlines() == ["crash@step:2,crash@step:5", "crash@step:5",
                                             "<none>"]


# ---------------------------------------------------------------------------
# the DenseNet Trainer under supervision
# ---------------------------------------------------------------------------


def _trainer(tmp_path, job):
    return Trainer(preset("single", **TINY, **{
        "train.log_dir": str(tmp_path / "logs"), "train.checkpoint_dir": str(tmp_path / job)}),
        device="cpu")


@pytest.mark.parametrize("fault,preempted,crashes", [("preempt@step:4", 1, 0),
                                                     ("crash@step:4", 0, 1)],
                         ids=["preempt", "crash"])
def test_supervised_densenet_trainer_resumes_to_the_uninterrupted_state(
        tmp_path, monkeypatch, fault, preempted, crashes):
    """A fault at global step 4 (epoch 1, batch 1), a relaunch that resumes
    from the newest valid snapshot by itself, and a final state bit-equal
    to an uninterrupted run's (after a crash: replayed from the epoch_0
    snapshot, the same batches again)."""
    monkeypatch.setenv("DDL_JOB_ID", "sup-densenet")
    starts = []

    def attempt(restart_index):
        if restart_index == 0:
            faultinject.activate(fault)
        else:
            faultinject.deactivate()
        t = _trainer(tmp_path, "supervised")
        starts.append((t.epochs_run, t._resume_offset))
        try:
            t.train()
        except faultinject.InjectedCrash:
            return 1
        attempt.final = t
        return EXIT_PREEMPTED if t.preempted else 0

    sup = Supervisor(attempt, max_restarts=2, sleep=lambda d: None, log=lambda m: None)
    assert sup.run() == 0
    assert (sup.preemptions, sup.crashes) == (preempted, crashes)
    assert starts == [(0, 0), (1, 2) if preempted else (1, 0)]
    monkeypatch.setenv("DDL_JOB_ID", "uninterrupted")
    reference = _trainer(tmp_path, "uninterrupted")
    reference.train()
    got = chip_smoke.flat_state(attempt.final.snapshot_state())
    want = chip_smoke.flat_state(reference.snapshot_state())
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_cli_supervise_end_to_end(tmp_path):
    """``python -m ddl_tpu_torch.cli train --supervise ... --device cpu``
    preempted at step 4: one relaunch, exit 0, the lifecycle events, the
    restore and the restart latency in the job's stream, and a final
    snapshot at the end of the run."""
    env = _clean_env(tmp_path, DDL_FAULT="preempt@step:4", DDL_JOB_ID="sup-cli",
                     DDL_CHECKPOINT_DIR=str(tmp_path / "ckpt"))
    cmd = [sys.executable, "-m", "ddl_tpu_torch.cli", "train", "--supervise",
           "--max-restarts", "2", "--device", "cpu", "--preset", "single", "--set",
           *(f"{k}={v}" for k, v in TINY.items())]
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "run complete after 1 relaunch(es)" in proc.stdout
    events = read_events(events_path(tmp_path / "logs", "sup-cli"))
    kinds = [e["kind"] for e in events]
    assert kinds[0] == "supervisor_start" and kinds[-1] == "supervisor_done"
    assert [e["reason"] for e in events if e["kind"] == "supervisor_relaunch"] == ["preempt"]
    assert events[-1]["rc"] == 0 and events[-1]["gave_up"] is False
    restores = [e for e in events if e["kind"] == "snapshot_restore"]
    assert [(e["period"], e["offset"]) for e in restores] == [(1, 2)]
    latency = [e for e in events if e["kind"] == "restart_latency"]
    assert len(latency) == 1 and latency[0]["latency"] > 0
    assert kinds.count("run_start") == 2
    assert ckpt.read_cursor(tmp_path / "ckpt", "sup-cli", 1) in (
        {"period": 1, "offset": 2}, {"period": 2, "offset": 0})


def test_the_supervisor_process_imports_no_torch(tmp_path):
    """The supervisor outlives its children and never touches the card:
    its path (the CLI's flag handling, the policy, the event writer, the
    fault filter) imports no torch."""
    code = (
        "import sys\n"
        "import ddl_tpu_torch.cli\n"
        "from ddl_tpu_torch.supervisor import _supervisor_events, _surviving_faults\n"
        f"_supervisor_events({{'DDL_LOG_DIR': {str(tmp_path)!r}}}).close()\n"
        "_surviving_faults('preempt@step:4', '/nonexistent')\n"
        "print('torch' in sys.modules)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"
