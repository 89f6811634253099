"""The port's loop concerns (ddl_tpu_torch/train/loop.py) against the JAX
package's: one scripted stub run on both ``BaseTrainer``s gives the same
halts, snapshot gates, cadence saves, preemption exits and recovery
actions (skip, rollback, grace, give-up); the recovery policy, fault
injection, backoff and the preemption guard as copies of the JAX ones;
the grace window's update scale against optax's ``scale_tx``; and the
DenseNet Trainer's rollback on the CPU."""

import os
import random
import signal
import types

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddl_tpu.train.loop import BaseTrainer as JaxBaseTrainer
from ddl_tpu.train.recovery import RecoveryPolicy as JaxRecoveryPolicy
from ddl_tpu.train.recovery import make_policy as jax_make_policy
from ddl_tpu.train.recovery import scale_tx
from ddl_tpu.utils import faultinject as jax_faultinject
from ddl_tpu.utils.backoff import Backoff as JaxBackoff
from ddl_tpu.utils.preemption import PreemptionGuard as JaxPreemptionGuard
from ddl_tpu_torch import checkpoint as ckpt
from ddl_tpu_torch.config import preset
from ddl_tpu_torch.obs import events_path, read_events
from ddl_tpu_torch.train import Optimizer, Trainer
from ddl_tpu_torch.train.loop import BaseTrainer
from ddl_tpu_torch.train.recovery import RecoveryPolicy, make_policy
from ddl_tpu_torch.utils import faultinject
from ddl_tpu_torch.utils.backoff import Backoff, retry_with_backoff
from ddl_tpu_torch.utils.preemption import PreemptionGuard

NAN = float("nan")


@pytest.fixture(autouse=True)
def _clean_injectors():
    faultinject.deactivate()
    jax_faultinject.deactivate()
    yield
    faultinject.deactivate()
    jax_faultinject.deactivate()


def _stub(base, losses, evals=None, *, recovery=None, rollback_to=None, heal=True,
          best_metric=None, best_mode="max", save_best=True, cadence=0, request_at=None):
    """One scripted trainer on ``base`` (either package's loop): a period's
    loss comes from ``losses``, its eval from ``evals``; a rollback rewinds
    to ``rollback_to`` and, with ``heal``, makes the stream finite.  It
    records every action the loop takes on it."""

    class Stub(base):
        period_label = "Epoch"

        def __init__(self):
            self.state = None
            self.job_id = "stub"
            self.logger = None
            self.is_logging_process = True
            self.periods_run = 0
            self.num_periods = len(losses)
            self.halt_on_nan = True
            self.preemption_save = False
            self.profile_dir = None
            self.save_best = save_best
            self.best_metric = best_metric
            self.best_mode = best_mode
            self.best_value = -float("inf") if best_mode == "max" else float("inf")
            self.recovery = recovery
            self.actions = []
            self._losses = list(losses)

        def run_period(self, period, guard=None):
            self.actions.append(("run", period))
            if request_at == period and guard is not None:
                guard.request()
            return {"loss": self._losses[period]}, 5

        def evaluate_period(self, period):
            return (evals or {}).get(period)

        def snapshot_due(self, period):
            return bool(cadence) and (period + 1) % cadence == 0

        def save_snapshot(self, period):
            self.actions.append(("save", period, dict(self.data_cursor)))

        def wait_for_saves(self):
            self.actions.append(("wait",))

        def set_update_scale(self, scale):
            if scale != self.update_scale:
                self.actions.append(("scale", scale))
            self.update_scale = scale

        def rollback_to_snapshot(self):
            if rollback_to is None:
                return False
            self.actions.append(("rollback", rollback_to))
            self.periods_run = rollback_to
            if heal:
                self._losses = [0.5] * len(self._losses)
            return True

    return Stub()


def _run_both(kwargs, guarded=False):
    """The same stub run on both loops -> (port outcome, JAX outcome): the
    actions, the final cursor, the error, and the policy's counters."""
    outcomes = []
    for base, policy_cls, guard_cls in ((BaseTrainer, RecoveryPolicy, PreemptionGuard),
                                        (JaxBaseTrainer, JaxRecoveryPolicy,
                                         JaxPreemptionGuard)):
        kw = dict(kwargs)
        if "policy" in kw:
            kw["recovery"] = policy_cls(**kw.pop("policy"))
        t = _stub(base, **kw)
        error = None
        try:
            if guarded:
                with guard_cls() as guard:
                    t.train(guard=guard)
            else:
                t.train()
        except RuntimeError as e:
            error = str(e).split(";")[0].split(".")[0]
        pol = t.recovery
        outcomes.append({
            "actions": t.actions, "periods_run": t.periods_run, "error": error,
            "preempted": t.preempted, "best": t.best_value,
            "best_snapshot": t.best_snapshot_epoch,
            "policy": None if pol is None else (pol.skipped, pol.rollbacks, pol.consecutive,
                                                pol.grace_left),
        })
    return outcomes


SCENARIOS = {
    # tests/test_loop.py
    "nan_halts": dict(losses=[1.0, NAN, 0.5]),
    "best_gate_min": dict(losses=[1.0] * 3, evals={0: {"val_ppl": 9.0}, 1: {"val_ppl": 11.0},
                                                   2: {"val_ppl": 7.0}},
                          best_metric="val_ppl", best_mode="min"),
    "best_gate_max": dict(losses=[1.0] * 3, evals={0: {"qwk": 0.1}, 1: {"qwk": 0.5},
                                                   2: {"qwk": 0.4}}, best_metric="qwk"),
    "best_gate_off": dict(losses=[1.0] * 3, evals={0: {"qwk": 0.1}}, best_metric="qwk",
                          save_best=False),
    "cadence": dict(losses=[1.0] * 6, cadence=2),
    # tests/test_fault_tolerance.py::_PolicyStub
    "skip_then_rollback_and_grace": dict(
        losses=[1.0, NAN, NAN, 1.0, 1.0, 1.0, 1.0], rollback_to=1,
        policy=dict(max_consecutive=2, grace_scale=0.1, grace_periods=2)),
    "skip_only": dict(losses=[1.0, NAN, 1.0, NAN, 1.0],
                      policy=dict(max_consecutive=2)),
    "no_snapshot_halts": dict(losses=[NAN] * 3, policy=dict(max_consecutive=2)),
    "bounded_rollbacks_give_up": dict(losses=[NAN] * 6, rollback_to=0, heal=False,
                                      policy=dict(max_consecutive=1, max_rollbacks=2)),
    "grace_then_cadence_save": dict(losses=[1.0, NAN, 1.0, 1.0], rollback_to=1, cadence=1,
                                    policy=dict(max_consecutive=1, grace_scale=0.5,
                                                grace_periods=1)),
}


@pytest.mark.parametrize("name", SCENARIOS)
def test_stub_run_matches_the_jax_loop(name):
    port, jax_run = _run_both(SCENARIOS[name])
    assert port == jax_run
    if name == "skip_then_rollback_and_grace":
        assert [a for a in port["actions"] if a[0] in ("rollback", "scale")] == [
            ("rollback", 1), ("scale", 0.1), ("scale", 1.0)]
    if name == "bounded_rollbacks_give_up":
        assert port["error"].startswith("Non-finite training loss persisted through 2")


@pytest.mark.parametrize("name, kwargs", [
    ("preempt_saves_cursor_and_stops", dict(losses=[1.0] * 10, request_at=2)),
    ("preempt_during_recovery_exits_unsaved",
     dict(losses=[1.0, NAN, 1.0, 1.0], request_at=1, policy=dict(max_consecutive=3))),
])
def test_preemption_matches_the_jax_loop(name, kwargs):
    port, jax_run = _run_both(kwargs, guarded=True)
    assert port == jax_run and port["preempted"]
    saves = [a for a in port["actions"] if a[0] == "save"]
    if name == "preempt_saves_cursor_and_stops":
        assert port["periods_run"] == 3 and saves == [("save", 2, {"period": 2, "offset": 5})]
    else:
        assert port["periods_run"] == 2 and saves == []


def test_sigterm_through_the_guard():
    """A real SIGTERM mid-period: the in-flight period finishes, the
    cursor-carrying snapshot is saved, the loop exits, the handler is
    restored."""
    t = _stub(BaseTrainer, [1.0] * 10)
    run = t.run_period

    def signalled(period, guard=None):
        if period == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return run(period, guard)

    t.run_period = signalled
    before = signal.getsignal(signal.SIGTERM)
    t.preemption_save = True
    t.train()
    assert t.preempted and t.periods_run == 2
    assert [a for a in t.actions if a[0] == "save"] == [("save", 1, {"period": 1, "offset": 5})]
    assert signal.getsignal(signal.SIGTERM) is before


def test_policy_units_match_jax():
    for nan_policy in ("halt", "recover"):
        run = types.SimpleNamespace(nan_policy=nan_policy, nan_max_consecutive=2,
                                    nan_grace_scale=0.25, nan_grace_periods=3)
        got, want = make_policy(run), jax_make_policy(run)
        assert (got is None) == (want is None)
    with pytest.raises(ValueError, match="unknown nan_policy"):
        make_policy(types.SimpleNamespace(nan_policy="rollback"))
    with pytest.raises(ValueError, match="max_consecutive"):
        RecoveryPolicy(max_consecutive=0)
    got, want = RecoveryPolicy(2, 0.5, 2), JaxRecoveryPolicy(2, 0.5, 2)
    trace = []
    for event in ("nan", "nan", "rollback", "ok", "nan", "ok", "ok", "ok"):
        for pol in (got, want):
            if event == "nan":
                out = pol.on_nonfinite()
            elif event == "ok":
                out = pol.on_finite()
            else:
                out = pol.on_rollback()
            trace.append((out, pol.consecutive, pol.grace_left, pol.rollbacks, pol.skipped,
                          pol.in_grace))
    assert trace[0::2] == trace[1::2]


def test_fault_specs_and_hooks_match_jax(tmp_path, monkeypatch):
    """Parsing, keys, consume-on-fire, per-site counters and the state
    file as in the JAX package; the device-side kinds refuse."""
    spec = "preempt@step:3,io@batch:2:2,nan@step:5,spike@step:6:10,corrupt_ckpt@save:1"
    for pkg in (faultinject, jax_faultinject):
        inj = pkg.activate(spec)
        assert [s.key for s in inj.specs] == [
            "preempt@step:3", "io@batch:2:2", "nan@step:5", "spike@step:6:10",
            "corrupt_ckpt@save:1"]

    class Guard:
        requested = False

        def request(self):
            self.requested = True

    logs = []
    for pkg, sub in ((faultinject, "port"), (jax_faultinject, "jax")):
        monkeypatch.setenv("DDL_FAULT_STATE", str(tmp_path / f"{sub}.state"))
        pkg.activate(spec)
        guard = Guard()
        seen = []
        for step in range(8):
            pkg.check_step(step, guard)
            seen.append((step, guard.requested,
                         pkg.poison_loss({"loss": 2.0})["loss"]))
        ios = []
        for _ in range(5):
            try:
                pkg.io_check("batch")
                ios.append(False)
            except OSError:
                ios.append(True)
        logs.append((seen, ios, pkg.active().log))
    assert str(logs[0]) == str(logs[1])
    assert (tmp_path / "port.state").read_text() == (tmp_path / "jax.state").read_text()
    for bad in ("nan@grad:3", "leak@step:2:64", "rejoin@epoch:1"):
        with pytest.raises(NotImplementedError, match="item 9"):
            faultinject.activate(bad)
    with pytest.raises(ValueError, match="unknown fault kind"):
        faultinject.activate("boom@step:1")
    monkeypatch.setenv("DDL_FAULT", "crash@step:1")
    faultinject.deactivate()
    with pytest.raises(faultinject.InjectedCrash):
        faultinject.check_step(1)


def test_backoff_and_retry_match_jax():
    got = Backoff(base=0.5, factor=2.0, max_delay=3.0, rng=random.Random(7)).delays(6)
    want = JaxBackoff(base=0.5, factor=2.0, max_delay=3.0, rng=random.Random(7)).delays(6)
    assert got == want
    calls, sleeps, notes = [], [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("flake")
        return "ok"

    assert retry_with_backoff(flaky, retries=2, sleep=sleeps.append,
                              on_retry=lambda e, i: notes.append(i),
                              backoff=Backoff(rng=random.Random(0))) == "ok"
    assert len(sleeps) == 2 and notes == [0, 1]
    with pytest.raises(OSError):
        retry_with_backoff(lambda: (_ for _ in ()).throw(OSError("x")), retries=1,
                           sleep=lambda s: None)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2], ids=["adam", "adamw"])
def test_update_scale_matches_optax_scale_tx(weight_decay):
    """The grace window: two updates at update_scale 0.1 equal optax's
    ``scale_tx(tx, 0.1)`` (clipping first in both), and the learning rate
    the port reports is 0.1 x the schedule."""
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    grads = [rng.standard_normal((4, 3)).astype(np.float32) * 3 for _ in range(2)]
    base = (optax.adamw(1e-2, weight_decay=weight_decay) if weight_decay
            else optax.adam(1e-2))
    tx = scale_tx(optax.chain(optax.clip_by_global_norm(1.0), base), 0.1)
    params, state = jnp.asarray(w0), None
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = Optimizer([p], 1e-2, weight_decay=weight_decay, grad_clip_norm=1.0)
    opt.update_scale = 0.1
    assert opt.learning_rate() == pytest.approx(1e-3)
    for g in grads:
        p.grad = torch.from_numpy(g.copy())
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params), rtol=1e-6, atol=1e-7)


def _rollback_cfg(tmp_path, **extra):
    return preset("single", **{
        "data.image_size": 32, "data.global_batch_size": 8, "data.eval_batch_size": 8,
        "data.synthetic_num_train": 16, "data.synthetic_num_test": 8, "data.num_workers": 0,
        "model.growth_rate": 4, "model.block_config": (2, 2), "model.num_init_features": 8,
        "model.bn_size": 2, "train.max_epochs": 3, "train.nan_policy": "recover",
        "train.nan_max_consecutive": 1, "train.nan_grace_periods": 1,
        "train.save_best_qwk": False, "train.keep_snapshots": 1,
        "train.log_dir": str(tmp_path / "logs"), "train.checkpoint_dir": str(tmp_path / "ckpt"),
        **extra})


def test_trainer_rolls_back_to_the_snapshot_with_a_grace_window(tmp_path, monkeypatch):
    """``nan@step`` in epoch 1 with ``nan_policy="recover"``: the loop rolls
    back to the epoch-0 snapshot (a ``rollback`` event), the restored state
    is the snapshot's bit for bit, epoch 1 runs again at 0.1 x the learning
    rate, epoch 2 at 1x, and the run ends finite."""
    monkeypatch.setenv("DDL_JOB_ID", "rollback")
    cfg = _rollback_cfg(tmp_path)
    t = Trainer(cfg, device="cpu")
    t.snapshot_due = lambda epoch: epoch == 0  # a cadence save of epoch 0 only
    lrs, restored = [], {}
    step = t.optimizer.step

    def spy_step():
        lrs.append((t.epochs_run, t.optimizer.learning_rate()))
        step()

    t.optimizer.step = spy_step
    restore = t._rollback_restore

    def spy_restore(epoch):
        restore(epoch)
        restored.update(model={k: v.clone() for k, v in t.model.state_dict().items()},
                        count=t.optimizer.count)

    t._rollback_restore = spy_restore
    faultinject.activate("nan@step:2")  # epoch 1's first step (2 steps an epoch)
    t.train()
    assert t.recovery.rollbacks == 1 and t.update_scale == 1.0
    snap, _ = ckpt.load_snapshot(tmp_path / "ckpt", "rollback", 0)
    for k, v in snap["model"].items():
        assert torch.equal(restored["model"][k], v), k
    assert restored["count"] == snap["optimizer"]["count"] == 2
    lr = cfg.train.learning_rate
    assert [round(x / lr, 6) for _, x in lrs] == [1, 1, 1, 1, 0.1, 0.1, 1, 1]
    assert [e for e, _ in lrs] == [0, 0, 1, 1, 1, 1, 2, 2]
    events = read_events(events_path(tmp_path / "logs", "rollback"))
    (rb,) = [e for e in events if e["kind"] == "rollback"]
    assert (rb["period"], rb["resumed_at"], rb["grace_scale"]) == (1, 1, 0.1)
    anomalies = [e for e in events if e["kind"] == "anomaly"]
    assert [a["type"] for a in anomalies] == ["nonfinite_loss"]
    assert np.isfinite(t.run_period(3)[0]["loss"])


def test_trainer_with_recover_and_no_snapshot_halts(tmp_path, monkeypatch):
    monkeypatch.setenv("DDL_JOB_ID", "no-snapshot")
    t = Trainer(_rollback_cfg(tmp_path), device="cpu")
    faultinject.activate("nan@step:0")
    with pytest.raises(RuntimeError, match="no snapshot to roll back"):
        t.train()
    assert t.epochs_run == 0
