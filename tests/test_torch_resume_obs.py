"""Exact resume and the event stream of the port's DenseNet Trainer
(ddl_tpu_torch/train/trainer.py, obs/) against the JAX package's: both
Trainers start from one JAX state (``from_jax_train_state``), are
preempted mid-epoch by ``preempt@step`` and resumed, and record the same
cursor, consume the same batches and reach the same losses; the port's
``events.jsonl`` reads with the JAX ``read_events`` and has the JAX kinds
and keys.  Also the loader's start batch and I/O retry, the gradient
statistics and their CSV, the watchdog, the anomaly detectors, the config
copy and the ``profile_dir`` hook."""

import dataclasses
import functools
import random
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl_tpu import checkpoint as jax_ckpt
from ddl_tpu.config import Config as JaxConfig
from ddl_tpu.config import MeshConfig as JaxMeshConfig
from ddl_tpu.config import preset as jax_preset
from ddl_tpu.data import DataLoader as JaxDataLoader
from ddl_tpu.data import ShardedEpochSampler as JaxSampler
from ddl_tpu.data import SyntheticAptosDataset as JaxSyntheticAptosDataset
from ddl_tpu.models import build_stages
from ddl_tpu.obs.anomaly import AnomalyMonitor as JaxAnomalyMonitor
from ddl_tpu.obs.events import read_events as jax_read_events
from ddl_tpu.parallel.mesh import MeshSpec, build_mesh
from ddl_tpu.train import Trainer as JaxTrainer
from ddl_tpu.train.state import create_train_state, make_optimizer
from ddl_tpu.train.steps import make_grad_stats_fn as jax_make_grad_stats_fn
from ddl_tpu.utils import faultinject as jax_faultinject
from ddl_tpu.utils.csv_logger import MetricLogger as JaxMetricLogger
from ddl_tpu_torch import checkpoint as ckpt
from ddl_tpu_torch.config import Config, MeshConfig, preset
from ddl_tpu_torch.data import DataLoader, ShardedEpochSampler, SyntheticAptosDataset
from ddl_tpu_torch.models import DenseNet, build_stage_specs, from_jax_params
from ddl_tpu_torch.models.convert import from_jax_train_state
from ddl_tpu_torch.obs import AnomalyMonitor, EventWriter, Watchdog, events_path
from ddl_tpu_torch.ops import normalize_images
from ddl_tpu_torch.train import Trainer, make_optimizer as port_make_optimizer
from ddl_tpu_torch.train.steps import make_grad_stats_fn, make_train_step
from ddl_tpu_torch.utils import MetricLogger, faultinject

JOB = "cursor-exact"
# tests/test_fault_tolerance.py::test_cnn_mid_epoch_preempt_resumes_at_exact_batch
OVERRIDES = {
    "data.image_size": "32", "data.global_batch_size": "8", "data.eval_batch_size": "8",
    "data.synthetic_num_train": "48", "data.synthetic_num_test": "16",
    "data.num_workers": "0", "data.dataset_dir": "", "model.growth_rate": "4",
    "model.block_config": "[2,2]", "model.num_init_features": "8", "model.bn_size": "2",
    "train.max_epochs": "3", "train.save_best_qwk": "false",
}
# JAX-only event kinds the port leaves to later ROADMAP items: XLA's
# persistent compile cache (not ported) and the HBM ledger (item 9)
DEFERRED_KINDS = {"compile_cache", "hbm_plan", "hbm_sample"}


@pytest.fixture(autouse=True)
def _clean_injectors():
    faultinject.deactivate()
    jax_faultinject.deactivate()
    yield
    faultinject.deactivate()
    jax_faultinject.deactivate()


def _preempt_and_resume(make, pkg):
    """Run ``make()`` (a Trainer) under ``preempt@step:8``, then resume it
    with a second ``make()``; returns what both runs did."""
    pkg.activate("preempt@step:8")  # 6 batches an epoch: epoch 1, 3 batches in
    first = make()
    first.train()
    pkg.deactivate()
    second = make()
    resumed_at = (second.epochs_run, second._resume_offset)
    consumed, losses = [], []
    run_period = second.run_period

    def spy(epoch, guard=None):
        metrics, steps = run_period(epoch, guard)
        consumed.append((epoch, steps))
        losses.append(metrics["loss"])
        return metrics, steps

    second.run_period = spy
    second.train()
    return {"preempted": first.preempted, "resumed_at": resumed_at, "consumed": consumed,
            "losses": losses}


@functools.cache
def _runs(root: str) -> dict:
    """Both packages' preempt-and-resume runs, the port starting from the
    JAX Trainer's initial state (cached: several tests read one run)."""
    import os

    os.environ["DDL_JOB_ID"] = JOB
    try:
        def jax_make():
            cfg = jax_preset("single", **OVERRIDES, **{
                "train.log_dir": f"{root}/jax/logs", "train.checkpoint_dir": f"{root}/jax/ckpt"})
            return JaxTrainer(cfg)

        initial = jax.device_get(jax_make().state)
        # that constructor's events are not part of the run
        events_path(f"{root}/jax/logs", JOB).unlink()

        def port_make():
            cfg = preset("single", **OVERRIDES, **{
                "train.log_dir": f"{root}/port/logs", "train.checkpoint_dir": f"{root}/port/ckpt"})
            t = Trainer(cfg, device="cpu")
            if t.epochs_run == 0:  # a fresh start: JAX's initial state
                t.load_state(from_jax_train_state(
                    initial, [k for k, _ in t.model.named_parameters()]))
            return t

        jax_run = _preempt_and_resume(jax_make, jax_faultinject)
        port_run = _preempt_and_resume(port_make, faultinject)
    finally:
        os.environ.pop("DDL_JOB_ID", None)
    return {"jax": jax_run, "port": port_run}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("resume"))
    return root, _runs(root)


def test_mid_epoch_preempt_resumes_at_the_exact_batch_as_jax(runs):
    root, out = runs
    port, want = out["port"], out["jax"]
    assert port["preempted"] and want["preempted"]
    assert (ckpt.read_cursor(f"{root}/port/ckpt", JOB, 1)
            == jax_ckpt.read_cursor(f"{root}/jax/ckpt", JOB, 1) == {"period": 1, "offset": 3})
    assert port["resumed_at"] == want["resumed_at"] == (1, 3)
    # epoch 1's remaining 3 batches, then a full epoch 2: nothing replayed
    assert port["consumed"] == want["consumed"] == [(1, 3), (2, 6)]
    np.testing.assert_allclose(port["losses"], want["losses"], rtol=1e-4)


def _kinds_and_keys(events) -> dict:
    out = {}
    for e in events:
        keys = set(e)
        if e["kind"] == "span":
            keys.add(f"span:{e['name']}")
        out.setdefault(e["kind"], set()).update(keys)
    return out


def test_event_stream_has_the_jax_kinds_and_keys(runs):
    """The port's stream, read by the JAX package's ``read_events``: the
    same kinds (less the deferred ones), the same keys per kind and the
    same span names, and a ``period`` event per period with its phases."""
    root, _ = runs
    got = jax_read_events(events_path(f"{root}/port/logs", JOB))
    want = jax_read_events(events_path(f"{root}/jax/logs", JOB))
    got_kinds, want_kinds = _kinds_and_keys(got), _kinds_and_keys(want)
    # compile_cache flows only with JAX's persistent compile cache on
    assert {"hbm_plan", "hbm_sample"} <= set(want_kinds) - set(got_kinds) <= DEFERRED_KINDS
    for kind in DEFERRED_KINDS:
        want_kinds.pop(kind, None)
    assert got_kinds == want_kinds
    periods = [(e["period"], e["steps"], e["offset"]) for e in got if e["kind"] == "period"]
    assert periods == [(e["period"], e["steps"], e["offset"])
                       for e in want if e["kind"] == "period"]
    assert periods == [(0, 6, 0), (1, 3, 0), (1, 3, 3), (2, 6, 0)]
    restore = [e for e in got if e["kind"] == "snapshot_restore"]
    assert [(e["epoch"], e["period"], e["offset"]) for e in restore] == [(1, 1, 3)]
    for e in (e for e in got if e["kind"] == "period"):
        assert {"data_wait", "h2d", "step", "fence", "eval"} <= e["phases"].keys()
        assert e["rates"]["opt_hbm_bytes"] > 0 and e["compiles"] == 0


def test_loader_start_batch_and_io_retry_match_jax():
    """The same batches as the JAX loader: a one-shot index-level skip, and
    ``io@batch`` faults retried (each retry reported) without changing a
    batch."""
    ds_port = SyntheticAptosDataset(40, 8, 5, seed=3)
    ds_jax = JaxSyntheticAptosDataset(40, 8, 5, seed=3)
    got, want, notes = [], [], {"port": [], "jax": []}
    for pkg, ds, loader_cls, sampler_cls, out, tag in (
            (faultinject, ds_port, DataLoader, ShardedEpochSampler, got, "port"),
            (jax_faultinject, ds_jax, JaxDataLoader, JaxSampler, want, "jax")):
        pkg.activate("io@batch:3:2,io@batch:17")
        loader = loader_cls(ds, 8, sampler=sampler_cls(40, seed=4), num_workers=0,
                            on_retry=lambda e, i, tag=tag: notes[tag].append(i))
        for epoch, skip in ((0, 2), (1, 0), (2, 4)):
            loader.set_epoch(epoch)
            if skip:
                loader.set_start_batch(skip)
            out.append([(im.copy(), lb.copy()) for im, lb in loader])
        out.append(loader.retry_count)
        pkg.deactivate()
    assert got[-1] == want[-1] == 3 and notes["port"] == notes["jax"]
    for g_epoch, w_epoch in zip(got[:-1], want[:-1]):
        assert len(g_epoch) == len(w_epoch)
        for (gi, gl), (wi, wl) in zip(g_epoch, w_epoch):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
    assert [len(e) for e in got[:-1]] == [3, 5, 1]


GRAD_MODEL = dict(growth_rate=4, block_config=(2, 2), num_init_features=8, bn_size=2,
                  num_classes=5, compute_dtype="float32")


def test_grad_stats_match_jax_and_write_its_csv(tmp_path):
    """The train step's own gradients (before the update) give the JAX
    ``make_grad_stats_fn`` numbers to rtol 1e-4 under the JAX names and
    order; the CSV rows have JAX's 14 columns and names; and the running
    statistics move once, not twice."""
    from ddl_tpu.config import ModelConfig as JaxModelConfig
    from ddl_tpu.config import TrainConfig as JaxTrainConfig
    from ddl_tpu_torch.config import ModelConfig, TrainConfig

    stages = build_stages(JaxModelConfig(**GRAD_MODEL, remat=False), num_stages=1)
    state = create_train_state(stages, make_optimizer(JaxTrainConfig()), jax.random.key(0), 16)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (4, 16, 16, 3), dtype=np.uint8)
    labels = rng.integers(0, 5, 4).astype(np.int32)
    want = jax.device_get(jax_make_grad_stats_fn(stages, build_mesh(MeshSpec(1, 1)),
                                                 jnp.float32)(state, images, labels))

    cfg = ModelConfig(**GRAD_MODEL)
    model = DenseNet(cfg, num_stages=1)
    model.load_state_dict(from_jax_params(*jax.device_get((state.params, state.batch_stats))))
    stats_fn = make_grad_stats_fn(model, build_stage_specs(cfg, num_stages=1))
    plain = DenseNet(cfg, num_stages=1)
    plain.load_state_dict(model.state_dict())
    got = {}
    for net, hook in ((model, lambda: got.update(stats_fn())), (plain, None)):
        step = make_train_step(net.train(), port_make_optimizer(net.parameters(), TrainConfig()),
                               torch.float32, normalize_images, on_grads=hook)
        step(torch.from_numpy(images), torch.from_numpy(labels))
    assert list(got) == list(want)
    # rtol 1e-4 above the f32 noise floor of the two packages' gradients,
    # 1e-4 of the model's largest (tests/test_torch_train.py): a weight
    # that feeds a train-mode BatchNorm (the stem's scale) has a gradient
    # that is the small sum of two cancelling terms, ~1e-7 here
    floor = 1e-4 * max(float(v[2]) for v in want.values())
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=floor, err_msg=name)
    # the statistics cost no forward of their own: the running statistics
    # and the weights after the step are those of a step without them
    for (k, a), b in zip(model.state_dict().items(), plain.state_dict().values()):
        assert torch.equal(a, b), k

    for cls, sub, stats in ((MetricLogger, "port", got), (JaxMetricLogger, "jax", want)):
        cls(tmp_path / sub, "job").log_gradient_stats(stats, step=3)
    rows = {sub: [r.split(",") for r in (tmp_path / sub / "gradient.csv").read_text().splitlines()]
            for sub in ("port", "jax")}
    assert all(len(r) == 14 for r in rows["port"])
    assert [r[1:7] for r in rows["port"]] == [r[1:7] for r in rows["jax"]]


def test_trainer_logs_gradient_stats_every_step(tmp_path, monkeypatch):
    monkeypatch.setenv("DDL_JOB_ID", "grads")
    cfg = preset("single", **{**OVERRIDES, "data.synthetic_num_train": "16",
                              "train.max_epochs": "1", "train.log_gradient_stats": "true",
                              "train.log_dir": str(tmp_path / "logs"),
                              "train.checkpoint_dir": str(tmp_path / "ckpt")})
    t = Trainer(cfg, device="cpu")
    t.train()
    lines = (tmp_path / "logs" / "gradient.csv").read_text().splitlines()
    n_params = len(list(t.model.parameters()))
    assert len(lines) == 2 * n_params and all(len(r.split(",")) == 14 for r in lines)
    assert [int(r.split(",")[4]) for r in lines] == [0] * n_params + [1] * n_params
    assert lines[0].split(",")[6] == "stage0/classifier/bias"


def test_profile_dir_traces_one_period(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("DDL_JOB_ID", "prof")
    cfg = preset("single", **{**OVERRIDES, "data.synthetic_num_train": "16",
                              "train.max_epochs": "2", "train.profile_dir": str(tmp_path / "prof"),
                              "train.log_dir": str(tmp_path / "logs"),
                              "train.checkpoint_dir": str(tmp_path / "ckpt")})
    Trainer(cfg, device="cpu").train()
    assert (tmp_path / "prof" / "prof-trace.json").stat().st_size > 0
    assert capsys.readouterr().out.count("[profile] trace") == 1


def _writer_events(writer):
    writer.close()
    return jax_read_events(writer.path)


def test_watchdog_dumps_a_stall_and_stays_quiet_while_beating(tmp_path):
    stalled = EventWriter(tmp_path, "wd-stall", host=0)
    with Watchdog(stalled, deadline_s=0.05, interval_s=0.01):
        time.sleep(0.3)
    events = _writer_events(stalled)
    stalls = [e for e in events if e["kind"] == "stall"]
    assert len(stalls) == 1 and stalls[0]["action"] == "dump"
    assert any("test_watchdog_dumps" in s for s in stalls[0]["stacks"].values())

    beating = EventWriter(tmp_path, "wd-beat", host=0)
    with Watchdog(beating, deadline_s=0.2, interval_s=0.01) as wd:
        for i in range(30):
            wd.beat(i)
            time.sleep(0.01)
    events = _writer_events(beating)
    assert not [e for e in events if e["kind"] == "stall"]
    assert [e for e in events if e["kind"] == "heartbeat"]

    exits = []
    escalating = EventWriter(tmp_path, "wd-exit", host=0)
    wd = Watchdog(escalating, deadline_s=0.05, interval_s=0.01, on_stall="exit",
                  exit_fn=exits.append).start()
    deadline = time.monotonic() + 2.0
    while not exits and time.monotonic() < deadline:
        time.sleep(0.01)
    wd.stop()
    assert exits == [75]
    assert [e["code"] for e in _writer_events(escalating) if e["kind"] == "watchdog_exit"] == [75]
    assert threading.active_count() < 50


def test_anomaly_monitor_matches_jax():
    rng = random.Random(0)
    port, ref = AnomalyMonitor(), JaxAnomalyMonitor()
    found = []
    for i in range(40):
        loss = 1.0 + 0.01 * rng.random() + (5.0 if i == 30 else 0.0)
        loss = float("nan") if i == 20 else loss
        sps = 10.0 - (6.0 if i == 35 else 0.0)
        hbm = 1000 + (i * 200 if i > 25 else 0)
        for mon in (port, ref):
            found.append(mon.observe_period(i, loss=loss, steps_per_sec=sps, hbm_bytes=hbm,
                                            compiles=1 if i == 36 else 0))
            if i == 20:
                mon.record(i, "nonfinite_loss", value=loss)
    assert str(found[0::2]) == str(found[1::2])
    assert str(port.anomalies) == str(ref.anomalies)
    assert port.summary_lines() == ref.summary_lines()
    assert {a["type"] for a in port.anomalies} == {"loss_spike", "throughput_regression",
                                                   "hbm_growth", "nonfinite_loss"}


def test_config_carries_every_jax_field_and_refuses_the_unported():
    cfg = preset("single", **{"train.checkpoint_dir": "x", "train.nan_policy": "recover",
                              "train.keep_snapshots": "2"})
    assert (cfg.train.checkpoint_dir, cfg.train.nan_policy, cfg.train.keep_snapshots) == (
        "x", "recover", 2)
    assert dataclasses.asdict(Config()) == dataclasses.asdict(JaxConfig())
    with pytest.raises(NotImplementedError, match="item 9"):
        preset("single", **{"train.zero_sharding": "true"})
    with pytest.raises(NotImplementedError, match="item 7"):
        Config(strategy="dp", mesh=MeshConfig(2, 1)).validate()
    with pytest.raises(NotImplementedError, match="item 8"):
        Config(strategy="pp", mesh=MeshConfig(1, 2)).validate()
    for bad in (dict(strategy="single", mesh=(2, 1)), dict(strategy="dp", mesh=(1, 2))):
        for cls, mesh_cls in ((Config, MeshConfig), (JaxConfig, JaxMeshConfig)):
            with pytest.raises(ValueError, match="requires"):
                cls(strategy=bad["strategy"], mesh=mesh_cls(*bad["mesh"])).validate()
    for cls in (Config, JaxConfig):
        c = cls()
        c.train.nan_policy = "rollback"
        with pytest.raises(ValueError, match="unknown nan_policy"):
            c.validate()
