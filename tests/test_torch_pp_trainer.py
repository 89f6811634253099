"""The port's pipelined Trainer through its command line (``python -m
ddl_tpu_torch.cli --preset pp`` and ``--preset dp_pp``, ranks started by
its own spawner, gloo on the CPU) against the JAX package's Trainer on the
simulated devices: the epoch loss, the eval metrics over every test image
once, one set of CSV rows and the ``pipe_schedule`` event.  Then the
snapshots in the pipelined layout: a preemption seen by one rank stops
every rank after the same step, the relaunch resumes and ends bit-equal to
the same run uninterrupted, a ``dp_pp`` run resumes a ``pp`` snapshot, a
snapshot of the other layout is refused naming both, a rollback restores
every stage, and ``train --supervise`` relaunches the whole world.  Last,
each stage's weights and forward against the JAX stages for 2, 3 and 4
stages, and the port's copies of ``schedule_summary`` and of the split
explorer against the JAX package's."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ddl_tpu_torch import checkpoint as ckpt
from ddl_tpu_torch import cli, launch
from ddl_tpu_torch.config import ModelConfig, preset
from ddl_tpu_torch.supervisor import EXIT_PREEMPTED
from ddl_tpu_torch.utils.csv_logger import read_metric_csv

ROOT = Path(__file__).resolve().parents[1]
# test_trainer.py's tiny pipelined model: two blocks cut between them
MODEL = ["model.growth_rate=4", "model.block_config=[2,2]", "model.num_init_features=8",
         "model.bn_size=2", "model.split_blocks=[1]", "data.image_size=16",
         "data.num_workers=0", "data.dataset_dir=", "train.num_microbatches=2"]
# 64 training images in global batches of 16: 4 steps an epoch; 28 eval
# images in global batches of 16, the last one 12 real rows and 4 sentinels
DATA = ["data.synthetic_num_train=64", "data.synthetic_num_test=28",
        "data.global_batch_size=16", "data.eval_batch_size=16"]
# the presets' meshes and schedules: pp on two ranks with gpipe and remat
# (the preset's), dp_pp on a (2, 2) mesh with 1f1b and no remat
RUNS = {"pp": (2, ["train.pipeline_schedule=gpipe"]),
        "dp_pp": (4, ["mesh.data=2", "train.pipeline_schedule=1f1b", "model.remat=false"])}
# One rank of a spawned world: the fault of this rank only
# (TEST_FAULT_RANK<r>), then the command line; a finished Trainer's stage
# state goes to <out>/final-r<r>.pt.
RANK = """
import os, sys, torch
rank = os.environ["DDL_PROCESS_ID"]
if os.environ.get("TEST_FAULT_RANK" + rank):
    os.environ["DDL_FAULT"] = os.environ["TEST_FAULT_RANK" + rank]
from ddl_tpu_torch.cli import main
trainer = main(sys.argv[2:])
torch.save(trainer.stage_state(), os.path.join(sys.argv[1], f"final-r{rank}.pt"))
"""


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith(("DDL_", "TEST_"))}
    return dict(env, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT), **extra)


def _world(out: Path, strategy: str, args: list[str], **env) -> int:
    """The ``strategy`` command line as its spawned ranks running ``RANK``."""
    n, extra = RUNS[strategy]
    out.mkdir(parents=True, exist_ok=True)
    return launch.spawn_local(
        [sys.executable, "-c", RANK, str(out), "--preset", strategy, "--cpu-devices", str(n),
         "--set", *MODEL, *extra, *args], n, env=_env(**env), log_dir=out / "ranks",
        timeout_s=300)


def _events(log_dir: Path, job: str, host: int) -> list[dict]:
    path = log_dir / "by_job_id" / job / f"events-h{host:03d}.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()]


def _rank_logs(out: Path, n: int = 2) -> str:
    return "\n".join(f"--- rank {r}:\n" + (out / "ranks" / f"rank{r}.log").read_text()[-2000:]
                     for r in range(n))


@pytest.mark.parametrize("strategy", ["pp", "dp_pp"])
def test_cli_pipeline_matches_the_jax_trainer(strategy, tmp_path, monkeypatch):
    """One epoch of ``cli.main(["--preset", strategy, ...])`` from the JAX
    Trainer's initial weights (carried over as a torchvision-style .pth,
    ``model.pretrained_path``): the epoch loss within 1e-4 relative, the
    eval metrics over all 28 test images once (val_loss within 1e-4
    relative; accuracy, QWK and the train accuracy equal), the CSV rows
    written once, by rank 0, and one ``pipe_schedule`` event a rank equal
    to the JAX model's summary."""
    import jax

    from ddl_tpu.config import preset as jax_preset
    from ddl_tpu.obs.schedule_model import schedule_summary
    from ddl_tpu.train import Trainer as JaxTrainer
    from ddl_tpu_torch.models import from_jax_params

    n, extra = RUNS[strategy]
    job = f"{strategy}-parity"
    monkeypatch.setenv("DDL_JOB_ID", job)
    overrides = dict(item.split("=", 1) for item in MODEL + extra + DATA)
    jax_cfg = jax_preset(strategy, **overrides, **{
        "train.max_epochs": "1", "train.log_dir": str(tmp_path / "jax" / "logs"),
        "train.checkpoint_dir": str(tmp_path / "jax" / "ckpt")})
    jt = JaxTrainer(jax_cfg)
    weights = tmp_path / "initial.pth"
    torch.save(from_jax_params(*jax.device_get((jt.state.params, jt.state.batch_stats))),
               weights)
    jt.train()

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    logs = tmp_path / "port" / "logs"
    assert cli.main(["--preset", strategy, "--cpu-devices", str(n), "--set", *MODEL, *extra,
                     *DATA, "train.max_epochs=1", f"model.pretrained_path={weights}",
                     f"train.log_dir={logs}",
                     f"train.checkpoint_dir={tmp_path / 'port' / 'ckpt'}"]) is None

    def rows(root, metric):
        return read_metric_csv(root / "by_job_id" / job / f"{metric}.csv")

    jax_logs = tmp_path / "jax" / "logs"
    got, want = rows(logs, "loss"), rows(jax_logs, "loss")
    assert [(r["global_rank"], r["epoch"]) for r in got] == [(0, 0)]
    np.testing.assert_allclose(got[0]["value"], want[0]["value"], rtol=1e-4)
    assert rows(logs, "val_examples")[0]["value"] == rows(jax_logs, "val_examples")[0]["value"] \
        == 28
    np.testing.assert_allclose(rows(logs, "val_loss")[0]["value"],
                               rows(jax_logs, "val_loss")[0]["value"], rtol=1e-4)
    for metric in ("val_accuracy", "qwk", "train_accuracy"):
        assert rows(logs, metric)[0]["value"] == rows(jax_logs, metric)[0]["value"], metric
    schedule = jax_cfg.train.pipeline_schedule
    summary = schedule_summary(schedule, 2, 2)
    for host in range(n):
        events = _events(logs, job, host)
        assert [(e["host"], e["steps"]) for e in events if e["kind"] == "period"] == [(host, 4)]
        (sched,) = [e for e in events if e["kind"] == "pipe_schedule"]
        assert (sched["schedule"], sched["pipe"], sched["microbatches"]) == (schedule, 2, 2)
        for key in ("makespan", "idle_units", "bubble_fraction", "per_stage"):
            assert sched[key] == summary[key], key


@pytest.fixture(scope="module")
def recovery(tmp_path_factory):
    """``pp``, 3 epochs of 4 steps: (a) preempt@step:5 on rank 1 only,
    supervised; (b) the relaunch of the same job; (c) the same run
    uninterrupted as another job; (d) ``dp_pp`` on (2, 2) resuming (c)'s
    last snapshot for one more epoch."""
    root = tmp_path_factory.mktemp("pp_recovery")
    # no QWK-gated saves: the preemption's own save is (a)'s one snapshot
    args = [*DATA, "train.max_epochs=3", "train.save_best_qwk=false",
            f"train.log_dir={root / 'logs'}", f"train.checkpoint_dir={root / 'ckpt'}"]
    runs = {"a": _world(root / "a", "pp", args, DDL_JOB_ID="pp-preempt", DDL_SUPERVISED="1",
                        TEST_FAULT_RANK1="preempt@step:5")}
    cursor = {e: ckpt.read_cursor(root / "ckpt", "pp-preempt", e)
              for e in ckpt.snapshot_epochs(root / "ckpt", "pp-preempt")}
    runs["b"] = _world(root / "b", "pp", args, DDL_JOB_ID="pp-preempt")
    runs["c"] = _world(root / "c", "pp", [*args, "train.save_best_qwk=true"],
                       DDL_JOB_ID="pp-whole")
    last = ckpt.latest_epoch(root / "ckpt", "pp-whole")
    runs["d"] = _world(root / "d", "dp_pp", [
        *DATA, f"train.max_epochs={last + 2}", "train.snapshot_job_id=pp-whole",
        f"train.snapshot_epoch={last}", f"train.log_dir={root / 'logs'}",
        f"train.checkpoint_dir={root / 'ckpt'}"], DDL_JOB_ID="dp-pp-resume")
    return root, runs, cursor, last


def test_preemption_on_one_rank_stops_both_after_the_same_step(recovery):
    """Rank 1 alone is preempted after global step 5 (epoch 1, batch 1):
    both ranks stop there, rank 0 commits the cursor {period 1, offset 2}
    in the pipelined layout, and the spawner returns EXIT_PREEMPTED."""
    root, runs, cursor, _ = recovery
    assert runs["a"] == EXIT_PREEMPTED, _rank_logs(root / "a")
    assert cursor == {1: {"period": 1, "offset": 2}}
    saved = torch.load(ckpt.snapshot_path(root / "ckpt", "pp-preempt", 1) / ckpt.STATE_FILE,
                       weights_only=True)["state"]
    assert sorted(saved) == ["stages"] and len(saved["stages"]) == 2
    for host in (0, 1):
        events = _events(root / "logs", "pp-preempt", host)
        kinds = [e["kind"] for e in events]
        first_run = events[:kinds.index("run_end") + 1]
        assert [e["steps"] for e in first_run if e["kind"] == "period"] == [4, 2], host


def test_relaunch_resumes_and_equals_the_whole_run(recovery):
    """The relaunch restores each stage from the preemption's snapshot at
    its cursor, finishes the run and ends bit-equal to the uninterrupted
    run, stage for stage, Adam's moments included."""
    root, runs, _, _ = recovery
    assert runs["b"] == 0 and runs["c"] == 0, _rank_logs(root / "b")
    for host in (0, 1):
        restores = [e for e in _events(root / "logs", "pp-preempt", host)
                    if e["kind"] == "snapshot_restore"]
        assert [(e["epoch"], e["period"], e["offset"]) for e in restores] == [(1, 1, 2)], host
    for r in (0, 1):
        got = torch.load(root / "b" / f"final-r{r}.pt", weights_only=True)
        want = torch.load(root / "c" / f"final-r{r}.pt", weights_only=True)
        for k, v in want["model"].items():
            assert torch.equal(got["model"][k], v), (r, k)
        for i, per_param in want["optimizer"]["inner"]["state"].items():
            for k, v in per_param.items():
                assert torch.equal(got["optimizer"]["inner"]["state"][i][k], v), (r, i, k)
    loss = {job: [r["value"] for r in read_metric_csv(
        root / "logs" / "by_job_id" / job / "loss.csv")] for job in ("pp-preempt", "pp-whole")}
    assert loss["pp-preempt"][-1] == loss["pp-whole"][-1]


def test_dp_pp_resumes_a_pp_snapshot(recovery):
    """The data axis replicates each stage, so a ``pp`` snapshot restores
    onto a (2, 2) mesh (as the JAX package's does): every rank restores its
    stage and the run trains one more epoch, the data rows ending equal."""
    root, runs, _, last = recovery
    assert runs["d"] == 0, _rank_logs(root / "d", 4)
    for host in range(4):
        restores = [e for e in _events(root / "logs", "dp-pp-resume", host)
                    if e["kind"] == "snapshot_restore"]
        assert [e["epoch"] for e in restores] == [last], host
    states = [torch.load(root / "d" / f"final-r{r}.pt", weights_only=True) for r in range(4)]
    for s in (0, 1):
        for k, v in states[s]["model"].items():
            assert torch.equal(states[2 + s]["model"][k], v), (s, k)


def test_a_snapshot_of_the_other_layout_is_refused(recovery, tmp_path):
    """A ``single`` Trainer refuses the pipelined snapshot and a ``pp``
    world the one-device one, each naming both layouts."""
    from ddl_tpu_torch.train import Trainer

    root, _, _, last = recovery
    cfg = preset("single", **dict(item.split("=", 1) for item in MODEL + DATA), **{
        "train.snapshot_job_id": "pp-whole", "train.snapshot_epoch": str(last),
        "train.checkpoint_dir": str(root / "ckpt"), "train.log_dir": ""})
    with pytest.raises(ValueError, match="pipelined layout of 2 stages; this run needs the "
                                         "one-device layout"):
        Trainer(cfg, device="cpu")
    one = {"model": Trainer(preset("single", **dict(item.split("=", 1) for item in MODEL + DATA),
                                   **{"train.log_dir": "", "train.checkpoint_dir": "",
                                      "train.auto_resume": "false"}),
                            device="cpu").model.state_dict(), "optimizer": {}}
    ckpt.save_snapshot(tmp_path / "ckpt", "one", 0, one)
    code = _world(tmp_path / "w", "pp", [*DATA, f"train.checkpoint_dir={tmp_path / 'ckpt'}",
                                         f"train.log_dir={tmp_path / 'logs'}"],
                  DDL_JOB_ID="one")
    assert code != 0
    log = (tmp_path / "w" / "ranks" / "rank0.log").read_text()
    assert "one-device layout" in log and "pipelined layout of 2 stages" in log, log[-2000:]
    with pytest.raises(ValueError, match="cut elsewhere"):
        ckpt.require_layout({"stages": [{"model": {"a": 0}}, {"model": {}}]}, 2, 0, ["b"], (2,))


def test_rollback_restores_every_stage(tmp_path):
    """``nan_policy=recover`` with one non-finite epoch (``nan@step:5``,
    every rank) and ``nan_max_consecutive=1``: every rank rolls back to
    rank 0's latest valid snapshot, each stage restoring its own, and the
    run ends."""
    args = [*DATA, "train.max_epochs=3", "train.nan_policy=recover",
            "train.nan_max_consecutive=1", f"train.log_dir={tmp_path / 'logs'}",
            f"train.checkpoint_dir={tmp_path / 'ckpt'}"]
    code = _world(tmp_path / "run", "pp", args, DDL_JOB_ID="pp-rollback",
                  DDL_FAULT="nan@step:5")
    assert code == 0, _rank_logs(tmp_path / "run")
    for host in (0, 1):
        rollbacks = [e for e in _events(tmp_path / "logs", "pp-rollback", host)
                     if e["kind"] == "rollback"]
        assert [(e["period"], e["resumed_at"]) for e in rollbacks] == [(1, 1)], host


def test_supervised_pipeline_world_relaunches_and_finishes(tmp_path):
    """``python -m ddl_tpu_torch.cli train --supervise --preset pp
    --cpu-devices 2`` preempted at step 5 on both ranks: the supervisor
    relaunches the whole world once, each rank restores its stage at the
    preemption's cursor, and the run exits 0."""
    env = _env(DDL_FAULT="preempt@step:5", DDL_JOB_ID="pp-sup",
               DDL_LOG_DIR=str(tmp_path / "logs"), DDL_CHECKPOINT_DIR=str(tmp_path / "ckpt"))
    cmd = [sys.executable, "-m", "ddl_tpu_torch.cli", "train", "--supervise", "--max-restarts",
           "2", "--preset", "pp", "--cpu-devices", "2", "--set", *MODEL, *RUNS["pp"][1], *DATA,
           "train.max_epochs=2"]
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "run complete after 1 relaunch(es)" in proc.stdout
    for host in (0, 1):
        events = _events(tmp_path / "logs", "pp-sup", host)
        restores = [e for e in events if e["kind"] == "snapshot_restore"]
        assert [(e["period"], e["offset"]) for e in restores] == [(1, 2)], host
    relaunches = [e for e in _events(tmp_path / "logs", "pp-sup", 0)
                  if e["kind"] == "supervisor_relaunch"]
    assert [e["reason"] for e in relaunches] == ["preempt"]


@pytest.mark.parametrize("split", [(2,), (1, 3), (1, 2, 3)], ids=["2", "3", "4"])
def test_stage_weights_round_trip_and_run_as_the_jax_stages(split):
    """For 2, 3 and 4 stages: JAX stage tree i loads into ``DenseNet(cfg,
    stage=i)`` key for key, comes back from its ``state_dict`` unchanged
    (``to_jax_params``), and the stages chained in eval mode give the JAX
    stages' outputs (1e-5 absolute, 1e-4 relative, as
    test_pipeline_eval_matches_sequential_eval), with the boundary shapes
    of ``stage_boundary_shapes``."""
    import jax
    import jax.numpy as jnp

    from ddl_tpu.config import ModelConfig as JaxModelConfig
    from ddl_tpu.models.densenet import apply_stage, build_stages, init_stages
    from ddl_tpu.models.densenet import stage_boundary_shapes as jax_boundary_shapes
    from ddl_tpu_torch.models import DenseNet, from_jax_params, to_jax_params
    from ddl_tpu_torch.models.densenet import stage_boundary_shapes

    tiny = dict(growth_rate=4, block_config=(2, 2, 2, 2), num_init_features=8, bn_size=2,
                num_classes=5, split_blocks=split)
    jax_stages = build_stages(JaxModelConfig(**tiny))
    params, stats = jax.device_get(init_stages(jax_stages, jax.random.key(3), 32))
    cfg = ModelConfig(**tiny, compute_dtype="float32")
    assert stage_boundary_shapes(cfg, 32) == jax_boundary_shapes(JaxModelConfig(**tiny), 32)
    images = np.random.default_rng(5).integers(0, 256, (4, 32, 32, 3)).astype(np.float32) / 255
    x, y = torch.from_numpy(images), jnp.asarray(images)
    for i in range(len(split) + 1):
        stage = DenseNet(cfg, stage=i).eval()
        stage.load_state_dict(from_jax_params((params[i],), (stats[i],)))
        back_params, back_stats = to_jax_params(stage.state_dict(), stage.stages)
        for got, want in ((back_params[i], params[i]), (back_stats[i], stats[i])):
            assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
            for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
                np.testing.assert_array_equal(g, w)
        with torch.no_grad():
            x = stage(x)
        y, _ = apply_stage(jax_stages[i], params[i], stats[i], y, train=False)
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_schedule_summary_is_the_jax_packages(schedule):
    """The port's model of its two schedules gives the JAX package's
    summary (single-chunk, unit costs) over a grid of stages and
    microbatches; the JAX event's ``virtual`` field is the loop's 1."""
    from ddl_tpu.obs.schedule_model import schedule_summary as jax_summary
    from ddl_tpu_torch.obs.schedule_model import schedule_summary

    for pipe in (1, 2, 3, 4):
        for m in (1, 2, 4, 5, 8):
            want = jax_summary(schedule, pipe, m)
            assert want.pop("virtual") == 1
            assert schedule_summary(schedule, pipe, m) == want, (pipe, m)


@pytest.mark.parametrize("schedule", ["interleaved", "zb"])
def test_schedule_summary_refuses_what_the_port_does_not_run(schedule):
    from ddl_tpu_torch.obs.schedule_model import schedule_summary

    with pytest.raises(ValueError, match="unknown schedule"):
        schedule_summary(schedule, 2, 4)


@pytest.mark.parametrize("stages", [2, 3])
def test_split_explorer_matches_the_jax_tool(stages):
    """Every legal split: the stages' parameter counts and the boundary
    bytes equal the JAX tool's; the FLOPs positive, and their sum equal
    over the splits (the same network, cut elsewhere)."""
    from ddl_tpu.config import ModelConfig as JaxModelConfig
    from ddl_tpu.tools.split_explorer import explore as jax_explore
    from ddl_tpu_torch.tools.split_explorer import explore

    tiny = dict(growth_rate=4, block_config=(2, 2, 2, 2), num_init_features=8, bn_size=2)
    got = explore(stages, 32, 6, ModelConfig(**tiny))
    want = jax_explore(stages, 32, 6, JaxModelConfig(**tiny))
    assert [r["split_blocks"] for r in got] == [r["split_blocks"] for r in want]
    for g, w in zip(got, want):
        assert g["stage_params"] == w["stage_params"]
        assert g["boundary_bytes_per_microbatch"] == w["boundary_bytes_per_microbatch"]
        assert all(f > 0 for f in g["stage_flops"])
    totals = {round(sum(r["stage_flops"])) for r in got}
    assert len(totals) == 1
