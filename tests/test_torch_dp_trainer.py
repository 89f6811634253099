"""The port's data-parallel Trainer through its command line
(``python -m ddl_tpu_torch.cli --preset dp``, ranks started by its own
spawner, gloo on the CPU) against the JAX package's dp Trainer on two
simulated devices: the epoch loss, the eval metrics over every test image
once, and one set of CSV rows.  Then recovery across ranks: a preemption
seen by one rank stops both after the same step (exit 75 from the
spawner), the relaunched world resumes from rank 0's choice of snapshot
while rank 1 sees the latest as torn, and ends bit-equal to the same run
uninterrupted; a rollback takes rank 0's snapshot on every rank."""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ddl_tpu_torch import checkpoint as ckpt
from ddl_tpu_torch import cli, launch
from ddl_tpu_torch.supervisor import EXIT_PREEMPTED
from ddl_tpu_torch.utils.csv_logger import read_metric_csv

ROOT = Path(__file__).resolve().parents[1]
MODEL = ["model.growth_rate=4", "model.block_config=[2,2]", "model.num_init_features=8",
         "model.bn_size=2", "model.remat=false", "data.image_size=16", "data.num_workers=0",
         "data.dataset_dir="]
# 40 training images in global batches of 8 (4 a rank): 5 steps an epoch;
# 20 eval images in global batches of 8: each rank's 10 in batches of 4,
# its last one 2 real rows and 2 sentinels
DATA = ["data.synthetic_num_train=40", "data.synthetic_num_test=20",
        "data.global_batch_size=8", "data.eval_batch_size=8"]
# One rank of a spawned world: the fault and the torn views of this rank
# only (TEST_FAULT_RANK<r>, TEST_TORN_RANK<r>), then the command line;
# a finished Trainer's state goes to <out>/final-r<r>.pt.
RANK = """
import os, sys, torch
rank = os.environ["DDL_PROCESS_ID"]
if os.environ.get("TEST_FAULT_RANK" + rank):
    os.environ["DDL_FAULT"] = os.environ["TEST_FAULT_RANK" + rank]
torn = os.environ.get("TEST_TORN_RANK" + rank)
if torn:
    from ddl_tpu_torch import checkpoint as ckpt
    verify = ckpt.verify_snapshot
    ckpt.verify_snapshot = lambda path: ((False, "torn in this rank's view")
                                         if str(path).endswith(torn) else verify(path))
from ddl_tpu_torch.cli import main
trainer = main(sys.argv[2:])
torch.save(trainer.snapshot_state(), os.path.join(sys.argv[1], f"final-r{rank}.pt"))
"""


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith(("DDL_", "TEST_"))}
    return dict(env, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT), **extra)


def _world(out: Path, args: list[str], **env) -> int:
    """The ``dp`` command line as two spawned ranks running ``RANK``."""
    out.mkdir(parents=True, exist_ok=True)
    return launch.spawn_local(
        [sys.executable, "-c", RANK, str(out), "--preset", "dp", "--cpu-devices", "2",
         "--set", *args], 2, env=_env(**env), log_dir=out / "ranks", timeout_s=300)


def _events(log_dir: Path, job: str, host: int) -> list[dict]:
    path = log_dir / "by_job_id" / job / f"events-h{host:03d}.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_cli_dp_matches_the_jax_dp_trainer(tmp_path, monkeypatch):
    """One epoch of ``cli.main(["--preset", "dp", "--cpu-devices", "2",
    ...])`` from the JAX dp Trainer's initial weights (carried over as a
    torchvision-style .pth, ``model.pretrained_path``): the epoch loss
    within 1e-4 relative (test_torch_cli's tolerance for the one-device
    run), the eval metrics over all 20 test images once (val_loss within
    1e-4 relative, accuracy and QWK equal), and the CSV rows written once,
    by rank 0."""
    import jax

    from ddl_tpu.config import preset as jax_preset
    from ddl_tpu.train import Trainer as JaxTrainer
    from ddl_tpu_torch.models import from_jax_params

    monkeypatch.setenv("DDL_JOB_ID", "dp-parity")
    overrides = dict(item.split("=", 1) for item in MODEL + DATA)
    jax_cfg = jax_preset("dp", **overrides, **{
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
    assert cli.main(["--preset", "dp", "--cpu-devices", "2", "--set", *MODEL, *DATA,
                     "train.max_epochs=1", f"model.pretrained_path={weights}",
                     f"train.log_dir={logs}",
                     f"train.checkpoint_dir={tmp_path / 'port' / 'ckpt'}"]) is None

    def rows(root, metric):
        return read_metric_csv(root / "by_job_id" / "dp-parity" / f"{metric}.csv")

    jax_logs = tmp_path / "jax" / "logs"
    got, want = rows(logs, "loss"), rows(jax_logs, "loss")
    assert [(r["global_rank"], r["epoch"]) for r in got] == [(0, 0)]
    np.testing.assert_allclose(got[0]["value"], want[0]["value"], rtol=1e-4)
    assert rows(logs, "val_examples")[0]["value"] == rows(jax_logs, "val_examples")[0]["value"] \
        == 20
    np.testing.assert_allclose(rows(logs, "val_loss")[0]["value"],
                               rows(jax_logs, "val_loss")[0]["value"], rtol=1e-4)
    for metric in ("val_accuracy", "qwk", "train_accuracy"):
        assert rows(logs, metric)[0]["value"] == rows(jax_logs, metric)[0]["value"], metric
    # both ranks traced, each into its own event file
    for host in (0, 1):
        periods = [e for e in _events(logs, "dp-parity", host) if e["kind"] == "period"]
        assert [(e["host"], e["steps"]) for e in periods] == [(host, 5)]


@pytest.fixture(scope="module")
def recovery(tmp_path_factory):
    """(a) preempt@step:7 on rank 1 only, supervised; (b) the relaunch of
    the same job, rank 1 seeing (a)'s latest snapshot as torn; (c) the same
    run uninterrupted as another job.  3 epochs of 5 steps."""
    root = tmp_path_factory.mktemp("dp_recovery")
    args = [*MODEL, *DATA, "train.max_epochs=3", f"train.log_dir={root / 'logs'}",
            f"train.checkpoint_dir={root / 'ckpt'}"]
    runs = {"a": _world(root / "a", args, DDL_JOB_ID="dp-preempt", DDL_SUPERVISED="1",
                        TEST_FAULT_RANK1="preempt@step:7")}
    cursor = {e: ckpt.read_cursor(root / "ckpt", "dp-preempt", e)
              for e in ckpt.snapshot_epochs(root / "ckpt", "dp-preempt")}
    runs["b"] = _world(root / "b", args, DDL_JOB_ID="dp-preempt", TEST_TORN_RANK1="epoch_1")
    runs["c"] = _world(root / "c", args, DDL_JOB_ID="dp-whole")
    return root, runs, cursor


def test_preemption_on_one_rank_stops_both_after_the_same_step(recovery):
    """Rank 1 alone is preempted after global step 7 (epoch 1, batch 2):
    both ranks stop there, rank 0 commits the cursor {period 1, offset 3},
    and the spawner returns EXIT_PREEMPTED."""
    root, runs, cursor = recovery
    assert runs["a"] == EXIT_PREEMPTED, _rank_logs(root / "a")
    assert cursor[1] == {"period": 1, "offset": 3}
    for host in (0, 1):
        events = _events(root / "logs", "dp-preempt", host)
        kinds = [e["kind"] for e in events]
        assert "run_end" in kinds, (host, kinds, _rank_logs(root / "a"))
        first_run = events[:kinds.index("run_end") + 1]
        steps = [e["steps"] for e in first_run if e["kind"] == "period"]
        assert steps == [5, 3], (host, kinds, _rank_logs(root / "a"))


def _rank_logs(out: Path) -> str:
    """The tail of each rank's output, for a failure's message."""
    return "\n".join(f"--- rank {r}:\n" + (out / "ranks" / f"rank{r}.log").read_text()[-2000:]
                     for r in (0, 1))


def test_relaunch_resumes_from_rank_0s_choice_and_equals_the_whole_run(recovery):
    """Rank 1's view of epoch_1 is torn, so alone it would resume from
    epoch_0; both restore rank 0's epoch_1 at its cursor, finish the run,
    and end bit-equal to the uninterrupted run (gloo on the CPU is
    deterministic), rank for rank."""
    root, runs, _ = recovery
    assert runs["b"] == 0 and runs["c"] == 0
    for host in (0, 1):
        restores = [e for e in _events(root / "logs", "dp-preempt", host)
                    if e["kind"] == "snapshot_restore"]
        assert [(e["epoch"], e["period"], e["offset"]) for e in restores] == [(1, 1, 3)], host
    for r in (0, 1):
        got = torch.load(root / "b" / f"final-r{r}.pt", weights_only=True)
        want = torch.load(root / "c" / f"final-r{r}.pt", weights_only=True)
        for part in ("model", "optimizer"):
            assert torch.equal(torch.cat([t.flatten().double() for t in _tensors(got[part])]),
                               torch.cat([t.flatten().double() for t in _tensors(want[part])])),\
                (r, part)
    loss = {job: [r["value"] for r in read_metric_csv(
        root / "logs" / "by_job_id" / job / "loss.csv")] for job in ("dp-preempt", "dp-whole")}
    assert loss["dp-preempt"][-1] == loss["dp-whole"][-1]


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree, key=str) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [torch.tensor(float(tree))] if isinstance(tree, (int, float)) else []


def test_rollback_takes_rank_0s_snapshot_on_every_rank(tmp_path):
    """``nan_policy=recover`` with one non-finite epoch (``nan@step:6``,
    every rank) and ``nan_max_consecutive=1``: every rank rolls back to
    rank 0's latest valid snapshot though rank 1 sees it as torn, and the
    ranks end equal."""
    args = [*MODEL, *DATA, "train.max_epochs=3", "train.nan_policy=recover",
            "train.nan_max_consecutive=1", f"train.log_dir={tmp_path / 'logs'}",
            f"train.checkpoint_dir={tmp_path / 'ckpt'}"]
    code = _world(tmp_path / "run", args, DDL_JOB_ID="dp-rollback", DDL_FAULT="nan@step:6",
                  TEST_TORN_RANK1="epoch_0")
    assert code == 0, (tmp_path / "run" / "ranks" / "rank1.log").read_text()[-3000:]
    for host in (0, 1):
        rollbacks = [e for e in _events(tmp_path / "logs", "dp-rollback", host)
                     if e["kind"] == "rollback"]
        assert [(e["period"], e["resumed_at"]) for e in rollbacks] == [(1, 1)], host
    states = [torch.load(tmp_path / "run" / f"final-r{r}.pt", weights_only=True)
              for r in (0, 1)]
    for a, b in zip(_tensors(states[0]), _tensors(states[1])):
        assert torch.equal(a, b)
