"""The port's snapshots (ddl_tpu_torch/checkpoint.py) against the JAX
package's: the same validity, discovery, GC and resume decisions on the
same damaged directory trees (torn, legacy, truncated, bit-flipped,
missing-file, a ``corrupt_ckpt@save`` fault, and trees the JAX package
wrote itself); the commit order of the background writer and its host
copy; retries of injected save errors; and a bit-exact round trip of the
trainer's state on the CPU."""

import json
import shutil
import threading

import numpy as np
import pytest
import torch

from ddl_tpu import checkpoint as jax_ckpt
from ddl_tpu.utils import faultinject as jax_faultinject
from ddl_tpu_torch import checkpoint as ckpt
from ddl_tpu_torch.config import preset
from ddl_tpu_torch.train import Trainer
from ddl_tpu_torch.utils import faultinject

JOB = "job"
EPOCHS = 4


@pytest.fixture(autouse=True)
def _clean_injectors():
    faultinject.deactivate()
    jax_faultinject.deactivate()
    yield
    faultinject.deactivate()
    jax_faultinject.deactivate()


def _state(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"model": {"w": torch.randn(64, generator=g), "n": torch.tensor(seed)},
            "optimizer": {"inner": {"state": {0: {"step": torch.tensor(3.0)}}}, "count": 3}}


def _flip_byte(path):
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0x40
    path.write_bytes(bytes(data))


def _damage(root, scenario: str) -> None:
    """Write ``EPOCHS`` snapshots under ``root`` with the port and damage
    them as ``scenario`` says."""
    if scenario == "corrupt_ckpt_fault":
        faultinject.activate("corrupt_ckpt@save:2")  # the 2nd commit is truncated
    if scenario == "jax_written":
        jax_faultinject.activate("corrupt_ckpt@save:3")
        for e in range(EPOCHS):
            jax_ckpt.save_snapshot(root, JOB, e, {"w": np.arange(16.0) + e},
                                   cursor={"period": e + 1, "offset": 0})
        return
    for e in range(EPOCHS):
        ckpt.save_snapshot(root, JOB, e, _state(e), cursor={"period": e + 1, "offset": 0})
    faultinject.deactivate()
    path = lambda e: ckpt.snapshot_path(root, JOB, e)  # noqa: E731
    if scenario == "torn":
        # the newest manifest cut mid-write, and a save still in flight
        manifest = path(3) / ckpt.MANIFEST_NAME
        manifest.write_text(manifest.read_text()[:20])
        (root / JOB / ".epoch_4.tmp-1-abc").mkdir()
    elif scenario == "missing_manifest":
        (path(3) / ckpt.MANIFEST_NAME).unlink()  # legacy: still valid
        (path(1) / ckpt.MANIFEST_NAME).unlink()
    elif scenario == "truncated":
        faultinject.corrupt_snapshot(path(3))
    elif scenario == "bitflip":
        _flip_byte(path(3) / ckpt.STATE_FILE)
        _flip_byte(path(2) / ckpt.STATE_FILE)
    elif scenario == "missing_file":
        (path(3) / ckpt.STATE_FILE).unlink()


def _decisions(pkg, root, keep: int, protect: tuple) -> dict:
    """Every decision the package makes on the tree at ``root``; GC runs
    last (it deletes)."""
    pkg._gc_verified.clear()
    out = {
        "epochs": pkg.snapshot_epochs(root, JOB),
        "latest": pkg.latest_epoch(root, JOB),
        "verify": [pkg.verify_snapshot(pkg.snapshot_path(root, JOB, e))[0]
                   for e in range(EPOCHS + 1)],
        "latest_valid": pkg.latest_valid_epoch(root, JOB),
        "resume_auto": pkg.resolve_resume(root, JOB),
        "resume_explicit": pkg.resolve_resume(root, JOB, explicit=1),
        "resume_off": pkg.resolve_resume(root, JOB, auto=False),
        "cursors": [pkg.read_cursor(root, JOB, e) for e in range(EPOCHS)],
    }
    removed = pkg.gc_snapshots(root, JOB, keep=keep, protect=protect)
    out["gc_removed"] = sorted(p.name for p, _ in removed)
    out["gc_corrupt"] = sorted(p.name for p, r in removed if "corrupt" in r)
    out["after_gc"] = pkg.snapshot_epochs(root, JOB)
    return out


@pytest.mark.parametrize("scenario", ["clean", "torn", "missing_manifest", "truncated",
                                      "bitflip", "missing_file", "corrupt_ckpt_fault",
                                      "jax_written"])
@pytest.mark.parametrize("keep, protect", [(1, ()), (2, (0,))], ids=["keep1", "keep2-protect0"])
def test_decisions_match_jax_on_the_same_tree(tmp_path, scenario, keep, protect):
    _damage(tmp_path / "src", scenario)
    shutil.copytree(tmp_path / "src", tmp_path / "port")
    shutil.copytree(tmp_path / "src", tmp_path / "jax")
    got = _decisions(ckpt, tmp_path / "port", keep, protect)
    want = _decisions(jax_ckpt, tmp_path / "jax", keep, protect)
    assert got == want
    if scenario in ("torn", "truncated", "missing_file"):
        assert got["latest_valid"] == 2 and "epoch_3" in got["gc_corrupt"]
    if scenario == "corrupt_ckpt_fault":
        assert got["verify"][:EPOCHS] == [True, False, True, True]


def test_snapshot_layout_and_manifest(tmp_path):
    """One data file and the JAX manifest: per-file size and CRC32, the
    epoch, the format and the cursor; the JAX package reads the cursor and
    verifies the snapshot."""
    path = ckpt.save_snapshot(tmp_path, JOB, 7, _state(0), cursor={"period": 7, "offset": 2})
    assert path == ckpt.snapshot_path(tmp_path, JOB, 7) and path.name == "epoch_7"
    assert sorted(p.name for p in path.iterdir()) == [ckpt.MANIFEST_NAME, ckpt.STATE_FILE]
    manifest = json.loads((path / ckpt.MANIFEST_NAME).read_text())
    assert manifest["epoch"] == 7 and manifest["format"] == ckpt.SNAPSHOT_FORMAT == 2
    assert manifest["cursor"] == {"period": 7, "offset": 2}
    assert manifest["files"][ckpt.STATE_FILE]["size"] == (path / ckpt.STATE_FILE).stat().st_size
    assert jax_ckpt.read_cursor(tmp_path, JOB, 7) == ckpt.read_cursor(tmp_path, JOB, 7)
    assert jax_ckpt.verify_snapshot(path) == ckpt.verify_snapshot(path)
    state, epochs_run = ckpt.load_snapshot(tmp_path, JOB, 7)
    assert epochs_run == 8
    torch.testing.assert_close(state["model"]["w"], _state(0)["model"]["w"], rtol=0, atol=0)
    # a corrupt snapshot refuses to load unless the caller already verified it
    faultinject.corrupt_snapshot(path)
    with pytest.raises(ckpt.SnapshotCorruptError, match="integrity"):
        ckpt.load_snapshot(tmp_path, JOB, 7)


def test_a_second_save_of_an_epoch_replaces_it(tmp_path):
    """The preemption save of an epoch the QWK gate already saved: the
    later one wins, and nothing hidden is left beside it."""
    ckpt.save_snapshot(tmp_path, JOB, 1, _state(1), cursor={"period": 2, "offset": 0})
    ckpt.save_snapshot(tmp_path, JOB, 1, _state(2), cursor={"period": 1, "offset": 3})
    assert ckpt.read_cursor(tmp_path, JOB, 1) == {"period": 1, "offset": 3}
    state, _ = ckpt.load_snapshot(tmp_path, JOB, 1)
    assert int(state["model"]["n"]) == 2
    assert [p.name for p in (tmp_path / JOB).iterdir()] == ["epoch_1"]


def test_save_retries_injected_io_errors(tmp_path):
    faultinject.activate("io@save:1:2")  # the first two attempts fail
    path = ckpt.save_snapshot(tmp_path, JOB, 0, _state(0))
    assert ckpt.verify_snapshot(path)[0]
    assert not list((tmp_path / JOB).glob(".*"))  # the failed attempts left nothing

    faultinject.activate("io@save:1:99")  # beyond the retry budget
    with pytest.raises(OSError, match="injected"):
        ckpt.save_snapshot(tmp_path, JOB, 1, _state(0))
    assert ckpt.snapshot_epochs(tmp_path, JOB) == [0]

    faultinject.activate("io@save:1:99")  # the background writer re-raises in wait()
    mgr = ckpt.SnapshotManager(tmp_path, JOB)
    mgr.save(2, _state(0))
    with pytest.raises(OSError, match="injected"):
        mgr.wait()


def test_manager_copies_first_and_writes_the_manifest_last(tmp_path, monkeypatch):
    """``save`` returns with its own copy of the state: an in-place update
    after it (the next optimizer step) does not reach the file.  Until the
    write is renamed, the snapshot is invisible; the manifest comes after
    the rename, and GC in between keeps the renamed one as the newest."""
    release, renamed = threading.Event(), threading.Event()
    commit = ckpt._commit

    def slow_commit(path, payload):
        assert release.wait(10)
        commit(path, payload)
        renamed.set()

    monkeypatch.setattr(ckpt, "_commit", slow_commit)
    state = _state(5)
    want = state["model"]["w"].clone()
    mgr = ckpt.SnapshotManager(tmp_path, JOB)
    path = mgr.save(3, state, cursor={"period": 4, "offset": 0})
    state["model"]["w"].add_(1.0)  # the next step, in place
    assert ckpt.snapshot_epochs(tmp_path, JOB) == []  # not yet renamed: invisible
    release.set()
    assert renamed.wait(10)
    mgr.wait()
    manifest = json.loads((path / ckpt.MANIFEST_NAME).read_text())
    assert manifest["cursor"] == {"period": 4, "offset": 0} and manifest["epoch"] == 3
    assert ckpt.verify_snapshot(path) == (True, "verified (1 files)")
    loaded, _ = ckpt.load_snapshot(tmp_path, JOB, 3)
    torch.testing.assert_close(loaded["model"]["w"], want, rtol=0, atol=0)
    record = mgr.history[-1]
    assert record["epoch"] == 3 and record["bytes"] == (path / ckpt.STATE_FILE).stat().st_size
    assert record["save_s"] >= 0 and record["write_s"] > 0


def test_manager_commit_is_visible_as_legacy_before_its_manifest(tmp_path, monkeypatch):
    """Between the rename and the manifest the snapshot counts as valid
    ("legacy") in both packages, so GC keeps it."""
    gate = threading.Event()
    finish = ckpt._finish

    def late_finish(path, epoch, cursor):
        assert gate.wait(10)
        finish(path, epoch, cursor)

    monkeypatch.setattr(ckpt, "_finish", late_finish)
    mgr = ckpt.SnapshotManager(tmp_path, JOB)
    path = mgr.save(0, _state(0))
    for _ in range(1000):
        if path.exists():
            break
        threading.Event().wait(0.01)
    assert ckpt.verify_snapshot(path) == jax_ckpt.verify_snapshot(path)
    assert ckpt.verify_snapshot(path)[1].startswith("legacy")
    assert ckpt.gc_snapshots(tmp_path, JOB, keep=1) == []
    gate.set()
    mgr.wait()
    assert ckpt.verify_snapshot(path)[1].startswith("verified")


def _tiny_cfg(tmp_path, **extra):
    return preset("single", **{
        "data.image_size": 32, "data.global_batch_size": 8, "data.eval_batch_size": 8,
        "data.synthetic_num_train": 16, "data.synthetic_num_test": 8, "data.num_workers": 0,
        "model.growth_rate": 4, "model.block_config": (2, 2), "model.num_init_features": 8,
        "model.bn_size": 2, "train.max_epochs": 1, "train.save_best_qwk": False,
        "train.log_dir": str(tmp_path / "logs"), "train.checkpoint_dir": str(tmp_path / "ckpt"),
        **extra})


def _flat(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")


@pytest.mark.parametrize("async_checkpoint", [True, False], ids=["async", "sync"])
def test_trainer_state_round_trip_is_bit_exact(tmp_path, monkeypatch, async_checkpoint):
    """Train two steps, snapshot, load into a fresh Trainer: every parameter,
    running statistic, Adam moment, ``step`` and the schedule's ``count``
    bit-equal, and Adam's ``step`` back on the host."""
    monkeypatch.setenv("DDL_JOB_ID", "round-trip")
    cfg = _tiny_cfg(tmp_path, **{"train.async_checkpoint": async_checkpoint})
    t = Trainer(cfg, device="cpu")
    t.train()
    t.data_cursor = {"period": 1, "offset": 0}
    t.save_snapshot(0)
    t.wait_for_saves()
    want = dict(_flat(t.snapshot_state()))
    fresh = Trainer(cfg, device="cpu")  # auto-resumes from epoch 0
    assert fresh.epochs_run == 1 and fresh._resume_offset == 0
    got = dict(_flat(fresh.snapshot_state()))
    assert got.keys() == want.keys() and len(got) > 100
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert fresh.optimizer.count == t.optimizer.count == 2
    assert all(s["step"].device.type == "cpu" for s in fresh.optimizer.inner.state.values())
    # the live parameters are the optimizer's: an update moves the model
    before = fresh.model.features.conv0.weight.clone()
    fresh.train(2)
    assert not torch.equal(before, fresh.model.features.conv0.weight)
