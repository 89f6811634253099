"""Snapshots: save, verify, discover, resume and prune (port of
``ddl_tpu/checkpoint.py`` on ``torch.save``/``torch.load``).

The reference saves ``{model, optimizer, epoch}`` with
``torch.distributed.checkpoint`` (``AppState`` at ``single.py:68-89``;
save/load at ``single.py:121-134``) and resumes by ``(job_id, epoch)``:
loading epoch N resumes training at epoch N+1 (``single.py:124``).  This
module keeps the JAX package's layout and integrity layer:

* ``<checkpoint_dir>/<job_id>/epoch_<n>/state.pt`` holds
  ``{"state": ..., "epoch": n, "format": SNAPSHOT_FORMAT}``, where the
  state is any nesting of dicts, lists and tensors (the trainer's: the
  model's ``state_dict`` and the ``Optimizer.state_dict``);
* ``ddl_manifest.json`` beside it is the commit marker and integrity
  record: per-file size and CRC32, the ``epoch``, the ``format`` and the
  data ``cursor`` (``read_cursor``), written after the data;
* the state of a pipeline run is the JAX package's pipelined layout, one
  tree per stage: ``{"stages": [{"model", "optimizer"}, ...]}``
  (``require_layout`` tells the layouts apart);
* a ZeRO-1 run's optimizer state is written in the replicated layout (its
  moments gathered from every rank by ``Optimizer.state_dict``), and each
  rank takes its shard on load, so snapshots pass both ways between ZeRO
  and replicated runs and between data axes of any size, the elastic
  pod's scale-down included, as Orbax's global arrays do in the JAX
  package;
* a snapshot is written into a hidden sibling directory and renamed to
  ``epoch_<n>`` in one ``os.replace``, so a snapshot being written is
  invisible to ``snapshot_epochs`` (``gc_snapshots`` relies on that), and
  a renamed one without its manifest yet counts as valid ("legacy").

``load_params`` is the decode tools' params-only restore: the model's
``state_dict`` of a snapshot, read through a memory map so the optimizer
moments stay on disk, with the LM head-orientation rule for a snapshot
that has no ``format`` field.  The JAX package's Orbax-only pieces are
not here: the sharding helpers ``state_rule_shardings``/``shard_and_gather``
(ROADMAP item 11, with the regex partition tables), and the head migration of a whole train state
inside ``load_snapshot`` (the port has never written a format-less
snapshot).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
import warnings
import zlib
from pathlib import Path
from typing import Any, Sequence

import torch

from ddl_tpu_torch.utils import faultinject
from ddl_tpu_torch.utils.backoff import Backoff, retry_with_backoff

__all__ = [
    "MANIFEST_NAME",
    "SNAPSHOT_FORMAT",
    "STATE_FILE",
    "SnapshotCorruptError",
    "SnapshotManager",
    "gc_snapshots",
    "latest_epoch",
    "latest_valid_epoch",
    "load_params",
    "load_snapshot",
    "map_tensors",
    "read_cursor",
    "require_layout",
    "require_one_device_layout",
    "resolve_resume",
    "run_resume_load",
    "save_snapshot",
    "snapshot_epochs",
    "snapshot_path",
    "verify_snapshot",
    "write_manifest",
]


def snapshot_path(checkpoint_dir: str | os.PathLike, job_id: str, epoch: int) -> Path:
    return Path(checkpoint_dir).absolute() / job_id / f"epoch_{epoch}"


# Snapshot layout version (the JAX package's: 2 = vocab-major lm_head),
# written into every snapshot so a later layout change keys off it.
SNAPSHOT_FORMAT = 2

# The commit marker and integrity record, written into the snapshot
# directory after the data: a snapshot without one either predates the
# integrity layer ("legacy") or has not finished committing, and its
# per-file size+CRC32 records catch the truncated or bit-rotted files a
# flaky shared NAS produces after a successful commit.
MANIFEST_NAME = "ddl_manifest.json"

# The one data file of a snapshot.
STATE_FILE = "state.pt"

# Bounded retry for snapshot-save I/O errors: total attempts = _SAVE_RETRIES + 1.
_SAVE_RETRIES = 2


class SnapshotCorruptError(RuntimeError):
    """A snapshot failed its integrity check (truncated/corrupt/partial).
    Auto-resume reacts by falling back to the previous good snapshot."""


def _crc32(path: Path, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as fh:
        while True:
            block = fh.read(chunk)
            if not block:
                return crc
            crc = zlib.crc32(block, crc)


def _snapshot_files(path: Path):
    return sorted(p for p in path.rglob("*") if p.is_file() and p.name != MANIFEST_NAME)


def write_manifest(path: str | os.PathLike, **extra) -> Path:
    """Commit marker + checksum manifest, written atomically (temp file +
    ``os.replace``) so a torn manifest write cannot masquerade as a
    committed snapshot."""
    path = Path(path)
    files = {
        p.relative_to(path).as_posix(): {"size": p.stat().st_size, "crc32": _crc32(p)}
        for p in _snapshot_files(path)
    }
    manifest = path / MANIFEST_NAME
    tmp = manifest.with_suffix(".json.tmp")
    tmp.write_text(json.dumps({"files": files, **extra}, indent=0))
    os.replace(tmp, manifest)
    return manifest


def verify_snapshot(path: str | os.PathLike) -> tuple[bool, str]:
    """``(ok, reason)`` for a snapshot directory.

    Three validity states: *verified* (manifest present, every file's
    size and CRC32 match), *legacy* (no manifest — restorable but
    unverifiable, so it stays valid), and *corrupt* (manifest unreadable,
    files missing, or contents drifted — truncation, torn writes, bit
    rot)."""
    path = Path(path)
    if not path.is_dir():
        return False, "missing"
    manifest = path / MANIFEST_NAME
    if not manifest.exists():
        return True, "legacy (no integrity manifest)"
    try:
        recorded = json.loads(manifest.read_text())["files"]
    except (OSError, ValueError, KeyError) as e:
        return False, f"unreadable manifest ({e!r})"
    for rel, rec in recorded.items():
        f = path / rel
        if not f.is_file():
            return False, f"missing file {rel}"
        size = f.stat().st_size
        if size != rec["size"]:
            return False, (
                f"size mismatch in {rel} ({size} != {rec['size']} bytes — "
                "truncated write?)"
            )
        if _crc32(f) != rec["crc32"]:
            return False, f"checksum mismatch in {rel}"
    return True, f"verified ({len(recorded)} files)"


def _commit(path: Path, payload: dict) -> None:
    """Write ``payload`` into a hidden sibling of ``path`` and rename it to
    ``path`` (replacing an earlier snapshot of the same epoch)."""
    tag = f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
    tmp = path.parent / f".{path.name}.tmp-{tag}"
    tmp.mkdir(parents=True)
    try:
        torch.save(payload, tmp / STATE_FILE)
        if path.exists():
            # a directory cannot replace a non-empty one: move the old one
            # aside (hidden, so never a snapshot), then drop it
            old = path.parent / f".{path.name}.old-{tag}"
            os.replace(path, old)
            os.replace(tmp, path)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _save_with_retry(path: Path, payload: dict) -> None:
    def attempt() -> None:
        faultinject.io_check("save")
        _commit(path, payload)

    def note(e, i):
        print(f"snapshot save to {path} failed ({e}); retry {i + 1}/{_SAVE_RETRIES}")

    retry_with_backoff(
        attempt, retries=_SAVE_RETRIES, exceptions=(OSError,),
        backoff=Backoff(base=0.5, factor=2.0, max_delay=10.0),
        on_retry=note,
    )


def _finish(path: Path, epoch: int, cursor: dict | None) -> None:
    extra = {"cursor": cursor} if cursor is not None else {}
    write_manifest(path, epoch=epoch, format=SNAPSHOT_FORMAT, **extra)
    faultinject.corrupt_check(path)


def save_snapshot(
    checkpoint_dir: str | os.PathLike,
    job_id: str,
    epoch: int,
    state: Any,
    cursor: dict | None = None,
) -> Path:
    """Write and commit a snapshot synchronously.  ``cursor`` (optional) is
    the data-stream position this snapshot represents — ``{"period",
    "offset"}`` from the training loop — recorded in the manifest so an
    exact resume replays no batch and skips none (``read_cursor``)."""
    path = snapshot_path(checkpoint_dir, job_id, epoch)
    path.parent.mkdir(parents=True, exist_ok=True)
    _save_with_retry(path, {"state": state, "epoch": epoch, "format": SNAPSHOT_FORMAT})
    _finish(path, epoch, cursor)
    return path


def read_cursor(checkpoint_dir: str | os.PathLike, job_id: str, epoch: int) -> dict | None:
    """The data cursor recorded at commit time, or None (cursor-less,
    manifest-less legacy or unreadable manifests).  Read from the
    manifest, not the state file: the cursor describes the host-side data
    stream and must be readable without loading tensors."""
    manifest = snapshot_path(checkpoint_dir, job_id, epoch) / MANIFEST_NAME
    try:
        cursor = json.loads(manifest.read_text()).get("cursor")
    except (OSError, ValueError):
        return None
    return cursor if isinstance(cursor, dict) else None


def load_snapshot(
    checkpoint_dir: str | os.PathLike,
    job_id: str,
    epoch: int,
    map_location=None,
    verify: bool = True,
) -> tuple[Any, int]:
    """Restore a snapshot's state onto ``map_location``; returns ``(state,
    epochs_run)`` where training resumes at ``epochs_run = saved_epoch +
    1`` (reference ``single.py:124``).  Callers that just picked this epoch
    by ``latest_valid_epoch`` pass ``verify=False``: the CRC pass reads
    every byte, and doing it twice doubles the restore."""
    path = snapshot_path(checkpoint_dir, job_id, epoch)
    if verify:
        ok, reason = verify_snapshot(path)
        if not ok:
            raise SnapshotCorruptError(
                f"snapshot at {path} failed its integrity check: {reason}"
            )
    payload = torch.load(path / STATE_FILE, map_location=map_location, weights_only=True)
    _warn_if_newer(payload, path)
    return payload["state"], int(payload["epoch"]) + 1


def _warn_if_newer(payload: dict, path: Path) -> None:
    saved_format = int(payload.get("format", 0))
    if saved_format > SNAPSHOT_FORMAT:
        warnings.warn(
            f"snapshot at {path} has format {saved_format}, newer than "
            f"this code's {SNAPSHOT_FORMAT} — it was written by a newer "
            "version and may use a layout this loader does not know "
            "about; restored values may be misinterpreted",
            stacklevel=3,
        )


# The LM head's kernel in a model ``state_dict``: (vocab, d_model) since
# format 2; a format-less snapshot may hold it either way round.
HEAD_KERNEL = "lm_head.kernel"


def load_params(
    checkpoint_dir: str | os.PathLike,
    job_id: str,
    epoch: int,
    vocab_size: int | None = None,
) -> dict:
    """Restore ONLY the model's ``state_dict`` of a snapshot, on the CPU.

    No optimizer is built, so a decode or eval tool need not know the
    training run's optimizer, and the file is read through a memory map
    (``torch.load(mmap=True)``): the Adam moments, ~2x the parameters'
    bytes, are never paged in.  The ``format`` field gets the treatment of
    ``load_snapshot``: a newer writer's snapshot warns.  A format-less
    snapshot's ``lm_head.kernel`` may be either orientation, so with the
    caller's ``vocab_size`` a (d_model, vocab) kernel is transposed to
    (vocab, d_model); a square kernel cannot be told apart and loads as
    saved, with a warning; without ``vocab_size`` it loads as saved, with
    a warning."""
    path = snapshot_path(checkpoint_dir, job_id, epoch)
    if not path.is_dir():
        have = latest_epoch(checkpoint_dir, job_id)
        raise FileNotFoundError(
            f"no snapshot at {path}"
            + (f" (latest for job {job_id!r}: {have})" if have is not None
               else f" (job {job_id!r} has no snapshots)")
        )
    payload = torch.load(path / STATE_FILE, map_location="cpu", mmap=True, weights_only=True)
    _warn_if_newer(payload, path)
    params = dict(payload["state"]["model"])
    head = params.get(HEAD_KERNEL)
    if "format" in payload or head is None or head.ndim != 2:
        return params
    if head.shape[0] == head.shape[1]:
        warnings.warn(
            f"format-less snapshot with a SQUARE lm_head kernel {tuple(head.shape)}: "
            "orientation cannot be inferred; restoring as-is.  If this snapshot "
            "predates the vocab-major head layout, the restored kernel is transposed.",
            stacklevel=2,
        )
    elif vocab_size is None:
        warnings.warn(
            f"format-less snapshot: lm_head kernel {tuple(head.shape)} orientation "
            "unverified (pass vocab_size= to migrate a pre-vocab-major snapshot "
            "exactly); restoring as-saved",
            stacklevel=2,
        )
    elif head.shape[0] != vocab_size and head.shape[1] == vocab_size:
        params[HEAD_KERNEL] = head.t().contiguous()  # saved (d_model, vocab)
    return params


def require_one_device_layout(params: dict, tool: str) -> None:
    """Refuse an LM params dict in the JAX package's pipeline-parallel
    layout (stacked ``blocks``): the decode tools restore params only and
    do not restructure stages.  The port's LM trainer never writes one (LM
    pipelines are ROADMAP item 11)."""
    if any(k.startswith("blocks.") for k in params):
        raise SystemExit(
            f"this snapshot is in the LM pipeline-parallel layout, which {tool} does not "
            "restructure; the port's LM trainer never writes one (LM pipelines are "
            "ROADMAP item 11), so it comes from elsewhere -- re-save it in the "
            "one-device layout"
        )


def _layout_name(stages: int) -> str:
    if not stages:
        return "the one-device layout (strategies 'single' and 'dp')"
    return f"the pipelined layout of {stages} stages"


def require_layout(state: dict, stages: int, stage: int | None = None,
                   keys=None, split_blocks=None) -> None:
    """Refuse a DenseNet snapshot state whose layout is not the run's: the
    one-device layout (``stages=0``: ``{"model", "optimizer"}``) or the
    pipelined one of ``stages`` stages (``{"stages": [...]}``), where the
    JAX package's restore fails on the tree's structure; ``ValueError``
    names both layouts.  With ``stage`` and ``keys`` (that stage's model
    keys in this run), the saved stage must hold the same layers, or the
    error names the run's ``split_blocks``.  The data axis replicates each
    stage, so it may differ (a ``pp`` snapshot resumes under ``dp_pp``)."""
    saved = len(state["stages"]) if "stages" in state else 0
    if saved != stages:
        raise ValueError(f"the snapshot holds {_layout_name(saved)}; this run needs "
                         f"{_layout_name(stages)}")
    if stage is not None and set(state["stages"][stage]["model"]) != set(keys):
        raise ValueError(f"the snapshot holds {_layout_name(saved)} cut elsewhere: its stage "
                         f"{stage} holds other layers than this run's split_blocks="
                         f"{tuple(split_blocks)} give that stage")


def resolve_resume(
    checkpoint_dir: str | os.PathLike | None,
    job_id: str,
    explicit: int | None = None,
    auto: bool = True,
    unit: str = "epoch",
) -> int | None:
    """Which snapshot a run should resume from: an explicit epoch wins;
    otherwise (with ``auto``) the job id's latest *valid* snapshot, so a
    relaunch with the same job id continues with no extra arguments;
    otherwise None (fresh start).

    Under pod supervision (``DDL_COORD_*`` set, more than one live host)
    the leader host computes the epoch and publishes it through the
    shared-directory rendezvous (``coord.agreed_resume_epoch``): a torn
    shared-store view can leave hosts seeing different
    ``latest_valid_epoch``, and hosts restoring different snapshots into
    one world diverge silently.  ONE process per host calls this (local
    rank 0: ``train.loop.BaseTrainer._first_on_host``), and of those only
    the leader's publishes, once per restart epoch; inside a world rank
    0's answer reaches every rank (``parallel.mesh.Mesh.agree``)."""
    if explicit is not None:
        return explicit
    if not auto or not checkpoint_dir:
        return None
    from ddl_tpu_torch import coord

    last = coord.agreed_resume_epoch(
        job_id, lambda: latest_valid_epoch(checkpoint_dir, job_id))
    if last is not None:
        print(
            f"auto-resume: job {job_id!r} has a snapshot at {unit} {last} "
            f"(disable auto_resume to start fresh)"
        )
    return last


def run_resume_load(load_fn, auto: bool, desc: str, hint: str):
    """Run a resume load, converting AUTO-resume failures into actionable
    advice.  An explicitly requested resume (``auto=False``) propagates the
    raw error; an auto-discovered one most likely mismatches because the
    job id was reused with a different config, so say that and how to opt
    out."""
    try:
        return load_fn()
    except Exception as e:
        if not auto:
            raise
        raise RuntimeError(
            f"auto-resume from {desc} failed — the saved run's "
            f"model/optimizer/mesh config may not match this one; "
            f"{hint} or use a fresh job id to start fresh"
        ) from e


def map_tensors(tree, fn, key=()):
    """``tree`` with every tensor ``t`` at key path ``key`` replaced by
    ``fn(key, t)``; dicts, lists and tuples keep their types."""
    if isinstance(tree, torch.Tensor):
        return fn(key, tree)
    if isinstance(tree, dict):
        return type(tree)((k, map_tensors(v, fn, key + (k,))) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(v, fn, key + (i,)) for i, v in enumerate(tree))
    return tree


class SnapshotManager:
    """Background snapshot writer: training continues while the previous
    snapshot commits.

    PyTorch updates parameters and optimizer moments in place at the next
    ``optimizer.step()``, so ``save`` takes the host copy before it
    returns: every CUDA tensor is copied into a pinned host buffer with
    ``non_blocking`` copies on the current stream (queued before the next
    step's kernels, so they read the state as it is now), and an event is
    recorded after them; CPU tensors are cloned.  The writer thread waits
    on the event, then writes, renames and writes the manifest.  One save
    is outstanding at a time, so the pinned buffers are reused.

    ``history`` holds one record per save: ``epoch``, ``bytes`` (the state
    file), ``save_s`` (the caller's time in ``save``) and ``write_s`` (the
    writer thread's time, waiting for the copies included)."""

    def __init__(self, checkpoint_dir: str | os.PathLike, job_id: str) -> None:
        self.checkpoint_dir = checkpoint_dir
        self.job_id = job_id
        self._host: dict[tuple, torch.Tensor] = {}
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.history: list[dict] = []

    def _host_copy(self, state):
        streams = {}

        def copy(key, t):
            t = t.detach()
            if t.device.type != "cuda":
                return t.clone()
            buf = self._host.get(key)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = self._host[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            streams.setdefault(t.device, torch.cuda.current_stream(t.device))
            return buf

        host = map_tensors(state, copy)
        events = []
        for stream in streams.values():
            event = torch.cuda.Event()
            event.record(stream)
            events.append(event)
        return host, events

    def save(self, epoch: int, state: Any, cursor: dict | None = None) -> Path:
        t0 = time.perf_counter()
        self.wait()  # one outstanding save; raises a failed earlier write
        path = snapshot_path(self.checkpoint_dir, self.job_id, epoch)
        path.parent.mkdir(parents=True, exist_ok=True)
        host, events = self._host_copy(state)
        record = {"epoch": epoch}
        payload = {"state": host, "epoch": epoch, "format": SNAPSHOT_FORMAT}
        self._thread = threading.Thread(
            target=self._write, args=(path, payload, events, epoch, cursor, record),
            name="ddl-snapshot", daemon=True,
        )
        self._thread.start()
        record["save_s"] = time.perf_counter() - t0
        self.history.append(record)
        return path

    def _write(self, path, payload, events, epoch, cursor, record) -> None:
        t0 = time.perf_counter()
        try:
            for event in events:
                event.synchronize()
            _save_with_retry(path, payload)
            record["bytes"] = (path / STATE_FILE).stat().st_size
            _finish(path, epoch, cursor)
        except BaseException as e:  # re-raised on the caller's thread by wait()
            self._error = e
        record["write_s"] = time.perf_counter() - t0

    def wait(self) -> None:
        """Block until the outstanding save has committed; re-raise its
        failure here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    close = wait


def latest_epoch(checkpoint_dir: str | os.PathLike, job_id: str) -> int | None:
    """Highest epoch snapshot available for a job, or None."""
    epochs = snapshot_epochs(checkpoint_dir, job_id)
    return epochs[-1] if epochs else None


def snapshot_epochs(checkpoint_dir: str | os.PathLike, job_id: str) -> list[int]:
    """All snapshot epochs for a job, ascending (validity not checked)."""
    job_dir = Path(checkpoint_dir) / job_id
    if not job_dir.is_dir():
        return []
    return sorted(
        int(p.name.removeprefix("epoch_"))
        for p in job_dir.iterdir()
        if p.name.startswith("epoch_") and p.name.removeprefix("epoch_").isdigit()
    )


# Snapshots this process already CRC-verified (immutable after commit,
# so per-save GC re-verification of the keep window would re-read every
# byte of every kept snapshot for nothing).  Only positive results are
# cached: a corrupt snapshot gets deleted, and restore-time verification
# still reads the real bytes.
_gc_verified: set[tuple[str, str, int]] = set()


def gc_snapshots(
    checkpoint_dir: str | os.PathLike,
    job_id: str,
    keep: int,
    protect: Sequence[int] = (),
) -> list[tuple[Path, str]]:
    """Delete old snapshots, keeping the newest ``keep`` **valid** ones.

    Corrupt snapshots never count toward ``keep`` and are deleted (they
    can never be restored), along with valid ones older than the keep
    window.  ``protect`` epochs (the best-eval-metric snapshot) are never
    deleted and occupy no keep slot.

    A save in flight is safe: it is invisible until its rename, and once
    renamed without its manifest it counts as valid ("legacy") and is the
    newest — inside the keep window.

    Returns ``[(path, reason), ...]`` for what was removed."""
    if keep is None or keep <= 0:
        return []
    protected = set(protect)
    removed: list[tuple[Path, str]] = []
    valid_kept = 0
    for epoch in reversed(snapshot_epochs(checkpoint_dir, job_id)):
        if epoch in protected:
            continue
        path = snapshot_path(checkpoint_dir, job_id, epoch)
        if valid_kept < keep:
            cache_key = (str(Path(checkpoint_dir).absolute()), job_id, epoch)
            if cache_key in _gc_verified:
                valid_kept += 1
                continue
            ok, reason = verify_snapshot(path)
            if ok:
                _gc_verified.add(cache_key)
                valid_kept += 1
                continue
            reason = f"corrupt ({reason}); does not count toward keep={keep}"
        else:
            reason = f"older than the {keep} newest valid snapshots"
        try:
            shutil.rmtree(path)
        except OSError as e:
            print(f"snapshot GC could not remove {path}: {e}")
            continue
        removed.append((path, reason))
    return removed


def latest_valid_epoch(checkpoint_dir: str | os.PathLike, job_id: str) -> int | None:
    """Newest snapshot that passes integrity verification — the rollback
    and auto-resume target.  Corrupt or partial snapshots are skipped with
    a loud note; legacy manifest-less snapshots count as valid."""
    for epoch in reversed(snapshot_epochs(checkpoint_dir, job_id)):
        path = snapshot_path(checkpoint_dir, job_id, epoch)
        ok, reason = verify_snapshot(path)
        if ok:
            return epoch
        print(
            f"skipping snapshot at {path}: {reason} — "
            "falling back to the previous snapshot"
        )
    return None
