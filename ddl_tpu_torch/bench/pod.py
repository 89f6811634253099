"""The pod crash drill: a ``dp`` DenseNet121 world over several hosts under
pod supervision, run whole and with one host crashing, held bit for bit.

    python -m ddl_tpu_torch.bench.pod --devices 0,1:2,3 [--crash-step 4]
        [--backend nccl] [--out DIR] [--set KEY=VALUE ...]

Each host is one ``python -m ddl_tpu_torch.cli train --supervise --pod DIR
--hosts N --host-id I`` process (``--devices`` gives each host's
``CUDA_VISIBLE_DEVICES``, hosts separated by ``:``; an empty entry leaves
the host every card), running the ``dp`` preset with ``mesh.data`` the sum
of the hosts' devices and the fused configuration (bf16, fused blocks 1
and 4, the kernel normalize) for 2 epochs of 3 global steps of 15 images
a rank (the reference ``ddp.py``'s) and the eval of 100.  The pod runs twice, one after the other: whole, and
with ``DDL_FAULT=crash@step:K`` on the last host.  Read from the
rendezvous files and each rank's run report (``DDL_RUN_REPORT``) and event
stream:

* the epoch-1 record: a crash, counted once, every host in it; each
  epoch's world at a store of its own (``coordinator-e<E>``);
* the agreed resume epoch against the snapshots committed before the
  restart decision; each rank's epoch-1 incarnation ran exactly the steps
  from that snapshot's cursor to the end;
* the final parameters and BatchNorm statistics (a SHA-256 over them) and
  each epoch's loss, val_loss and qwk rows against the whole pod's;
* per host, ``restart_latency`` (the epoch record's decision stamp to the
  first step) split at ``run_start`` and at the end of the snapshot
  restore, and the step wall (between consecutive ``step`` spans' ends)
  before and after the restart;
* #1-#3's launches on every rank.

``crash_drill`` is the harness (``chip_smoke.py``'s phase 13 (a) runs it
on one card with two gloo ranks); the command prints one JSON line and
exits 1 when a check fails.  ``--set train.zero_sharding=true`` runs the
drill under ZeRO-1 (the snapshots keep the replicated layout, so the
resume is the same); each rank's report then also carries its optimizer
bytes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

__all__ = ["EPOCHS", "STEPS_PER_EPOCH", "crash_drill", "run_pod"]

ROOT = Path(__file__).resolve().parents[2]
EPOCHS, STEPS_PER_EPOCH, EVAL_SET, SEED = 2, 3, 100, 0
PER_RANK_BATCH = 15  # reference ddp.py:335
FUSED = ("model.compute_dtype=bfloat16", "model.dense_block_impl=fused",
         "model.pallas_normalize=true")


def pod_args(data: int, extra=()) -> list[str]:
    """The pod's command-line arguments after ``--host-id``: ``data``
    ranks of ``PER_RANK_BATCH`` images each."""
    batch = PER_RANK_BATCH * data
    return ["--preset", "dp", "--set", *FUSED, f"mesh.data={data}",
            f"train.max_epochs={EPOCHS}", f"data.synthetic_num_train={STEPS_PER_EPOCH * batch}",
            f"data.synthetic_num_test={EVAL_SET}", f"data.global_batch_size={batch}",
            f"data.eval_batch_size={batch}", f"train.seed={SEED}", *extra]


def run_pod(root: Path, job: str, args: list[str], devices: list[str | None],
            fault: str | None = None, backend: str | None = None,
            timeout_s: float = 600.0) -> dict:
    """One pod: a supervisor a host (``devices[h]`` its
    ``CUDA_VISIBLE_DEVICES``, None for every card), ``fault`` on the last
    host; everything under ``root``.  Returns the hosts' exit codes."""
    root.mkdir(parents=True, exist_ok=True)
    n = len(devices)
    procs = {}
    for h, visible in enumerate(devices):
        env = {k: v for k, v in os.environ.items() if not k.startswith("DDL_")}
        env.update(DDL_LOG_DIR=str(root / "logs"), DDL_CHECKPOINT_DIR=str(root / "ckpt"),
                   DDL_JOB_ID=job, DDL_RUN_REPORT=str(root / "reports"),
                   OMP_NUM_THREADS=env.get("OMP_NUM_THREADS", "4"))
        if backend:
            env["DDL_DIST_BACKEND"] = backend
        if visible is not None:
            env["CUDA_VISIBLE_DEVICES"] = visible
        if fault and h == n - 1:
            env["DDL_FAULT"] = fault
        procs[h] = subprocess.Popen(
            [sys.executable, "-m", "ddl_tpu_torch.cli", "train", "--supervise", "--pod",
             str(root / "nas"), "--hosts", str(n), "--host-id", str(h), *args],
            cwd=ROOT, env=env, stdout=open(root / f"h{h}.log", "w"), stderr=subprocess.STDOUT)
    codes = {}
    try:
        for h, p in procs.items():
            codes[h] = p.wait(timeout=timeout_s)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return codes


def _reports(root: Path) -> dict:
    return {p.stem.removeprefix("report-"): json.loads(p.read_text())
            for p in (root / "reports").glob("report-*.json")}


def _events(root: Path, job: str, rank: int) -> list[dict]:
    from ddl_tpu_torch.obs import events_path, read_events

    return read_events(events_path(root / "logs", job, host=rank))


def _steps(events: list[dict]) -> dict:
    """Each restart epoch's (global step, end stamp) of the rank's steps."""
    out: dict = {}
    for e in events:
        if e.get("kind") == "span" and e.get("name") == "step":
            out.setdefault(e.get("repoch", 0), []).append((e["step"], e["ts"]))
    return out


def _step_ms(marks: list) -> float | None:
    """The mean wall between consecutive steps' ends, within one epoch
    (the eval and the snapshot between epochs left out)."""
    gaps = [(b[1] - a[1]) * 1e3 for a, b in zip(marks, marks[1:])
            if a[0] // STEPS_PER_EPOCH == b[0] // STEPS_PER_EPOCH]
    return sum(gaps) / len(gaps) if gaps else None


def _rows(root: Path, job: str) -> dict:
    out = {}
    for metric in ("loss", "val_loss", "qwk"):
        path = root / "logs" / "by_job_id" / job / f"{metric}.csv"
        out[metric] = [tuple(r.split(",")[-2:]) for r in path.read_text().splitlines()]
    return out


def crash_drill(root: Path, devices: list[str | None], crash_step: int = 4,
                backend: str | None = None, extra=(), together: bool = False,
                log=print) -> dict:
    """The drill (module docstring) under ``root``; returns the summary:
    ``checks`` (each ``[what, ok]``), ``bit_equal``, ``restart`` (per host),
    ``launches`` (per run and rank tag) and the two runs' seconds.  With
    ``together`` the whole pod runs beside the crashed one instead of
    before it (quicker; the crashed pod's restart then shares the host and
    the cards with it)."""
    import threading
    import time

    from ddl_tpu_torch import checkpoint as ckpt
    from ddl_tpu_torch import coord

    hosts = len(devices)
    local = [len(v.split(",")) if v else None for v in devices]
    if None in local:
        import torch

        local = [torch.cuda.device_count() if n is None else n for n in local]
    world = sum(local)
    args = pod_args(world, extra)
    checks, out = [], {"world": world, "hosts": hosts}

    def check(what, ok):
        checks.append([what, bool(ok)])
        if not ok:
            log(f"  FAILED: {what}")

    codes, seconds = {}, {}

    def pod(run, fault=None):
        t0 = time.perf_counter()
        codes[run] = run_pod(root / run, f"pod-{run}", args, devices, fault, backend)
        seconds[run] = time.perf_counter() - t0

    runs = [threading.Thread(target=pod, args=("whole",)),
            threading.Thread(target=pod, args=("crashed", f"crash@step:{crash_step}"))]
    for t in runs:
        t.start()
        if not together:
            t.join()
    for t in runs:
        t.join()
    whole, crashed = codes["whole"], codes["crashed"]
    out["seconds"], out["together"] = seconds, together
    check(f"both pods' hosts exit 0 (whole {whole}, crashed {crashed})",
          set(whole.values()) == {0} and set(crashed.values()) == {0})
    if not all(c == 0 for c in (*whole.values(), *crashed.values())):
        for run in ("whole", "crashed"):
            for h in range(hosts):
                log(f"--- {run} host {h}:\n" + (root / run / f"h{h}.log").read_text()[-4000:])
        out["checks"] = checks
        return out

    launch_dir = coord.active_launch_root(root / "crashed" / "nas")
    rv = coord.Rendezvous(launch_dir, 0, hosts)
    rec = rv.epoch_record(1)
    out["record"] = rec
    check("one restart epoch, no abort", rv.current_epoch() == 1 and rv.aborted() is None)
    check("the epoch-1 record: a crash, counted once, every host in it",
          rec["reason"].endswith("crash") and rec["crashes"] == 1
          and rec["hosts"] == list(range(hosts)))
    check("the whole pod restarted never", coord.Rendezvous(
        coord.active_launch_root(root / "whole" / "nas"), 0, hosts).current_epoch() == 0)
    coords = [json.loads((launch_dir / "agree" / f"coordinator-e{e}.json").read_text())["value"]
              for e in (0, 1)]
    out["coordinators"] = coords
    check("epoch 1's world joined a fresh store", coords[0]["coordinator"]
          != coords[1]["coordinator"])
    reports, ref_reports = _reports(root / "crashed"), _reports(root / "whole")
    ranks = range(world)
    check("every host relaunched in epoch 1", all(f"e1-r{r}" in reports for r in ranks))

    agreed = json.loads((launch_dir / "agree" / "resume-pod-crashed-e1.json").read_text())["value"]
    store = root / "crashed" / "ckpt" / "pod-crashed"
    committed = sorted(int(d.name.split("_")[1]) for d in store.glob("epoch_*")
                       if (d / "ddl_manifest.json").is_file()
                       and (d / "ddl_manifest.json").stat().st_mtime < rec["ts"])
    out["agreed_resume"], out["committed_before"] = agreed, committed
    check("the agreed resume epoch is the last committed snapshot",
          agreed == (committed[-1] if committed else None))
    start = 0
    if agreed is not None:
        cursor = ckpt.read_cursor(root / "crashed" / "ckpt", "pod-crashed", agreed)
        start = cursor["period"] * STEPS_PER_EPOCH + cursor["offset"]
    end = EPOCHS * STEPS_PER_EPOCH
    out["steps_run"] = {}
    for rank in ranks:
        ran = _steps(_events(root / "crashed", "pod-crashed", rank))
        ref = _steps(_events(root / "whole", "pod-whole", rank))
        out["steps_run"][rank] = {e: [s for s, _ in v] for e, v in ran.items()}
        check(f"rank {rank}'s epoch-1 incarnation ran exactly steps {start}..{end - 1}",
              [s for s, _ in ran.get(1, [])] == list(range(start, end)))
        check(f"rank {rank}'s epoch-0 incarnation ran steps 0..{crash_step}",
              [s for s, _ in ran.get(0, [])] == list(range(crash_step + 1)))
        check(f"rank {rank} of the whole pod ran steps 0..{end - 1}",
              {e: [s for s, _ in v] for e, v in ref.items()} == {0: list(range(end))})

    out["restart"] = {}
    for h in range(hosts):
        rank = sum(local[:h])  # the host's local rank 0
        events = _events(root / "crashed", "pod-crashed", rank)
        evs = [e for e in events if e.get("repoch") == 1]
        first = {k: next((e for e in evs if e["kind"] == k), None)
                 for k in ("run_start", "snapshot_restore", "restart_latency")}
        lat = first["restart_latency"]
        check(f"host {h} stamped restart_latency against the epoch record",
              lat is not None and lat["decision_ts"] == rec["ts"])
        marks = _steps(events)
        out["restart"][h] = {
            "restart_latency_s": lat and lat["latency"],
            "to_run_start_s": first["run_start"] and first["run_start"]["ts"] - rec["ts"],
            "to_restored_s": (first["snapshot_restore"]
                              and first["snapshot_restore"]["ts"] - rec["ts"]),
            "restore_s": first["snapshot_restore"] and first["snapshot_restore"]["dur"],
            "step_ms_before": _step_ms(marks.get(0, [])),
            "step_ms_after": _step_ms(marks.get(1, [])),
        }

    from ddl_tpu_torch.config import ModelConfig

    per_layer = sum(ModelConfig().block_config[b] for b in (0, 3))
    out["launches"] = {run: {tag: rep["launches"] for tag, rep in sorted(reps.items())}
                       for run, reps in (("whole", ref_reports), ("crashed", reports))}
    for run, reps in (("whole", ref_reports), ("crashed", reports)):
        for tag, rep in reps.items():
            if rep["completed"]:
                check(f"{run} {tag} went through #1-#3",
                      all(n > 0 for n in rep["launches"].values()))
    for r in ranks:
        check(f"rank {r}'s epoch-1 backward kernel launched once a fused layer a step",
              reports[f"e1-r{r}"]["launches"]["fused_dense_block_bwd"]
              == per_layer * (end - start))
    rows, ref_rows = _rows(root / "crashed", "pod-crashed"), _rows(root / "whole", "pod-whole")
    out["rows"], out["rows_whole"] = rows, ref_rows
    want = ref_reports["e0-r0"]["state_sha256"]
    digests = {reports[f"e1-r{r}"]["state_sha256"] for r in ranks}
    digests |= {ref_reports[f"e0-r{r}"]["state_sha256"] for r in ranks}
    out["bit_equal"] = digests == {want} and rows == ref_rows
    out["checks"] = checks
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="the pod crash drill")
    ap.add_argument("--devices", default="0,1:2,3",
                    help="each host's CUDA_VISIBLE_DEVICES, hosts separated by ':'")
    ap.add_argument("--crash-step", type=int, default=4)
    ap.add_argument("--backend", default=None, help="DDL_DIST_BACKEND (default: NCCL on CUDA)")
    ap.add_argument("--out", default=str(ROOT / "build" / "bench_pod"))
    ap.add_argument("--set", nargs="*", default=[], help="more KEY=VALUE config overrides")
    args = ap.parse_args(argv)
    import shutil

    shutil.rmtree(args.out, ignore_errors=True)
    devices = [d or None for d in args.devices.split(":")]
    out = crash_drill(Path(args.out), devices, args.crash_step, args.backend, args.set)
    print(json.dumps(out, default=str))
    if not all(ok for _, ok in out["checks"]) or not out.get("bit_equal"):
        raise SystemExit(1)
    return out


if __name__ == "__main__":
    main()
