"""Pipelined DenseNet121 on the card: parity with the same microbatched math
in one process, and train-step throughput of ``pp`` and ``dp_pp``.

    python -m ddl_tpu_torch.bench.pp [--parity]

Each world of ``WORLDS`` is started by ``bench.dp.run_world``, one rank a
GPU over NCCL: ``pp`` is two ranks (stages 0 and 1, split at
denseblock3), ``dp_pp`` a (2, 2) mesh of four.  A rank builds the
preset's Trainer with ``bench.dp``'s fused configuration (bf16, the fused
blocks 1 and 4; the pipeline normalizes with the plain divide, as the JAX
package's does) at the reference batch, 30 a data row in 5 microbatches
of 6 (``pp.py:365,378``), and times its train step on device-resident
batches (``bench.dp.timed_trainer``: ``WARMUP`` steps, then ``STEPS``).
Reported per world: ms a step (the slowest rank's), steps/s and images/s,
the handoff's transport and its bytes a step, and each rank's card over
3 more profiled steps: the shares of the wall in compute kernels and in
NCCL's kernels (the rest idle: the bubble and the host).

``--parity`` first runs ``parity_run`` in this process for one and two
data rows, then in each world for both schedules: DenseNet121 in f32 with
the packed blocks, ``PARITY_STEPS`` SGD steps of 30 images a data row in 5
microbatches and an eval pass over ``PARITY_EVAL``; each data row's stages
joined (``merge_rows``, which requires every row to equal the first bit
for bit), the losses, parameters, BatchNorm running statistics and eval
logits compared (``bench.dp.parity_errors``), and 1F1B against GPipe;
beside them, the one-process math with its data rows in the other order
against itself (the f32 floor of the data axis's averages).  The summary
is one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["WORLDS", "merge_rows", "merge_stages", "parity_run", "run_gap", "throughput"]

SEED = 0
PER_ROW_BATCH, MICROBATCHES = 30, 5  # reference pp.py:365,378
PARITY_STEPS, PARITY_LR, PARITY_EVAL = 2, 0.01, 60
STEPS = 10  # timed steps a world, after bench.dp.WARMUP
# preset -> (data, pipe)
WORLDS = {"pp": (1, 2), "dp_pp": (2, 2)}


def _batches(data: int):
    """The synthetic set's global batches: ``PARITY_STEPS`` of
    ``PER_ROW_BATCH * data`` images for training and ``PARITY_EVAL`` for the
    eval (as numpy uint8 and int32)."""
    from ddl_tpu_torch.data import SyntheticAptosDataset

    n = PER_ROW_BATCH * data * PARITY_STEPS
    train = SyntheticAptosDataset(n, 224, 5, seed=1)
    test = SyntheticAptosDataset(PARITY_EVAL, 224, 5, seed=2)
    images = np.stack([train[i][0] for i in range(n)])
    labels = np.asarray([train[i][1] for i in range(n)], np.int32)
    return (images.reshape(PARITY_STEPS, -1, *images.shape[1:]),
            labels.reshape(PARITY_STEPS, -1), np.stack([test[i][0] for i in range(PARITY_EVAL)]))


def parity_run(mesh=None, schedule: str = "gpipe", data: int = 1,
               reverse: bool = False) -> dict:
    """DenseNet121 in f32 with the packed blocks from ``init_weights(SEED)``:
    ``PARITY_STEPS`` SGD steps at ``PARITY_LR`` on global batches of
    ``PER_ROW_BATCH`` images a data row, then the eval of ``PARITY_EVAL``.

    Under a ``mesh`` with a pipe axis: the pipeline (this rank's stage,
    ``schedule``).  Without one: the same math in this process, the whole
    network on CUDA: each of ``data`` rows' microbatches in order, each
    normalized by its own statistics, the running statistics moving once
    per microbatch from where the step found them and then averaged over
    the rows, and the gradient of the rows' mean of their losses' sum over
    M; with ``reverse``, the rows in the opposite order (the same math
    summed in another order: the f32 floor of the data axis's averages).
    Returns the global step losses, this process's parameters and running
    statistics (a stage's under a mesh; ``merge_stages`` joins them), and
    the eval logits in the global order.

    cuDNN runs its deterministic algorithms here, so two runs of the same
    math give the same bits where cuDNN decides: its default backward
    sums with atomics, and two identical runs of the one-process math then
    differ by 3.1e-6 of the largest parameter after the 2 steps (on an
    H100 80GB HBM3 at 700 W), more than the schedules' 1e-6 limit."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _parity_run(mesh, schedule, data, reverse)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _parity_run(mesh, schedule: str, data: int, reverse: bool) -> dict:
    from ddl_tpu_torch.config import ModelConfig
    from ddl_tpu_torch.data import to_device
    from ddl_tpu_torch.models import DenseNet, init_weights
    from ddl_tpu_torch.models.densenet import stage_boundary_shapes
    from ddl_tpu_torch.ops import cross_entropy_loss, normalize_images
    from ddl_tpu_torch.parallel.pipeline import make_pipeline_step_fns

    cfg = ModelConfig(compute_dtype="float32")
    model = DenseNet(cfg, num_stages=1)
    init_weights(model, SEED)
    data = data if mesh is None else mesh.spec.data
    images, labels, test = _batches(data)
    b, m = PER_ROW_BATCH, MICROBATCHES
    losses, logits = [], []
    if mesh is not None:
        stage = DenseNet(cfg, stage=mesh.pipe_index)
        whole = model.state_dict()
        stage.load_state_dict({k: whole[k] for k in stage.state_dict()})
        model = stage.to(mesh.device)
        fns = make_pipeline_step_fns(model, torch.optim.SGD(model.parameters(), lr=PARITY_LR),
                                     mesh, torch.float32, m, stage_boundary_shapes(cfg, 224),
                                     cfg.num_classes, remat=cfg.remat, schedule=schedule)
        rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
        for t in range(PARITY_STEPS):
            gi, gl = to_device(images[t][rows], labels[t][rows], mesh.device)
            losses.append(fns.train(gi, gl)[0].item())
        eval_rows = slice(mesh.data_index * PARITY_EVAL // data,
                          (mesh.data_index + 1) * PARITY_EVAL // data)
        part = fns.evaluate(torch.from_numpy(test[eval_rows]).to(mesh.device))
        logits = mesh.gather(part.cpu().numpy())
    else:
        model = model.to("cuda").train()
        opt = torch.optim.SGD(model.parameters(), lr=PARITY_LR)
        stats = [v for k, v in model.named_buffers() if k.endswith(("_mean", "_var"))]
        mb = b // m
        for t in range(PARITY_STEPS):
            gi, gl = to_device(images[t], labels[t], "cuda")
            opt.zero_grad()
            start = [s.clone() for s in stats]
            ends, total = [], 0.0
            for d in (reversed(range(data)) if reverse else range(data)):
                with torch.no_grad():
                    for s, s0 in zip(stats, start):
                        s.copy_(s0)
                for i in range(m):
                    lo = d * b + i * mb
                    loss = cross_entropy_loss(
                        model(normalize_images(gi[lo:lo + mb], torch.float32)), gl[lo:lo + mb])
                    (loss / (m * data)).backward()
                    total += loss.item() / (m * data)
                ends.append([s.clone() for s in stats])
            with torch.no_grad():
                for j, s in enumerate(stats):
                    s.copy_(torch.stack([e[j] for e in ends]).mean(0))
            opt.step()
            losses.append(total)
        model.eval()
        with torch.no_grad():
            for lo in range(0, PARITY_EVAL, b):
                x = torch.from_numpy(test[lo:lo + b]).to("cuda")
                logits.append(model(normalize_images(x, torch.float32)).float().cpu().numpy())
        logits = np.concatenate(logits)
    return {"losses": np.asarray(losses), "logits": logits,
            "params": {k: v.detach().cpu() for k, v in model.named_parameters()},
            "stats": {k: v.cpu() for k, v in model.named_buffers()
                      if k.endswith(("_mean", "_var"))}}


def merge_stages(parts: list[dict]) -> dict:
    """One data row's stage results (``parity_run`` under a mesh, in stage
    order) as the whole network's."""
    out = dict(parts[0])
    for key in ("params", "stats"):
        out[key] = {k: v for part in parts for k, v in part[key].items()}
    return out


def merge_rows(parts: list[dict], pipe: int) -> dict:
    """Every rank's ``parity_run`` result under a (data, pipe) mesh, in
    rank order, as the whole network's: each data row's stages joined,
    and every row required to equal the first bit for bit (losses,
    parameters, running statistics, eval logits), as the all-reduce over
    ``data`` gives each row the same sums."""
    rows = [merge_stages(parts[i:i + pipe]) for i in range(0, len(parts), pipe)]
    for d, row in enumerate(rows[1:], 1):
        gap = run_gap(row, rows[0])
        if gap["state"] or gap["logit"]:
            raise AssertionError(f"data row {d} differs from row 0: {gap}")
    return rows[0]


def run_gap(a: dict, b: dict) -> dict:
    """The largest absolute difference between two runs' train results
    (losses, parameters, running statistics: ``"state"``) and between their
    eval logits (``"logit"``)."""
    gaps = [float(np.abs(a["losses"] - b["losses"]).max())]
    for key in ("params", "stats"):
        gaps += [(a[key][k] - v).abs().max().item() for k, v in b[key].items()]
    return {"state": max(gaps), "logit": float(np.abs(a["logits"] - b["logits"]).max())}


def throughput(mesh, preset_name: str) -> dict:
    """This rank's pipelined train step (``PER_ROW_BATCH`` images a data
    row) timed, with the handoff's bytes and the card's shares; see the
    module docstring."""
    from ddl_tpu_torch.bench.dp import WARMUP, timed_trainer
    from ddl_tpu_torch.parallel.pipeline import HANDOFF

    HANDOFF.update(sends=0, recvs=0, bytes=0)
    step_ms, trainer, batches = timed_trainer(mesh, preset_name, PER_ROW_BATCH * mesh.spec.data,
                                              STEPS)
    out = {"step_ms": step_ms, "transport": HANDOFF["transport"],
           "handoff_bytes_per_step": HANDOFF["bytes"] / (WARMUP + STEPS)}
    out.update(_device_shares(mesh, trainer, batches[WARMUP:WARMUP + 3]))
    return out


def _union_us(spans) -> float:
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def _device_shares(mesh, trainer, batches) -> dict:
    """Where this rank's card spends the pipelined steps: ``torch.profiler``
    over ``batches``, the union of the compute kernels' intervals
    (``compute_share``) and of NCCL's (``nccl_share``: the handoff and the
    all-reduces, waiting for a peer included) as shares of the window's
    wall; the rest is the card idle (the bubble, the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ddl_tpu_torch.bench.dp import _sync_all

    _sync_all(mesh)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for images, labels in batches:
            trainer.train_step(images, labels)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = {True: [], False: []}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans["nccl" in e.name.lower()].append((e.time_range.start, e.time_range.end))
    return {"compute_share": _union_us(spans[False]) / wall_us,
            "nccl_share": _union_us(spans[True]) / wall_us}


def _worker(args) -> None:
    from ddl_tpu_torch import launch
    from ddl_tpu_torch.bench.dp import _exact_f32
    from ddl_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    _exact_f32()
    launch.bootstrap()
    mesh = build_mesh(MeshSpec(*WORLDS[args.world]))
    result = {"rank": mesh.rank, "device": str(mesh.device),
              "backend": torch.distributed.get_backend()}
    if args.parity:
        for schedule in ("gpipe", "1f1b"):
            got = parity_run(mesh, schedule)
            torch.save(got, Path(args.out) / f"parity-{schedule}-r{mesh.rank}.pt")
    result.update(throughput(mesh, args.world))
    (Path(args.out) / f"rank{mesh.rank}.json").write_text(json.dumps(result))


def main(argv=None) -> dict:
    from ddl_tpu_torch.bench.dp import _exact_f32, parity_errors, run_world
    from ddl_tpu_torch.ops import _build

    ap = argparse.ArgumentParser(description="pipelined DenseNet121 parity and throughput")
    ap.add_argument("--parity", action="store_true")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--world", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        _worker(args)
        return {}
    _exact_f32()
    _build.build()  # once, before any rank loads the kernels
    summary: dict = {"device": torch.cuda.get_device_name(0), "per_row_batch": PER_ROW_BATCH,
                     "microbatches": MICROBATCHES}
    for name, (data, pipe) in WORLDS.items():
        if args.parity:
            want = parity_run(data=data)
            summary[f"{name}_floor"] = parity_errors(parity_run(data=data, reverse=True), want)
        row, out = run_world("ddl_tpu_torch.bench.pp", data * pipe,
                             ["--world", name, *(["--parity"] if args.parity else [])],
                             PER_ROW_BATCH * data)
        row = {"world": name, "mesh": [data, pipe], **row}
        if args.parity:
            runs = {s: merge_rows([torch.load(out / f"parity-{s}-r{r}.pt", weights_only=False)
                                   for r in range(data * pipe)], pipe) for s in ("gpipe", "1f1b")}
            row["parity"] = {s: parity_errors(run, want) for s, run in runs.items()}
            row["gpipe_vs_1f1b"] = run_gap(runs["gpipe"], runs["1f1b"])
        summary[name] = row
        print(json.dumps(row), flush=True)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
