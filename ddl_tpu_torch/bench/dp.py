"""Data-parallel DenseNet121 on the card: train-step throughput at 1, 2 and
4 ranks, the collectives' share of a step, and parity with one process.

    python -m ddl_tpu_torch.bench.dp [--ranks 1,2,4] [--parity]

Each world of N ranks is started by ``launch.spawn_local``, one rank a
GPU over NCCL.  A rank builds the ``dp`` preset's Trainer (or the
``single`` preset's for N = 1) with phase 4's fused configuration of
``chip_smoke.py`` (bf16, the fused blocks 1 and 4, the kernel normalize)
and 15 images a rank, the reference ``ddp.py``'s per-rank batch, then
times its train step on device-resident batches (``timed_trainer``:
``WARMUP`` steps, then ``STEPS`` between two device synchronisations, the
ranks starting together).  ``bench/pp.py`` shares this harness.  Reported
per world: ms a step (the slowest rank's), steps/s
and images/s over every rank; the BatchNorm all-reduces a step and their
ms when each is timed from a synchronised device (``parallel.mesh.
COLLECTIVES``; that run serialises the step and is not the step's time);
and the host group's one-integer MAX all-reduce (``Mesh.any``, the
preemption flag at each step boundary), mean of 200.

``--zero`` runs each world's ranks with ``train.zero_sharding=true``
(ZeRO-1, ``train/fused_optim.py``) and the replicated step beside it:
``zero_turns`` times both in turns (replicated, ZeRO, ZeRO, replicated)
and reports each rank's optimizer bytes under both; with ``--parity``,
``zero_parity`` holds the ZeRO step to the replicated one in the same
world first.

``--parity`` first runs ``parity_run`` in this process, again with each
batch's rows reversed (the f32 noise floor of a change of summation
order, ``parity_floor``), and then in the world of 2 ranks: DenseNet121
in f32 with the packed blocks, 2 SGD steps of 30 images and an eval pass
over 60, the losses, parameters, BatchNorm running statistics and eval
logits compared (SGD: Adam's
first step is lr * sign(g), which turns f32 noise on near-zero gradients
into full steps).  The summary is one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["parity_run", "run_world", "throughput", "timed_trainer", "zero_parity",
           "zero_turns"]

PER_RANK_BATCH = 15  # reference ddp.py:335
SEED = 0
WARMUP, STEPS = 3, 20  # untimed steps, then timed ones
# parity_run: 2 SGD steps of 30 images, then the eval of 60
PARITY_STEPS, PARITY_LR, PARITY_BATCH, PARITY_EVAL = 2, 0.01, 30, 60
FUSED = {"model.compute_dtype": "bfloat16", "model.dense_block_impl": "fused",
         "model.dense_block_fused_blocks": (0, 3), "model.pallas_normalize": True}
# zero_parity: Adam at the preset's learning rate, 2 steps of 15 images a rank
ZERO_LR, ZERO_STEPS = 1e-3, 2
# An f32 sum of n terms in any order is within (n - 1) u sum|terms| of the
# exact one (u = 2^-24), so two orders differ by at most twice that.
F32_U = 2.0 ** -24
# Adam moves an element by at most ~lr a step (|m_hat / sqrt(v_hat)| <= 1
# at step 1, <= 1.0014 at step 2 for b1 0.9, b2 0.999), so two runs that
# take a near-zero gradient with opposite signs differ there by at most
# 2.01 lr a step.  Past that, the ZeRO run may drift from the replicated
# one by ZERO_FLOOR_X times what a mere change of summation order moves it
# (the replicated run with each rank's rows reversed), as phase 11 (a)
# holds DP against one process.
ZERO_STEP_BOUND, ZERO_FLOOR_X, ZERO_MOVED_LR = 2.01, 2.0, 1e-2


def parity_run(mesh=None, reverse: bool = False) -> dict:
    """DenseNet121 in f32 with the packed blocks from ``init_weights(SEED)``
    on this process's CUDA device: ``PARITY_STEPS`` SGD steps at
    ``PARITY_LR`` on the synthetic set's global batches of
    ``PARITY_BATCH`` (this rank's rows of each under a ``mesh`` of several
    ranks; with ``reverse``, each batch's rows in the opposite order: the
    same math summed in another order), then the eval pass over
    ``PARITY_EVAL`` images.  Returns the global step losses, the
    parameters, the BatchNorm running statistics and the eval logits in
    the global order."""
    from ddl_tpu_torch.config import ModelConfig
    from ddl_tpu_torch.data import SyntheticAptosDataset, to_device
    from ddl_tpu_torch.models import DenseNet, init_weights
    from ddl_tpu_torch.ops import normalize_images
    from ddl_tpu_torch.train.steps import make_eval_step, make_train_step

    world, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    batch, steps = PARITY_BATCH, PARITY_STEPS
    rows = slice(rank * batch // world, (rank + 1) * batch // world)
    device = "cuda" if mesh is None else mesh.device
    model = DenseNet(ModelConfig(compute_dtype="float32"), num_stages=1)
    init_weights(model, SEED)
    model = model.to(device).train()
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=PARITY_LR), torch.float32,
                           normalize_images, mesh=mesh)
    train, test = (SyntheticAptosDataset(PARITY_EVAL, 224, 5, seed=s) for s in (1, 2))
    losses = []
    for t in range(steps):
        idx = range(t * batch, (t + 1) * batch)[rows][::-1 if reverse else 1]
        images, labels = to_device(np.stack([train[i][0] for i in idx]),
                                   np.asarray([train[i][1] for i in idx], np.int32), device)
        losses.append(step(images, labels)[0].item())
    losses = np.asarray(losses)
    evaluate = make_eval_step(model.eval(), torch.float32, normalize_images)
    logits = []
    for t in range(PARITY_EVAL // batch):
        idx = range(t * batch, (t + 1) * batch)[rows]
        images = torch.from_numpy(np.stack([test[i][0] for i in idx])).to(device)
        part = evaluate(images).cpu().numpy()
        logits.append(part if mesh is None else mesh.gather(part))
    if mesh is not None:
        losses = mesh.gather(losses).reshape(world, steps).mean(0)
    return {"losses": losses, "logits": np.concatenate(logits),
            "params": {k: v.detach().cpu() for k, v in model.named_parameters()},
            "stats": {k: v.cpu() for k, v in model.named_buffers() if k.endswith(("_mean", "_var"))}}


def _f32_densenet(device):
    from ddl_tpu_torch.config import ModelConfig
    from ddl_tpu_torch.models import DenseNet, init_weights

    model = DenseNet(ModelConfig(compute_dtype="float32"), num_stages=1)
    init_weights(model, SEED)
    return model.to(device).train()


def zero_parity(mesh, image_size: int = 224) -> dict:
    """ZeRO-1 against the replicated step in this world (every rank calls
    it): DenseNet121 in f32 with the packed blocks from
    ``init_weights(SEED)``, Adam at ``ZERO_LR``, ``PER_RANK_BATCH`` images a
    rank of the synthetic set, cuDNN deterministic, TF32 off.  Returns,
    the same on every rank:

    * ``grad``: the ZeRO reduce-scatter's mean gradient shard against the
      replicated all-reduce's slice of it, the largest difference as a
      share of its bound ``2 (dp - 1) u sum_r |g_r| / dp`` (each element's);
    * ``update_bit_equal``: given the replicated step's gradients, the
      sharded update of the parameters is bit-equal to the replicated one;
    * ``trajectory``: ``ZERO_STEPS`` whole train steps of each from the same
      weights, and, where the two part, of the replicated step with each
      rank's rows reversed (its reordering floor): the losses, the largest
      parameter difference from the replicated run in units of ``ZERO_LR``
      a step, and the share of elements apart by more than ``ZERO_MOVED_LR
      * ZERO_LR`` (``bit_equal`` when the ZeRO run's parameters equal the
      replicated run's, and then no floor is needed);
    * ``opt_bytes``: this rank's optimizer bytes under each, and the
      transport of the ZeRO collectives."""
    from ddl_tpu_torch.data import SyntheticAptosDataset, to_device
    from ddl_tpu_torch.ops import cross_entropy_loss, normalize_images
    from ddl_tpu_torch.parallel.mesh import mean_over_data
    from ddl_tpu_torch.train.fused_optim import ZERO, with_zero
    from ddl_tpu_torch.train.state import Optimizer
    from ddl_tpu_torch.train.steps import make_train_step

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        world, rank, device = mesh.size, mesh.rank, mesh.device
        batch = PER_RANK_BATCH * world
        data = SyntheticAptosDataset(batch * ZERO_STEPS, image_size, 5, seed=1)
        rows = range(rank * PER_RANK_BATCH, (rank + 1) * PER_RANK_BATCH)
        batches = [to_device(np.stack([data[t * batch + i][0] for i in rows]),
                           np.asarray([data[t * batch + i][1] for i in rows], np.int32), device)
                   for t in range(ZERO_STEPS)]
        rep, zero = _f32_densenet(device), _f32_densenet(device)
        opt_r = Optimizer(rep.parameters(), ZERO_LR, fused=True)
        opt_z = with_zero(Optimizer(zero.parameters(), ZERO_LR, fused=True), mesh)
        z = opt_z.zero
        out = {"transport": ZERO["transport"], "sharded_leaves": len(z.leaves),
               "leaves": len(opt_z.params)}

        # the first step's gradients, reduced both ways
        rep.data_group = mesh.group
        images, labels = batches[0]
        loss = cross_entropy_loss(rep(normalize_images(images, torch.float32)), labels)
        loss.backward()
        params = list(rep.parameters())
        local = [p.grad.detach().clone() for p in params]
        with torch.no_grad():
            mean_over_data([p.grad for p in params], mesh)
            big = [i for i, _ in z.leaves]
            shard = z.reduce_scatter_mean(z.pack([local[i] for i in big]))
            want = z.take([params[i].grad for i in big])
            abs_sum = z.pack([local[i].abs() for i in big])
            torch.distributed.all_reduce(abs_sum, group=mesh.group)
            bound = (2 * (world - 1) * F32_U / world) * abs_sum.view(world, -1)[z.rank]
            diff = (shard - want).abs()
            out["grad"] = {"max_abs": diff.max().item(),
                           "share_of_bound": (diff / bound.clamp_min(1e-45)).max().item()}
            # given these gradients, the sharded update against the replicated
            zero.load_state_dict(rep.state_dict())
            for p, q in zip(params, zero.parameters()):
                q.grad = p.grad.clone()
            opt_z.shard.grad = want.clone()
            for i in big:
                opt_z.params[i].grad = None
            opt_r.step()
            opt_z.step()
            out["update_bit_equal"] = all(torch.equal(p, q) for p, q in zip(
                rep.parameters(), zero.parameters()))
        out["opt_bytes"] = {"replicated": opt_r.state_bytes(), "zero": opt_z.state_bytes()}

        # whole steps of each from the same weights, and the floor where
        # they part (at two ranks they may not: one addition per element)
        runs = {}
        for name, use_zero, order in (("replicated", False, 1), ("zero", True, 1),
                                      ("reversed", False, -1)):
            if name == "reversed" and all(torch.equal(a, b) for a, b in zip(
                    runs["replicated"][1], runs["zero"][1])):
                break
            model = _f32_densenet(device)
            opt = Optimizer(model.parameters(), ZERO_LR, fused=True)
            if use_zero:
                opt = with_zero(opt, mesh)
            step = make_train_step(model, opt, torch.float32, normalize_images, mesh=mesh)
            losses = [step(i.flip(0) if order < 0 else i,
                           lab.flip(0) if order < 0 else lab)[0].item() for i, lab in batches]
            runs[name] = (mesh.gather(np.asarray(losses)).reshape(world, -1).mean(0),
                          [p.detach() for p in model.parameters()])

        def apart(name):
            moved = torch.cat([(a - b).abs().flatten()
                               for a, b in zip(runs["replicated"][1], runs[name][1])])
            return {"max_in_lr_steps": moved.max().item() / (ZERO_LR * ZERO_STEPS),
                    "moved_share": (moved > ZERO_MOVED_LR * ZERO_LR).float().mean().item()}

        out["trajectory"] = {
            "losses": runs["replicated"][0].tolist(), "zero_losses": runs["zero"][0].tolist(),
            "bit_equal": "reversed" not in runs, "zero": apart("zero"),
            "floor": apart("reversed") if "reversed" in runs else None}
        return out
    finally:
        torch.backends.cudnn.deterministic = deterministic


def zero_parity_errors(got: dict) -> list[str]:
    """What in ``zero_parity``'s result breaks its limits (empty: none)."""
    bad = []
    if got["grad"]["share_of_bound"] > 1.0:
        bad.append(f"gradient shard beyond the reordering bound: {got['grad']}")
    if not got["update_bit_equal"]:
        bad.append("the sharded update is not bit-equal given equal gradients")
    t = got["trajectory"]
    if t["losses"][0] != t["zero_losses"][0]:
        bad.append(f"step 1's loss differs: {t['losses'][0]} vs {t['zero_losses'][0]}")
    zero, floor = t["zero"], t["floor"]
    if t["bit_equal"]:
        return bad
    if zero["max_in_lr_steps"] > ZERO_STEP_BOUND:
        bad.append(f"a parameter moved apart by {zero['max_in_lr_steps']:.3f} lr a step")
    for key in ("max_in_lr_steps", "moved_share"):
        if zero[key] > ZERO_FLOOR_X * floor[key]:
            bad.append(f"{key} {zero[key]:.3e} beyond {ZERO_FLOOR_X}x the reordering "
                       f"floor's {floor[key]:.3e}")
    if got["opt_bytes"]["zero"] >= got["opt_bytes"]["replicated"]:
        bad.append(f"ZeRO holds no fewer optimizer bytes: {got['opt_bytes']}")
    return bad


def zero_turns(mesh, steps: int = STEPS) -> dict:
    """The replicated and the ZeRO dp step timed in turns (replicated,
    ZeRO, ZeRO, replicated), each a fresh Trainer by ``timed_trainer``;
    returns the ms a step of each turn and this rank's optimizer bytes
    under each."""
    out = {"replicated_ms": [], "zero_ms": [], "opt_bytes": {}}
    for use_zero in (False, True, True, False):
        ms, trainer, _ = timed_trainer(mesh, "dp", PER_RANK_BATCH * mesh.size, steps,
                                       zero=use_zero)
        key = "zero" if use_zero else "replicated"
        out[f"{key}_ms"].append(ms)
        out["opt_bytes"][key] = trainer.optimizer.state_bytes()
        del trainer
    return out


def _share(got: dict, want: dict) -> float:
    """The largest difference over the tensors of ``want`` as a share of
    their largest value."""
    big = max(v.abs().max().item() for v in want.values())
    return max((got[k] - v).abs().max().item() for k, v in want.items()) / big


def parity_errors(got: dict, want: dict) -> dict:
    """Each step's relative loss difference, and the parameters', running
    statistics' and eval logits' largest difference as a share of the
    largest value."""
    return {
        "loss_rel": (np.abs(got["losses"] - want["losses"]) / np.abs(want["losses"])).tolist(),
        "param": _share(got["params"], want["params"]),
        "stats": _share(got["stats"], want["stats"]),
        "logit": float(np.abs(got["logits"] - want["logits"]).max()
                       / np.abs(want["logits"]).max()),
    }


def _sync_all(mesh) -> None:
    torch.cuda.synchronize()
    mesh.barrier()


def timed_trainer(mesh, preset_name: str, batch: int, steps: int, zero: bool = False):
    """``preset_name``'s Trainer on ``mesh`` in the fused configuration
    (under ZeRO-1 with ``zero``), with global batches of ``batch`` images,
    and its train step timed on
    device-resident batches: ``WARMUP`` steps, then ``steps`` between two
    device synchronisations, the ranks starting together.  Returns the ms a
    step, the Trainer and its batches (``WARMUP + steps``)."""
    from ddl_tpu_torch.config import preset
    from ddl_tpu_torch.data import to_device
    from ddl_tpu_torch.train import Trainer

    cfg = preset(preset_name, **FUSED, **{
        "mesh.data": mesh.spec.data, "data.global_batch_size": batch,
        "data.eval_batch_size": batch, "data.dataset_dir": "",
        "data.synthetic_num_train": batch * (WARMUP + steps), "data.synthetic_num_test": batch,
        "train.seed": SEED, "train.log_dir": "", "train.checkpoint_dir": "",
        "train.auto_resume": False, "train.zero_sharding": zero})
    trainer = Trainer(cfg, mesh=mesh)
    trainer.model.train()
    batches = [to_device(i, lab, mesh.device) for i, lab in trainer.train_loader]
    for images, labels in batches[:WARMUP]:
        trainer.train_step(images, labels)
    _sync_all(mesh)
    t0 = time.perf_counter()
    for images, labels in batches[WARMUP:]:
        trainer.train_step(images, labels)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3, trainer, batches


def throughput(mesh) -> dict:
    """This rank's train step (``PER_RANK_BATCH`` images) timed, then with
    every BatchNorm all-reduce timed, then the preemption flag; see the
    module docstring."""
    from ddl_tpu_torch.parallel.mesh import COLLECTIVES

    world = mesh.size
    step_ms, trainer, batches = timed_trainer(mesh, "dp" if world > 1 else "single",
                                              PER_RANK_BATCH * world, STEPS)
    COLLECTIVES.update(all_reduces=0, seconds=0.0, timed=True)
    _sync_all(mesh)
    t0 = time.perf_counter()
    for images, labels in batches[WARMUP:WARMUP + 3]:
        trainer.train_step(images, labels)
    torch.cuda.synchronize()
    timed_ms = (time.perf_counter() - t0) / 3 * 1e3
    out = {"step_ms": step_ms, "timed_step_ms": timed_ms,
           "bn_all_reduces": COLLECTIVES["all_reduces"] / 3,
           "bn_all_reduce_ms": COLLECTIVES["seconds"] / 3 * 1e3}
    COLLECTIVES["timed"] = False
    t0 = time.perf_counter()
    for _ in range(200):
        mesh.any(False)
    out["flag_ms"] = (time.perf_counter() - t0) / 200 * 1e3
    return out


def _exact_f32() -> None:
    """TF32 off for cuDNN and cuBLAS, in this process and in every rank:
    the f32 parity runs' products are exact f32 (as in ``chip_smoke.py``)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _worker(args) -> None:
    from ddl_tpu_torch import launch
    from ddl_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    _exact_f32()
    world = int(os.environ.get("DDL_NUM_PROCESSES") or 1)
    launch.bootstrap()
    mesh = build_mesh(MeshSpec(world, 1))
    result = {"rank": mesh.rank, "device": str(mesh.device), "backend": (
        torch.distributed.get_backend() if world > 1 else None)}
    if args.zero:
        if args.parity:
            result["zero_parity"] = zero_parity(mesh)
        result.update(zero_turns(mesh))
        result["step_ms"] = float(np.median(result["zero_ms"]))
        (Path(args.out) / f"rank{mesh.rank}.json").write_text(json.dumps(result))
        return
    if args.parity:
        got = parity_run(mesh)
        if mesh.rank == 0:
            torch.save(got, Path(args.out) / "parity.pt")
    result.update(throughput(mesh))
    (Path(args.out) / f"rank{mesh.rank}.json").write_text(json.dumps(result))


def run_world(module: str, world: int, args: list[str], images: int) -> tuple[dict, Path]:
    """Starts ``world`` ranks of ``python -m module --worker --out D
    *args`` on this host (``launch.spawn_local``, one GPU a rank), each
    writing ``D/rank<r>.json`` with its ``step_ms``; returns the world's
    row (the slowest rank's ms a step, steps/s, ``images`` a step over
    every rank per second, each rank's results) and ``D``."""
    from ddl_tpu_torch import launch

    launch.check_local_world(world)
    out = Path(tempfile.mkdtemp(prefix=f"ddl_{module.rsplit('.', 1)[-1]}{world}-"))
    env = {k: v for k, v in os.environ.items() if not k.startswith("DDL_")}
    code = launch.spawn_local([sys.executable, "-m", module, "--worker", "--out", str(out), *args],
                              world, env=env)
    if code:
        raise SystemExit(f"the world of {world} ({module} {' '.join(args)}) exited {code}")
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]
    slowest = max(r["step_ms"] for r in ranks)
    return {"backend": ranks[0]["backend"], "step_ms": slowest, "steps_per_s": 1e3 / slowest,
            "images_per_s": images * 1e3 / slowest, "per_rank": ranks}, out


def main(argv=None) -> dict:
    from ddl_tpu_torch.ops import _build

    ap = argparse.ArgumentParser(description="data-parallel DenseNet121 throughput")
    ap.add_argument("--ranks", default="1,2,4", help="world sizes, comma-separated")
    ap.add_argument("--parity", action="store_true")
    ap.add_argument("--zero", action="store_true",
                    help="ZeRO-1 worlds, timed in turns with the replicated step")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        _worker(args)
        return {}
    _exact_f32()
    _build.build()  # once, before any rank loads the kernels
    summary: dict = {"device": torch.cuda.get_device_name(0), "per_rank_batch": PER_RANK_BATCH}
    if args.parity and not args.zero:
        want = parity_run()
        summary["parity_floor"] = parity_errors(parity_run(reverse=True), want)
    failed = []
    for world in (int(w) for w in args.ranks.split(",")):
        parity = args.parity and (world == 2 or args.zero) and world > 1
        flags = (["--parity"] if parity else []) + (["--zero"] if args.zero else [])
        row, out = run_world("ddl_tpu_torch.bench.dp", world, flags, PER_RANK_BATCH * world)
        row = {"ranks": world, **row}
        if parity and args.zero:
            got = row["per_rank"][0]["zero_parity"]
            row["zero_parity_errors"] = zero_parity_errors(got)
            failed += row["zero_parity_errors"]
        elif parity:
            row["parity"] = parity_errors(torch.load(out / "parity.pt", weights_only=False), want)
        summary[f"world{world}"] = row
        print(json.dumps(row), flush=True)
    print(json.dumps(summary))
    if failed:
        raise SystemExit(f"ZeRO parity failed: {failed}")
    return summary


if __name__ == "__main__":
    main()
