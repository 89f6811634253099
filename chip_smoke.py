#!/usr/bin/env python3
"""Drive the PyTorch port (``ddl_tpu_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repo root; needs a CUDA card and nvcc

Phases (any failed check raises, and the script exits nonzero):

1. Set-up: the card's name and power limit, the PyTorch/CUDA versions, the
   kernels built from ``ddl_tpu_torch/csrc/`` into ``build/ddl_tpu_torch/``
   (one ``nvcc`` per source, in parallel).  TF32 is switched off for
   cuDNN and cuBLAS so the plain versions' f32 products are exact.
2. Kernels: each kernel against its plain PyTorch version at the shapes
   the slice gives it, then timed with CUDA events (kernel, plain version,
   one library call where one computes the same function) beside its
   bound, the least time the card could take for the same work.
3. Eval slice: ``Trainer(cfg).evaluate(0)`` on DenseNet121 at full width
   with the fused configuration (bf16, fused blocks 1 and 4, kernel
   normalize) over a synthetic eval set whose last batch is
   sentinel-padded.  The launch counters are zeroed just before and read
   just after this run; the logits are then held against the same model
   run through the plain versions on the card.
4. Train slice: ``Trainer(cfg).train(1)`` on the same configuration, five
   steps of 30 images and the eval pass, counters zeroed just before and
   read just after; then one train step through the kernels against one
   through the plain versions from the same weights (loss, every
   parameter's gradient, the running statistics), and the train step
   timed on device-resident batches.

The line before the last is ``{"kernels": [...]}`` (launches from the
train slice's run, which also evaluates); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent))

from ddl_tpu_torch.config import preset  # noqa: E402
from ddl_tpu_torch.data import to_device  # noqa: E402
from ddl_tpu_torch.models import DenseNet  # noqa: E402
from ddl_tpu_torch.ops import _build  # noqa: E402
from ddl_tpu_torch.ops import cross_entropy_loss  # noqa: E402
from ddl_tpu_torch.ops.fused_dense_block import (  # noqa: E402
    fused_dense_block,
    fused_dense_block_bwd,
    fused_dense_block_bwd_plain,
    fused_dense_block_fn_plain,
    fused_dense_block_plain,
    pack_block_params,
)
from ddl_tpu_torch.ops.image_kernel import normalize, normalize_plain  # noqa: E402
from ddl_tpu_torch.train import Trainer, make_eval_step  # noqa: E402

SEED = 0
EVAL_BATCH = 30
EVAL_SET = 100  # 3 full batches + 10 real rows padded with 20 sentinels
# Fused block: max |kernel - plain| / max |plain|.  Kernel and plain
# version round at the same places, so they differ only where a different
# f32 summation order flips a bf16 rounding: one ulp, at most 2^-7 of the
# largest value, which then feeds the later layers.  1e-2 admits one ulp
# anywhere and not two at the largest values.
BLOCK_TOL = 1e-2
# Logits of the whole model: kernel path vs plain path, same weights.  The
# one-ulp strip differences travel through the 120 layers that follow.
LOGIT_TOL = 5e-2  # max |kernel - plain| / max |plain|
ARGMAX_AGREE = 0.99
# Backward kernel vs its plain version, each gradient: max |diff| / max
# |plain|.  Both round dstrip, hid and dy1 to bf16 at the same places, so a
# different f32 summation order (and the run-to-run order of the kernel's
# atomic adds) flips a bf16 rounding of dy1 or dstrip here and there.  The
# f32 parameter gradients are sums over every pixel, where such flips
# average out: 1e-2.  dx0 is itself rounded to bf16 (one ulp is 2^-8 to
# 2^-7 of its largest value) after summing the flipped terms of every later
# layer at each pixel: 2e-2, two ulps (measured up to 0.0101 at block 1).
BWD_TOL = 1e-2
BWD_DX0_TOL = 2e-2
TRAIN_SET = 150  # five train steps of 30
# One train step, kernel path vs plain path from the same weights.  The
# one-ulp strip differences of the fused blocks travel through the rest of
# the network and back: the loss within 1e-2 (relative) and the running
# statistics within 1e-2 (relative).  Gradients: a weight that feeds a
# train-mode BatchNorm leaves the loss invariant to its scale, so its
# gradient is the small sum of two large terms (the kernel's VJP at fixed
# affines and the term through the batch statistics) that cancel, and bf16
# rounding noise in either term is large in the sum: kernel and plain path
# differ by ~20% (relative L2) on such leaves of block 1 and the stem, as
# two bf16 runs of the same math would.  So each path is held against the
# f32 gradient of the same step (the plain versions in f32 on the card):
# the kernel path no farther from it than the plain path, within 25%, for
# the whole gradient vector; and every leaf within 5e-2 of the model's
# largest gradient of the plain path.
STEP_LOSS_TOL = 1e-2
STEP_GRAD_TOL = 5e-2
STEP_GRAD_RATIO = 1.25
STEP_STATS_TOL = 1e-2

# Dense bf16 tensor-core FLOP/s and device-memory bytes/s, NVIDIA data sheets.
PEAKS = {"SXM": (989e12, 3.35e12), "PCIe": (756e12, 2.0e12), "NVL": (835e12, 3.9e12)}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def card_peaks(name: str) -> tuple[float, float]:
    part = next((p for p in ("PCIe", "NVL") if p in name), "SXM")
    return PEAKS[part]


def measure(fn, inputs, iters: int = 20, warmup: int = 3) -> tuple[float, float, dict]:
    """Per call of ``fn(x)``, cycling through ``inputs`` (several copies, so
    a launch does not find its input in L2): (device ms, the profiler's sum
    of kernel times on the card; wall ms, CUDA events around back-to-back
    calls, host overhead included; {kernel name: device ms})."""
    for i in range(warmup):
        fn(inputs[i % len(inputs)])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    wall = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(inputs[i % len(inputs)])
        torch.cuda.synchronize()
    kernels = {e.key: e.self_device_time_total / 1e3 / iters
               for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    require(sum(kernels.values()) > 0, "the profiler recorded device time")
    return sum(kernels.values()), wall, kernels


def setup() -> dict:
    name = torch.cuda.get_device_name(0)
    print(f"card: {smi()}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s: "
          + ", ".join(str(p.relative_to(_build.BUILD_DIR.parents[1])) for p in libs.values()))
    for log in sorted(_build.BUILD_DIR.glob("*.log")):
        for line in log.read_text().splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {log.stem}: {line.strip()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off for cuDNN and cuBLAS: the plain versions' f32 products are exact")
    flops, bw = card_peaks(name)
    print(f"peaks used for bounds: {flops / 1e12:.0f} TFLOP/s bf16, {bw / 1e12:.2f} TB/s")
    return {"name": name, "flops": flops, "bw": bw}


def check_normalize(card: dict, rng) -> dict:
    shape = (EVAL_BATCH, 224, 224, 3)
    max_err = 0.0
    for s in (shape, (3, 7, 5, 3)):  # the slice's batch, and a ragged tail
        x = torch.from_numpy(rng.integers(0, 256, s, dtype=np.uint8)).cuda()
        for dt, bits in ((torch.bfloat16, torch.int16), (torch.float32, torch.int32)):
            got, want = normalize(x, dt), normalize_plain(x, dt)
            torch.cuda.synchronize()
            equal = torch.equal(got.view(bits), want.view(bits))
            max_err = max(max_err, (got.float() - want.float()).abs().max().item())
            print(f"normalize {s} {dt}: bit-equal {equal}")
            require(equal, f"normalize {s} {dt} bit-equal to its plain version")
    xs = [torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).cuda() for _ in range(8)]
    ms, wall, _ = measure(lambda x: normalize(x, torch.bfloat16), xs)
    plain_ms, plain_wall, _ = measure(lambda x: normalize_plain(x, torch.bfloat16), xs)
    # two calls: the cast, then the in-place multiply
    library_ms, library_wall, _ = measure(lambda x: x.to(torch.bfloat16).mul_(1.0 / 255.0), xs)
    row = {
        "name": "normalize", "route": "cuda", "source": "ddl_tpu_torch/csrc/normalize.cu",
        "replaces": "ddl_tpu/ops/pallas_image.py:26", "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": xs[0].numel() * (1 + 2) / card["bw"] * 1e3, "bound_by": "bytes",
    }
    print(f"normalize {shape} bf16, device ms (wall ms per call): kernel {ms:.4f} ({wall:.4f}), "
          f"plain {plain_ms:.4f} ({plain_wall:.4f}), library {library_ms:.4f} "
          f"({library_wall:.4f}); bound {row['bound_ms']:.4f} ms (bytes)")
    return row


def random_block(rng, b, h, w, c0, n_layers, growth=32, bn=128):
    """Seeded block input and folded parameters (positive running variances)."""
    def normal(*shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))

    def uniform(lo, hi, n):
        return torch.from_numpy(rng.uniform(lo, hi, n).astype(np.float32))

    layers = []
    for i in range(n_layers):
        c = c0 + i * growth
        layers.append({
            "norm1.weight": uniform(0.5, 1.5, c), "norm1.bias": normal(c, std=0.1),
            "norm1.running_mean": normal(c, std=0.5), "norm1.running_var": uniform(0.5, 2.0, c),
            "conv1.weight": normal(bn, c, 1, 1, std=(2.0 / c) ** 0.5),
            "norm2.weight": uniform(0.5, 1.5, bn), "norm2.bias": normal(bn, std=0.1),
            "norm2.running_mean": normal(bn, std=0.5), "norm2.running_var": uniform(0.5, 2.0, bn),
            "conv2.weight": normal(growth, bn, 3, 3, std=(2.0 / (9 * bn)) ** 0.5),
        })
    packed = pack_block_params([{k: v.cuda() for k, v in s.items()} for s in layers],
                               torch.bfloat16)
    x0 = normal(b, h, w, c0).cuda().to(torch.bfloat16)
    return x0, packed


def block_work(b, h, w, c0, n_layers, growth=32, bn=128) -> tuple[float, float]:
    """(FLOPs, bytes) of one block call: every product once; each input
    read once and the output written once."""
    c_ins = [c0 + i * growth for i in range(n_layers)]
    flops = sum(2 * b * h * w * (c * bn + 9 * bn * growth) for c in c_ins)
    params = sum(c * (4 + 4 + 2 * bn) for c in c_ins) + n_layers * (2 * 4 * bn + 9 * growth * bn * 2)
    io = b * h * w * (c0 + c0 + n_layers * growth) * 2
    return flops, io + params


def check_fused_block(card: dict, rng) -> dict:
    x0, packed = random_block(rng, 2, 9, 11, 64, 2)  # edge tiles on both axes
    want = fused_dense_block_plain(x0, packed).float()
    rel = ((fused_dense_block(x0, packed).float() - want).abs().max() / want.abs().max()).item()
    print(f"fused block (2,9,11,64) L=2: rel err {rel:.5f}")
    require(rel <= BLOCK_TOL, f"fused block edge tiles within {BLOCK_TOL}")
    row = {"name": "fused_dense_block", "route": "cuda",
           "source": "ddl_tpu_torch/csrc/fused_dense_block.cu",
           "replaces": "ddl_tpu/ops/fused_dense_block.py:155", "library_ms": None,
           "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    flops_total = bytes_total = 0.0
    # DenseNet121 blocks 1 and 4 at eval batch 30 (config.py:44-96)
    for label, geom in (("denseblock1", (EVAL_BATCH, 56, 56, 64, 6)),
                        ("denseblock4", (EVAL_BATCH, 7, 7, 512, 16))):
        x0, packed = random_block(rng, *geom)
        got = fused_dense_block(x0, packed).float()
        want = fused_dense_block_plain(x0, packed).float()
        require(bool(torch.isfinite(got).all()), f"{label} kernel output finite")
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        xs = [x0] + [x0.clone() for _ in range(3)]
        ms, wall, _ = measure(lambda x: fused_dense_block(x, packed), xs)
        plain_ms, plain_wall, _ = measure(lambda x: fused_dense_block_plain(x, packed), xs, iters=5)
        flops, nbytes = block_work(*geom)
        bound = max(flops / card["flops"], nbytes / card["bw"]) * 1e3
        print(f"fused block {label} {geom}: max abs err {err:.5f}, rel {rel:.5f} "
              f"(tol {BLOCK_TOL}); device ms (wall ms per call): kernel {ms:.4f} "
              f"({wall:.4f}), plain {plain_ms:.4f} ({plain_wall:.4f}); bound {bound:.4f} ms "
              f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB, "
              f"{flops / ms / 1e9:.1f} TFLOP/s achieved)")
        require(rel <= BLOCK_TOL, f"{label} within {BLOCK_TOL} of the plain version")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["bound_ms"] += bound
        flops_total += flops
        bytes_total += nbytes
    row["bound_by"] = ("operations" if flops_total / card["flops"] >= bytes_total / card["bw"]
                       else "bytes")
    return row


def block_bwd_work(b, h, w, c0, n_layers, growth=32, bn=128) -> tuple[float, float]:
    """(FLOPs, bytes) of one backward call: twice the forward's products
    (the input and the weight gradients of each); the output map and its
    cotangent read once, dx0 and the f32 parameter gradients written once,
    the folded parameters read once."""
    flops, _ = block_work(b, h, w, c0, n_layers, growth, bn)
    c_ins = [c0 + i * growth for i in range(n_layers)]
    c_tot = c0 + n_layers * growth
    params = sum(c * (4 + 4 + 2 * bn) for c in c_ins) + n_layers * (2 * 4 * bn + 9 * growth * bn * 2)
    grads = sum(c * (4 + 4 + 4 * bn) for c in c_ins) + n_layers * (2 * 4 * bn + 9 * growth * bn * 4)
    io = b * h * w * (2 * c_tot + c0) * 2
    return 2 * flops, io + params + grads


def check_fused_block_bwd(card: dict, rng) -> dict:
    row = {"name": "fused_dense_block_bwd", "route": "cuda",
           "source": "ddl_tpu_torch/csrc/fused_dense_block_bwd.cu",
           "replaces": "ddl_tpu/ops/fused_dense_block.py:277", "library_ms": None,
           "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    flops_total = bytes_total = 0.0
    # edge tiles on both axes, then DenseNet121 blocks 1 and 4 at train batch 30
    for label, geom in (("edge tiles", (2, 9, 11, 64, 2)),
                        ("denseblock1", (EVAL_BATCH, 56, 56, 64, 6)),
                        ("denseblock4", (EVAL_BATCH, 7, 7, 512, 16))):
        x0, packed = random_block(rng, *geom)
        out = fused_dense_block(x0, packed)
        gs = [torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32)).cuda()
              .to(torch.bfloat16) for _ in range(4)]
        dx0, grads = fused_dense_block_bwd(out, gs[0], packed)
        want_dx0, want = fused_dense_block_bwd_plain(out, gs[0], packed)
        got = {"dx0": dx0.float(), **grads}
        want = {"dx0": want_dx0.float(), **want}
        rels = {}
        for k, v in got.items():
            require(bool(torch.isfinite(v).all()), f"{label} backward {k} finite")
            err = (v - want[k]).abs().max().item()
            rels[k] = err / want[k].abs().max().item()
            row["max_abs_err"] = max(row["max_abs_err"], err)
        print(f"fused block backward {label} {geom}: max |diff| / max |plain| "
              + ", ".join(f"{k} {r:.5f}" for k, r in rels.items())
              + f" (tol dx0 {BWD_DX0_TOL}, the rest {BWD_TOL})")
        require(rels.pop("dx0") <= BWD_DX0_TOL, f"{label} backward dx0 within {BWD_DX0_TOL}")
        require(max(rels.values()) <= BWD_TOL, f"{label} backward gradients within {BWD_TOL}")
        if label == "edge tiles":
            continue
        ms, wall, _ = measure(lambda g: fused_dense_block_bwd(out, g, packed), gs, iters=10)
        plain_ms, plain_wall, _ = measure(lambda g: fused_dense_block_bwd_plain(out, g, packed),
                                          gs, iters=3, warmup=1)
        flops, nbytes = block_bwd_work(*geom)
        bound = max(flops / card["flops"], nbytes / card["bw"]) * 1e3
        print(f"  device ms (wall ms per call): kernel {ms:.4f} ({wall:.4f}), plain "
              f"{plain_ms:.4f} ({plain_wall:.4f}); bound {bound:.4f} ms ({flops / 1e9:.2f} "
              f"GFLOP, {nbytes / 1e6:.1f} MB, {flops / ms / 1e9:.1f} TFLOP/s achieved)")
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["bound_ms"] += bound
        flops_total += flops
        bytes_total += nbytes
    row["bound_by"] = ("operations" if flops_total / card["flops"] >= bytes_total / card["bw"]
                       else "bytes")
    return row


def fused_cfg(**extra):
    return preset("single", **{
        "model.compute_dtype": "bfloat16", "model.dense_block_impl": "fused",
        "model.dense_block_fused_blocks": (0, 3), "model.pallas_normalize": True,
        "data.dataset_dir": "", "data.synthetic_num_test": EVAL_SET,
        "data.eval_batch_size": EVAL_BATCH, "train.seed": SEED, **extra,
    })


def run_slice(card: dict) -> dict:
    cfg = fused_cfg()
    trainer = Trainer(cfg)  # device left at its default: cuda
    n_batches = len(trainer.test_loader)
    trainer.evaluate(0)  # warm-up: cuDNN plans, allocator, kernel libraries
    torch.cuda.synchronize()

    normalize.launches = 0
    fused_dense_block.launches = 0
    t0 = time.perf_counter()
    metrics = trainer.evaluate(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"normalize": normalize.launches, "fused_dense_block": fused_dense_block.launches}

    print(f"eval metrics: {json.dumps(metrics)}")
    for k in ("val_loss", "val_accuracy", "qwk"):
        require(bool(np.isfinite(metrics[k])), f"{k} finite")
    require(metrics["val_examples"] == EVAL_SET, f"val_examples == {EVAL_SET}")
    per_batch = {"normalize": 1, "fused_dense_block": sum(
        cfg.model.block_config[b] for b in cfg.model.dense_block_fused_blocks)}
    print(f"launches in the eval run ({n_batches} batches): {launches}")
    for k, n in per_batch.items():
        require(launches[k] == n * n_batches, f"{k} launched {n} x {n_batches} times")

    # the same weights through the plain versions, on the card
    ref = DenseNet(cfg.model, num_stages=1, fused_fn=fused_dense_block_plain)
    ref.load_state_dict(trainer.model.state_dict())
    ref_step = make_eval_step(ref.cuda().eval(), torch.bfloat16, normalize_plain)
    got, want, valid = [], [], []
    batches = [to_device(i, l, "cuda") for i, l in trainer.test_loader]
    for images, labels in batches:
        got.append(trainer.eval_step(images))
        want.append(ref_step(images))
        valid.append(labels >= 0)
    mask = torch.cat(valid)
    got, want = torch.cat(got)[mask], torch.cat(want)[mask]
    rel = ((got - want).abs().max() / want.abs().max()).item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    print(f"logits vs plain path: max abs diff {(got - want).abs().max().item():.5f}, "
          f"rel {rel:.5f} (tol {LOGIT_TOL}), argmax agreement {agree:.4f} (min {ARGMAX_AGREE})")
    require(rel <= LOGIT_TOL, f"logits within {LOGIT_TOL} of the plain path")
    require(agree >= ARGMAX_AGREE, f"argmax agreement >= {ARGMAX_AGREE}")

    step_ms, step_wall, kernels = measure(trainer.eval_step, [b[0] for b in batches], iters=10)
    print(f"eval on {card['name']} ({smi()}): wall {wall / n_batches * 1e3:.2f} ms/batch "
          f"(loader included), {EVAL_SET / wall:.1f} images/s; eval step on device-resident "
          f"batches {step_wall:.3f} ms/batch wall (CUDA events), "
          f"{EVAL_BATCH / step_wall * 1e3:.1f} images/s, device busy {step_ms:.3f} ms "
          f"({step_ms / step_wall:.1%} of the step), {len(kernels)} distinct kernels")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    for name, k_ms in top:
        print(f"  {k_ms:8.4f} ms/batch  {k_ms / step_ms:6.1%}  {name[:90]}")
    return launches


def step_grads(model, images, labels, normalizer, dtype=torch.bfloat16) -> tuple[float, dict]:
    """One train step's forward and backward (no update): the loss and
    every parameter's gradient."""
    model.zero_grad(set_to_none=True)
    loss = cross_entropy_loss(model(normalizer(images, dtype)), labels)
    loss.backward()
    return loss.item(), {k: p.grad.float() for k, p in model.named_parameters()}


def l2_diff(a: dict, b: dict) -> float:
    """||a - b|| / ||b|| over the whole gradient vector."""
    return (sum((a[k] - b[k]).square().sum() for k in b).sqrt()
            / sum(v.square().sum() for v in b.values()).sqrt()).item()


def run_train_slice(card: dict) -> dict:
    log_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_logs"
    cfg = fused_cfg(**{"data.synthetic_num_train": TRAIN_SET, "train.log_dir": str(log_dir)})
    trainer = Trainer(cfg)
    n_train, n_eval = len(trainer.train_loader), len(trainer.test_loader)
    launches = {"normalize": normalize, "fused_dense_block": fused_dense_block,
                "fused_dense_block_bwd": fused_dense_block_bwd}
    for fn in launches.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer.train(1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in launches.items()}
    print(f"launches in train(1) ({n_train} train steps, {n_eval} eval batches): {launches}")
    per_layer = sum(cfg.model.block_config[b] for b in cfg.model.dense_block_fused_blocks)
    want = {"normalize": n_train + n_eval, "fused_dense_block": per_layer * (n_train + n_eval),
            "fused_dense_block_bwd": per_layer * n_train}
    for k, n in want.items():
        require(launches[k] == n, f"{k} launched {n} times in train(1)")
    # the epoch's mean loss, as the loop logged it: the last row's value
    loss_csv = log_dir / "by_job_id" / trainer.job_id / "loss.csv"
    loss = float(loss_csv.read_text().splitlines()[-1].split(",")[-1])
    metrics = trainer.evaluate(0)
    print(f"train(1) wall {wall:.2f} s with its eval pass; epoch 0 loss {loss:.4f}; "
          f"eval {json.dumps(metrics)}")
    require(bool(np.isfinite(loss)), "train loss finite")
    for k in ("val_loss", "val_accuracy", "qwk"):
        require(bool(np.isfinite(metrics[k])), f"eval {k} finite after training")

    # one step through the kernels, one through the plain versions and one
    # through the plain versions in f32, from the same weights
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    ref = DenseNet(cfg.model, num_stages=1, fused_fn=fused_dense_block_fn_plain)
    ref.load_state_dict(state)
    ref.cuda().train()
    trainer.model.train()
    batches = [to_device(i, l, "cuda") for i, l in trainer.train_loader]
    images, labels = batches[0]
    got_loss, got = step_grads(trainer.model, images, labels, normalize)
    want_loss, want = step_grads(ref, images, labels, normalize_plain)
    stats_rel = max(
        ((a - b).abs().max() / b.abs().max()).item()
        for (name, a), b in zip(trainer.model.named_buffers(), ref.buffers())
        if "running" in name)
    f32 = DenseNet(dataclasses.replace(cfg.model, compute_dtype="float32"), num_stages=1,
                   fused_fn=fused_dense_block_fn_plain)
    f32.load_state_dict(state)
    _, exact = step_grads(f32.cuda().train(), images, labels, normalize_plain, torch.float32)
    del f32

    big = max(g.abs().max().item() for g in want.values())
    worst = sorted((((got[k] - want[k]).abs().max().item(), ((got[k] - want[k]).norm()
                     / want[k].norm()).item(), k) for k in want), reverse=True)
    loss_rel = abs(got_loss - want_loss) / abs(want_loss)
    kernel_l2, plain_l2 = l2_diff(got, exact), l2_diff(want, exact)
    print(f"train step kernel vs plain path: loss {got_loss:.6f} vs {want_loss:.6f} "
          f"(rel {loss_rel:.2e}, tol {STEP_LOSS_TOL}); kernel vs plain relative L2 "
          f"{l2_diff(got, want):.2e}; vs the f32 gradient: kernel path {kernel_l2:.2e}, plain "
          f"path {plain_l2:.2e} (ratio {kernel_l2 / plain_l2:.3f}, tol {STEP_GRAD_RATIO})")
    for err, rel_l2, k in worst[:5]:
        print(f"  grad {k}: max |diff| {err:.3e} = {err / big:.4f} of the largest gradient "
              f"(tol {STEP_GRAD_TOL}); leaf relative L2 kernel vs plain {rel_l2:.2e}, vs f32: "
              f"kernel {l2_diff({k: got[k]}, {k: exact[k]}):.2e}, "
              f"plain {l2_diff({k: want[k]}, {k: exact[k]}):.2e}")
    print(f"  running statistics after the step: max rel diff {stats_rel:.2e} "
          f"(tol {STEP_STATS_TOL})")
    require(loss_rel <= STEP_LOSS_TOL, f"train-step loss within {STEP_LOSS_TOL}")
    require(worst[0][0] <= STEP_GRAD_TOL * big,
            f"every gradient within {STEP_GRAD_TOL} of the largest gradient")
    require(kernel_l2 <= STEP_GRAD_RATIO * plain_l2,
            f"kernel path within {STEP_GRAD_RATIO}x the plain path's distance to f32")
    require(stats_rel <= STEP_STATS_TOL, f"running statistics within {STEP_STATS_TOL}")

    step_ms, step_wall, kernels = measure(lambda b: trainer.train_step(*b), batches, iters=10)
    print(f"train step on {card['name']} ({smi()}), device-resident batches of {EVAL_BATCH}: "
          f"{step_wall:.3f} ms wall (CUDA events), {1e3 / step_wall:.2f} steps/s, "
          f"{EVAL_BATCH / step_wall * 1e3:.1f} images/s; device busy {step_ms:.3f} ms "
          f"({step_ms / step_wall:.1%} of the step), {len(kernels)} distinct kernels")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    for name, k_ms in top:
        print(f"  {k_ms:8.4f} ms/step  {k_ms / step_ms:6.1%}  {name[:90]}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = setup()
    rng = np.random.default_rng(SEED)
    rows = [check_normalize(card, rng), check_fused_block(card, rng),
            check_fused_block_bwd(card, rng)]
    eval_launches = run_slice(card)
    launches = run_train_slice(card)
    print(f"launches: eval slice {eval_launches}, train slice {launches}")
    for row in rows:
        row["launches"] = launches[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi())
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
