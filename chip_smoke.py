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
3. Slice: ``Trainer(cfg).evaluate(0)`` on DenseNet121 at full width with
   the fused configuration (bf16, fused blocks 1 and 4, kernel normalize)
   over a synthetic eval set whose last batch is sentinel-padded.  The
   launch counters are zeroed just before and read just after this run;
   the logits are then held against the same model run through the plain
   versions on the card.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
from ddl_tpu_torch.ops.fused_dense_block import (  # noqa: E402
    fused_dense_block,
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


def run_slice(card: dict) -> dict:
    cfg = preset("single", **{
        "model.compute_dtype": "bfloat16", "model.dense_block_impl": "fused",
        "model.dense_block_fused_blocks": (0, 3), "model.pallas_normalize": True,
        "data.dataset_dir": "", "data.synthetic_num_test": EVAL_SET,
        "data.eval_batch_size": EVAL_BATCH, "train.seed": SEED,
    })
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = setup()
    rng = np.random.default_rng(SEED)
    rows = [check_normalize(card, rng), check_fused_block(card, rng)]
    launches = run_slice(card)
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
