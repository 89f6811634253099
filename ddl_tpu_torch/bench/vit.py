"""ViT training throughput (counterpart of ``ddl_tpu/bench/vit.py``).

    python -m ddl_tpu_torch.bench.vit                 # ViT-S/16, 224px, batch 64
    python -m ddl_tpu_torch.bench.vit --no-remat
    python -m ddl_tpu_torch.bench.vit --data 4        # four ranks, one a card (NCCL)
    python -m ddl_tpu_torch.bench.vit --data 2 --pipe 2 --schedule 1f1b
    python -m ddl_tpu_torch.bench.vit --data 2 --model 2  # tensor parallelism in pairs

Steady-state timing of the whole train step (uint8 normalize, forward,
backward, AdamW 3e-4 with optax's weight decay 1e-4) on device-resident
batches, the DenseNet bench's data shapes: three warm-up steps, then
``--windows`` windows of ``--iters`` steps, each between two
``torch.cuda.synchronize()`` calls, and their median per step beside every
window's (the host's speed moves a step's wall between windows).  On the
card it also profiles one window (``torch.profiler``): the device-busy
time a step (the union of its kernels' intervals) and its share of the
wall, and the memory peak (``max_memory_allocated``).  One JSON line (rank
0's in a world).  ``--data``/``--pipe``/``--model`` start one rank per GPU
(``launch.run_as_world``), the batch the global one; ``--model`` splits
the encoder blocks' heads and MLP over its ranks.  MFU waits for the
port of ``bench/mfu.py`` (ROADMAP item 13).  ``--device cpu`` runs the
CPU smoke test, whose times mean nothing.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from ddl_tpu_torch.models.transformer import REMAT_POLICIES
from ddl_tpu_torch.models.vit import ViTConfig
from ddl_tpu_torch.parallel.sharding import LMMeshSpec
from ddl_tpu_torch.train.state import Optimizer
from ddl_tpu_torch.train.vit_steps import make_vit_step_fns

__all__ = ["bench_vit", "device_busy_ms", "main", "vit_bench_config"]


def vit_bench_config(image_size: int = 224, patch: int = 16, d_model: int = 384,
                     layers: int = 12, remat_policy: str = "full",
                     no_remat: bool = False) -> ViTConfig:
    """The bench's ``ViTConfig``: heads of 64, d_ff 4 x d_model, bf16 (ViT-S/16
    at the defaults)."""
    return ViTConfig(image_size=image_size, patch_size=patch, d_model=d_model, n_layers=layers,
                     n_heads=d_model // 64, head_dim=64, d_ff=4 * d_model,
                     compute_dtype="bfloat16", remat=not no_remat, remat_policy=remat_policy)


def device_busy_ms(prof) -> float:
    """Milliseconds in which at least one kernel or copy ran on the card:
    the union of the profiler's device intervals."""
    from torch.autograd import DeviceType

    from ddl_tpu_torch.bench.pp import _union_us

    return _union_us([(e.time_range.start, e.time_range.end) for e in prof.events()
                      if e.device_type == DeviceType.CUDA]) / 1e3


def bench_vit(cfg: ViTConfig, batch: int, iters: int = 30, windows: int = 5, seed: int = 0,
              device=None, spec: LMMeshSpec = LMMeshSpec(), mesh=None,
              num_microbatches: int = 0, schedule: str = "gpipe", virtual: int = 1) -> dict:
    """Time ``windows`` windows of ``iters`` train steps of ``cfg`` after
    three warm-up steps, on random uint8 images and labels from ``seed``
    (this rank's rows of the global ``batch``)."""
    fns = make_vit_step_fns(cfg, spec, lambda p: Optimizer(p, 3e-4, weight_decay=1e-4), seed,
                            batch, device=device, num_microbatches=num_microbatches,
                            pipeline_schedule=schedule, virtual_stages=virtual, mesh=mesh)
    mesh = fns.mesh
    cuda = mesh.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(mesh.device)

    rng = np.random.default_rng(seed)
    rows = slice(mesh.data_index * batch // spec.data, (mesh.data_index + 1) * batch // spec.data)
    images = torch.from_numpy(rng.integers(0, 256, (batch, cfg.image_size, cfg.image_size, 3),
                                           dtype=np.uint8))[rows].to(mesh.device)
    labels = torch.from_numpy(rng.integers(0, cfg.num_classes, batch))[rows].to(mesh.device)
    state = fns.init_state()
    for _ in range(3):
        state, m = fns.train(state, images, labels)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    walls = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            state, m = fns.train(state, images, labels)
        sync()
        walls.append((time.perf_counter() - t0) / iters * 1e3)
    ms = statistics.median(walls)
    out = {
        "ms_per_step": ms,
        "images_per_sec": batch / ms * 1e3,
        "ms_windows": walls,
        "batch": batch,
        "remat": cfg.remat_policy if cfg.remat else "off",
        "loss": float(m["loss"]),
        "data": spec.data,
        "pipe": spec.pipe,
        "model": spec.model,
    }
    if spec.pipe > 1:
        out.update(schedule=schedule, microbatches=num_microbatches or spec.pipe,
                   virtual=virtual)
    if cuda:
        from torch.profiler import ProfilerActivity, profile

        out["hbm_peak_bytes"] = torch.cuda.max_memory_allocated(mesh.device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                state, m = fns.train(state, images, labels)
            sync()
        out["device_busy_ms"] = device_busy_ms(prof) / iters
        out["busy_share"] = out["device_busy_ms"] / ms
    out["device"] = torch.cuda.get_device_name(mesh.device) if cuda else "cpu"
    return out


def main(argv=None) -> dict | None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--patch", type=int, default=16)
    ap.add_argument("--d-model", type=int, default=384)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--remat-policy", default="full", choices=list(REMAT_POLICIES))
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--windows", type=int, default=5,
                    help="timed windows of --iters steps; the median is reported")
    ap.add_argument("--data", type=int, default=1, help="data-parallel ranks")
    ap.add_argument("--pipe", type=int, default=1, help="pipeline stages")
    ap.add_argument("--model", type=int, default=1, help="tensor-parallel ranks")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="microbatches when --pipe > 1 (default: --pipe)")
    ap.add_argument("--schedule", default="gpipe", choices=["gpipe", "1f1b", "zb"])
    ap.add_argument("--virtual-stages", type=int, default=1)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)

    from ddl_tpu_torch import launch
    from ddl_tpu_torch.parallel.mesh import build_lm_mesh

    spec = LMMeshSpec(data=args.data, pipe=args.pipe, model=args.model)
    if launch.run_as_world("ddl_tpu_torch.bench.vit", argv, spec.num_devices,
                           args.device, 0, spec):
        return None
    launch.bootstrap(args.device)
    mesh = build_lm_mesh(spec, args.device)
    cfg = vit_bench_config(args.image_size, args.patch, args.d_model, args.layers,
                           args.remat_policy, args.no_remat)
    out = bench_vit(cfg, args.batch, args.iters, args.windows,
                    spec=spec, mesh=mesh,
                    num_microbatches=args.microbatches, schedule=args.schedule,
                    virtual=args.virtual_stages)
    if mesh.rank == 0:
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
