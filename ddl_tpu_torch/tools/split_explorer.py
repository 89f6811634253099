"""Pipeline split-point explorer (the reference ``debug.py`` analog; port of
``ddl_tpu/tools/split_explorer.py``).

The reference explored candidate FX split specs offline, printing
per-stage parameter counts and recording which splits failed: mid-block
cuts break on DenseNet's concatenative skip connections
(``debug.py:9-18``), and a 4-stage split made the epoch slower
(``debug.py:20-29``).  Here splits are constructive (block boundaries
only, so that failure cannot occur) and the explorer reports, for every
legal ``split_blocks`` at a given stage count: each stage's parameter
count, its forward FLOPs at batch 1 (the quantity that balances a
pipeline: DenseNet's late blocks hold most parameters, its early blocks
at high resolution most FLOPs), and the bytes of the boundary activation
each cut hands on per microbatch in bf16.  The FLOPs are those
``torch.utils.flop_counter.FlopCounterMode`` counts for each stage
module's eval forward on the CPU (the convolutions and the classifier's
matmul; the JAX tool takes XLA's cost analysis, which also counts the
elementwise work).

    python -m ddl_tpu_torch.tools.split_explorer --stages 2 --image-size 224
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools

import torch
from torch.utils.flop_counter import FlopCounterMode

from ddl_tpu_torch.config import ModelConfig
from ddl_tpu_torch.models.densenet import DenseNet, build_stage_specs, stage_boundary_shapes

__all__ = ["explore", "main"]


def _stage_costs(cfg: ModelConfig, image_size: int) -> list[tuple[int, float]]:
    """Per-stage (parameters, forward FLOPs at batch 1), each stage fed the
    previous one's output."""
    out = []
    x = torch.zeros(1, image_size, image_size, 3)
    for i in range(len(build_stage_specs(cfg))):
        stage = DenseNet(cfg, stage=i).eval()
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            x = stage(x)
        out.append((sum(p.numel() for p in stage.parameters()),
                    float(counter.get_total_flops())))
    return out


def explore(num_stages: int, image_size: int, microbatch: int,
            cfg: ModelConfig | None = None) -> list[dict]:
    """One row per legal ``split_blocks`` of ``num_stages`` stages."""
    base = cfg or ModelConfig()
    rows = []
    for splits in itertools.combinations(range(1, len(base.block_config)), num_stages - 1):
        c = dataclasses.replace(base, split_blocks=splits, compute_dtype="float32",
                                dense_block_impl="packed")
        costs = _stage_costs(c, image_size)
        rows.append({
            "split_blocks": splits,
            "stage_params": [p for p, _ in costs],
            "stage_flops": [f for _, f in costs],
            "boundary_bytes_per_microbatch": [
                microbatch * h * w * ch * 2 for (h, w, ch) in stage_boundary_shapes(c, image_size)
            ],
        })
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description="DenseNet pipeline split explorer")
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--microbatch", type=int, default=6)
    args = ap.parse_args(argv)
    rows = explore(args.stages, args.image_size, args.microbatch)
    for r in rows:
        flops = r["stage_flops"]
        balance = max(flops) / (sum(flops) / len(flops))
        print(
            f"split_blocks={r['split_blocks']}: params={r['stage_params']} "
            f"flops={[f'{f:.3g}' for f in flops]} "
            f"flop_imbalance={balance:.2f} "
            f"boundary_bytes/mb={r['boundary_bytes_per_microbatch']}"
        )
    return rows


if __name__ == "__main__":
    main()
