"""LM training throughput on one GPU (counterpart of ``ddl_tpu/bench/lm.py``).

    python -m ddl_tpu_torch.bench.lm                 # the 124M LM, T=1024, batch 8
    python -m ddl_tpu_torch.bench.lm --seq-len 2048 --batch 4 --flash

Steady-state timing of the full train step (forward, backward, AdamW) on
the card: three warm-up steps, then ``--iters`` steps between two
``torch.cuda.synchronize()`` calls.  Prints one JSON line: ms_per_step,
tokens_per_sec, the flash path actually taken, the remat policy, the last
loss and the device memory peak.  The flags are the JAX bench's; the MoE
and chunked-CE ones raise (those paths are not ported), and MFU waits for
the port of ``bench/mfu.py`` (ROADMAP item 13).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ddl_tpu_torch.models.transformer import REMAT_POLICIES, LMConfig
from ddl_tpu_torch.parallel.sharding import LMMeshSpec, normalize_flash
from ddl_tpu_torch.train.lm_steps import make_lm_step_fns
from ddl_tpu_torch.train.state import Optimizer
from ddl_tpu_torch.utils.device import resolve_device

__all__ = ["bench_lm", "lm_bench_config", "main"]


def lm_bench_config(vocab: int = 50304, d_model: int = 768, layers: int = 12,
                    kv_heads: int = 0, attn_window: int = 0, d_ff: int = 0,
                    flash="off", remat_policy: str = "full", no_remat: bool = False) -> LMConfig:
    """The bench's ``LMConfig``: heads of 64, bf16, the 124M model at the
    defaults (``ddl_tpu/bench/lm.py:79-99``)."""
    return LMConfig(
        vocab_size=vocab, d_model=d_model, n_layers=layers, n_heads=d_model // 64,
        n_kv_heads=kv_heads, attn_window=attn_window, head_dim=64, d_ff=d_ff or 4 * d_model,
        compute_dtype="bfloat16",
        flash={"on": True, "off": False, "auto": "auto"}[flash] if isinstance(flash, str)
        else flash,
        remat=not no_remat, remat_policy=remat_policy,
    )


def bench_lm(cfg: LMConfig, batch: int, seq_len: int, iters: int = 10, seed: int = 0,
             device=None) -> dict:
    """Time ``iters`` train steps of ``cfg`` after three warm-up steps, on
    random tokens from ``seed``, with ``optax.adamw(3e-4)``'s update
    (``Optimizer(..., weight_decay=1e-4)``).  The card only: the numbers
    are device walls between synchronisations."""
    device = resolve_device(device)
    cfg = normalize_flash(cfg, LMMeshSpec(), seq_len, device.type)
    fns = make_lm_step_fns(cfg, LMMeshSpec(), lambda p: Optimizer(p, 3e-4, weight_decay=1e-4),
                           seed, batch, seq_len, device=device)
    if fns.device.type != "cuda":
        raise RuntimeError("bench_lm times the card; it needs a CUDA device")
    state = fns.init_state()
    toks = torch.from_numpy(
        np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq_len + 1))
    ).to(fns.device)
    inp, tgt = toks[:, :-1], toks[:, 1:]
    for _ in range(3):
        state, m = fns.train(state, inp, tgt)
    torch.cuda.synchronize(fns.device)
    torch.cuda.reset_peak_memory_stats(fns.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, m = fns.train(state, inp, tgt)
    torch.cuda.synchronize(fns.device)
    dt = (time.perf_counter() - t0) / iters
    return {
        "ms_per_step": dt * 1e3,
        "tokens_per_sec": batch * seq_len / dt,
        "seq_len": seq_len,
        "batch": batch,
        "flash": bool(cfg.flash),  # the path auto actually picked
        "remat": cfg.remat_policy if cfg.remat else "off",
        "loss": float(m["loss"]),
        "hbm_peak_bytes": torch.cuda.max_memory_allocated(fns.device),
        "device": torch.cuda.get_device_name(fns.device),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--kv-heads", type=int, default=0,
                    help="grouped-query attention K/V head count (0 = MHA)")
    ap.add_argument("--attn-window", type=int, default=0,
                    help="sliding-window attention size (0 = full causal)")
    ap.add_argument("--vocab", type=int, default=50304)
    ap.add_argument("--flash", nargs="?", const="on", default="off",
                    choices=["on", "off", "auto"])
    ap.add_argument("--remat-policy", default="full", choices=list(REMAT_POLICIES),
                    help="what the per-block checkpoint may save instead of recomputing")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--ce-vocab-chunk", type=int, default=0,
                    help="not ported (ROADMAP item 15): must stay 0")
    ap.add_argument("--ce-chunk", type=int, default=0,
                    help="not ported (ROADMAP item 15): must stay 0")
    ap.add_argument("--experts", type=int, default=0,
                    help="not ported (ROADMAP item 14): must stay 0")
    ap.add_argument("--expert-top-k", type=int, default=2)
    ap.add_argument("--capacity-factor", type=float, default=1.5)
    ap.add_argument("--moe-dispatch", default="auto", choices=["auto", "sort", "einsum"])
    ap.add_argument("--moe-group", type=int, default=256)
    ap.add_argument("--d-ff", type=int, default=0, help="MLP hidden size (0 = 4*d_model)")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if args.experts:
        raise NotImplementedError("--experts: mixture-of-experts is ROADMAP item 14")
    if args.ce_chunk or args.ce_vocab_chunk:
        raise NotImplementedError("--ce-chunk/--ce-vocab-chunk: the chunked CE losses are "
                                  "ROADMAP item 15")
    cfg = lm_bench_config(args.vocab, args.d_model, args.layers, args.kv_heads,
                          args.attn_window, args.d_ff, args.flash, args.remat_policy,
                          args.no_remat)
    out = bench_lm(cfg, args.batch, args.seq_len, args.iters)
    out["flash_mode"] = args.flash
    print(json.dumps(out))


if __name__ == "__main__":
    main()
