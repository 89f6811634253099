"""Autoregressive decode benchmark: prefill latency and steady-state tokens/s
(counterpart of ``ddl_tpu/bench/decode.py``).

    python -m ddl_tpu_torch.bench.decode                  # 124M, prompt 4k, cache 8k
    python -m ddl_tpu_torch.bench.decode --quant kv+w     # int8 weights and cache
    python -m ddl_tpu_torch.bench.decode --sweep          # MHA/GQA x full/window

The JAX bench's method and flags: prefill is a ``max_new=1`` run; the
decode rate is the wall-clock slope between ``max_new=n`` and ``2n`` runs,
all three at the same KV-cache capacity (``prompt + 2n``: without a window
every step reads the whole allocated cache, so per-step cost follows the
capacity), resampled once if the slope comes out non-positive.  Each run is
a whole ``make_lm_generator`` call between ``torch.cuda.synchronize()``
calls.  Weights are ``init_lm_weights(seed 0)`` (through
``quantize_lm_params`` for ``kv+w``), the prompt ``default_rng(0)``
tokens.  One JSON row per (batch, grid point, quant mode), with the JAX
bench's keys; an allocation failure is a row too (``"error": "hbm_oom"``).

``--device`` (default ``cuda``) is the port's own flag: on the card a
non-positive slope after the resample raises, as the JAX bench does on a
TPU; ``--device cpu`` exists for the CPU smoke test and quotes the
undifferenced rate (``slope_fallback``) when the slope is noise.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ddl_tpu_torch.infer.decode import init_kv_cache, make_lm_generator
from ddl_tpu_torch.models.transformer import LMConfig, TransformerLM, init_lm_weights
from ddl_tpu_torch.ops.quant import quantize_lm_params
from ddl_tpu_torch.utils.device import resolve_device

__all__ = ["bench_decode", "decode_bench_config", "main"]

QUANT_MODES = ("none", "kv", "kv+w")


def decode_bench_config(d_model: int = 768, layers: int = 12, vocab: int = 50304,
                        kv_heads: int = 0, window: int = 0) -> LMConfig:
    """The bench's ``LMConfig`` (``ddl_tpu/bench/decode.py:55-70``): heads of
    64, d_ff 4 x d_model, bf16, no remat, the flash prefill from the auto
    threshold up."""
    return LMConfig(
        vocab_size=vocab, d_model=d_model, n_layers=layers, n_heads=d_model // 64,
        n_kv_heads=kv_heads, attn_window=window, head_dim=64, d_ff=4 * d_model,
        compute_dtype="bfloat16", remat=False, flash="auto",
    )


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bench_decode(cfg: LMConfig, *, batch: int, prompt: int, new: int, iters: int = 3,
                 quant: str = "none", device=None) -> dict:
    """One row of the bench: ``cfg`` decoding ``batch`` prompts of
    ``prompt`` tokens, timed at ``new`` and ``2 * new`` greedy tokens."""
    if quant not in QUANT_MODES:
        raise ValueError(f"quant mode must be none|kv|kv+w, got {quant!r}")
    device = resolve_device(device)
    model = TransformerLM(cfg)
    init_lm_weights(model, 0)
    params = model.state_dict()
    del model
    if quant == "kv+w":
        params = quantize_lm_params(params)
    params = {k: v.to(device) for k, v in params.items()}
    kv_quant = quant != "none"
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (batch, prompt))).to(device)
    n1, n2 = new, 2 * new
    capacity = prompt + n2

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timed(max_new: int) -> float:
        gen = make_lm_generator(cfg, prompt_len=prompt, max_new=max_new, batch=batch,
                                max_len=capacity, kv_quant=kv_quant, device=device)
        gen(params, toks)  # warm-up: allocator, cuBLAS handles, kernel builds
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            gen(params, toks)
        sync()
        return (time.perf_counter() - t0) / iters

    t_pre, t1, t2 = timed(1), timed(n1), timed(n2)
    ms_per_tok = (t2 - t1) / (n2 - n1) * 1e3
    slope_fallback = False
    if ms_per_tok <= 0:  # a host-contention spike in one of the two runs
        t1, t2 = timed(n1), timed(n2)
        ms_per_tok = (t2 - t1) / (n2 - n1) * 1e3
    if ms_per_tok <= 0:
        if device.type == "cuda":
            raise RuntimeError(
                f"host contention: decode slope non-positive after resample "
                f"({ms_per_tok:.4f} ms/tok); rerun on a quieter machine"
            )
        ms_per_tok = t2 / n2 * 1e3
        slope_fallback = True
    window = cfg.attn_window
    rolling = bool(window) and window < capacity
    layer0 = init_kv_cache(cfg, batch, capacity, rolling=rolling, quant=kv_quant,
                           device="meta")[0]
    alloc = layer0[0].shape[1]
    layer_bytes = _nbytes(layer0)
    span = min(window, capacity) if window else capacity
    return {
        "heads": f"{cfg.n_heads}q/{cfg.kv_heads}kv",
        "window": window,
        "quant": quant,
        "prompt": prompt,
        "max_len": capacity,
        "batch": batch,
        "prefill_ms": round(t_pre * 1e3, 1),
        "decode_ms_per_tok": round(ms_per_tok, 3),
        **({"slope_fallback": True} if slope_fallback else {}),
        "decode_tok_per_sec": round(batch / (ms_per_tok / 1e3), 1),
        "cache_bytes_per_layer": layer_bytes,
        "read_bytes_per_step_layer": int(layer_bytes * span / max(alloc, 1)),
        "param_bytes": _nbytes(params.values()),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--prompt", type=int, default=4096)
    ap.add_argument("--new", type=int, default=2048,
                    help="decode lengths benched: --new and 2x --new (slope method); "
                    "max cache = prompt + 2x new")
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--vocab", type=int, default=50304)
    ap.add_argument("--kv-heads", type=int, default=0)
    ap.add_argument("--attn-window", type=int, default=0)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--sweep", action="store_true",
                    help="MHA vs GQA (the largest >=3x grouping the head count allows) x "
                    "full cache vs window 1024")
    ap.add_argument("--batches", default=None,
                    help="comma-separated batch sizes (e.g. 1,8,32), each crossed with the "
                    "config grid (overrides --batch)")
    ap.add_argument("--quant", default="none",
                    help="comma-separated quant modes crossed with the grid: none (bf16), kv "
                    "(int8 KV cache), kv+w (int8 cache and int8 weights)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default), or cpu for the CPU smoke test")
    args = ap.parse_args(argv)
    if args.iters < 1:
        ap.error("--iters must be >= 1")
    if args.new < 1:
        ap.error("--new must be >= 1 (decode lengths benched are --new and 2x --new)")
    if args.sweep:
        if args.kv_heads or args.attn_window:
            ap.error("--sweep supplies its own grid; drop --kv-heads/--attn-window")
        n_heads = args.d_model // 64
        kv = next((n_heads // g for g in (3, 4, 2) if n_heads % g == 0), 0)
        if not kv:
            ap.error(f"--sweep needs a groupable head count, got {n_heads}")
        grid = [(0, 0), (kv, 0), (0, 1024), (kv, 1024)]
    else:
        grid = [(args.kv_heads, args.attn_window)]
    batches = [int(x) for x in args.batches.split(",")] if args.batches else [args.batch]
    quants = [q.strip() for q in args.quant.split(",")]
    bad = [q for q in quants if q not in QUANT_MODES]
    if bad:
        ap.error(f"--quant modes must be none|kv|kv+w, got {bad}")
    for b in batches:
        for kv, win in grid:
            for qm in quants:
                cfg = decode_bench_config(args.d_model, args.layers, args.vocab, kv, win)
                try:
                    row = bench_decode(cfg, batch=b, prompt=args.prompt, new=args.new,
                                       iters=args.iters, quant=qm, device=args.device)
                except torch.cuda.OutOfMemoryError:
                    # a row, not a crash: which configurations fit is the result
                    row = {"heads": f"{cfg.n_heads}q/{cfg.kv_heads}kv", "window": win,
                           "quant": qm, "batch": b, "error": "hbm_oom"}
                    torch.cuda.empty_cache()
                print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
