"""LM training throughput on one GPU (counterpart of ``ddl_tpu/bench/lm.py``).

    python -m ddl_tpu_torch.bench.lm                 # the 124M LM, T=1024, batch 8
    python -m ddl_tpu_torch.bench.lm --seq-len 2048 --batch 4 --flash
    python -m ddl_tpu_torch.bench.lm --batch 16 --experts 8 --d-ff 1536 --flash
    python -m ddl_tpu_torch.bench.lm --flash --ce-chunk 256

Steady-state timing of the full train step (forward, backward, AdamW):
three warm-up steps, then ``--iters`` steps between two
``torch.cuda.synchronize()`` calls.  Prints one JSON line: ms_per_step,
tokens_per_sec, the flash path actually taken, the remat policy, the loss
edge (``ce_chunk``, ``ce_vocab_chunk``), the last loss and the device
memory peak; with ``--experts``, the resolved ``moe_dispatch`` and
``moe_group`` and the last step's router metrics.  The flags are the JAX
bench's; MFU waits for the port of ``bench/mfu.py`` (ROADMAP item 13).
``--device`` (default ``cuda``) is the port's own flag: ``--device cpu``
exists for the CPU smoke test, whose times mean nothing.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ddl_tpu_torch.models.transformer import REMAT_POLICIES, LMConfig, moe_routing_plan
from ddl_tpu_torch.parallel.sharding import LMMeshSpec, normalize_flash
from ddl_tpu_torch.train.lm_steps import make_lm_step_fns
from ddl_tpu_torch.train.state import Optimizer
from ddl_tpu_torch.utils.device import resolve_device

__all__ = ["bench_lm", "lm_bench_config", "main"]


def lm_bench_config(vocab: int = 50304, d_model: int = 768, layers: int = 12,
                    kv_heads: int = 0, attn_window: int = 0, d_ff: int = 0,
                    flash="off", remat_policy: str = "full", no_remat: bool = False,
                    experts: int = 0, expert_top_k: int = 2, capacity_factor: float = 1.5,
                    moe_dispatch: str = "auto", moe_group: int = 256, ce_chunk: int = 0,
                    ce_vocab_chunk: int = 0) -> LMConfig:
    """The bench's ``LMConfig``: heads of 64, bf16, the 124M model at the
    defaults (``ddl_tpu/bench/lm.py:79-99``)."""
    return LMConfig(
        vocab_size=vocab, d_model=d_model, n_layers=layers, n_heads=d_model // 64,
        n_kv_heads=kv_heads, attn_window=attn_window, head_dim=64, d_ff=d_ff or 4 * d_model,
        num_experts=experts, expert_top_k=expert_top_k, capacity_factor=capacity_factor,
        moe_dispatch=moe_dispatch, moe_group=moe_group, compute_dtype="bfloat16",
        flash={"on": True, "off": False, "auto": "auto"}[flash] if isinstance(flash, str)
        else flash,
        remat=not no_remat, remat_policy=remat_policy, ce_chunk=ce_chunk,
        ce_vocab_chunk=ce_vocab_chunk,
    )


def bench_lm(cfg: LMConfig, batch: int, seq_len: int, iters: int = 10, seed: int = 0,
             device=None) -> dict:
    """Time ``iters`` train steps of ``cfg`` after three warm-up steps, on
    random tokens from ``seed``, with ``optax.adamw(3e-4)``'s update
    (``Optimizer(..., weight_decay=1e-4)``).  On the card the numbers are
    walls between synchronisations and the memory peak is
    ``max_memory_allocated`` over the timed steps; on the CPU (the smoke
    test) there is no peak."""
    device = resolve_device(device)
    cfg = normalize_flash(cfg, LMMeshSpec(), seq_len, device.type)
    fns = make_lm_step_fns(cfg, LMMeshSpec(), lambda p: Optimizer(p, 3e-4, weight_decay=1e-4),
                           seed, batch, seq_len, device=device)
    cuda = fns.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(fns.device)

    state = fns.init_state()
    toks = torch.from_numpy(
        np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq_len + 1))
    ).to(fns.device)
    inp, tgt = toks[:, :-1], toks[:, 1:]
    for _ in range(3):
        state, m = fns.train(state, inp, tgt)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(fns.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, m = fns.train(state, inp, tgt)
    sync()
    dt = (time.perf_counter() - t0) / iters
    out = {
        "ms_per_step": dt * 1e3,
        "tokens_per_sec": batch * seq_len / dt,
        "seq_len": seq_len,
        "batch": batch,
        "flash": bool(cfg.flash),  # the path auto actually picked
        "remat": cfg.remat_policy if cfg.remat else "off",
        "ce_chunk": cfg.ce_chunk,
        "ce_vocab_chunk": cfg.ce_vocab_chunk,
        "loss": float(m["loss"]),
    }
    if cfg.num_experts:
        out["experts"] = f"{cfg.num_experts}top{cfg.expert_top_k}"
        out["d_ff"] = cfg.d_ff
        out["capacity_factor"] = cfg.capacity_factor
        # what the model resolved, not what was asked for
        out["moe_dispatch"], out["moe_group"] = moe_routing_plan(cfg, seq_len)
        for key in ("moe_drop_frac", "moe_load_max", "moe_load_min"):
            out[key] = float(m[key])
    if cuda:
        out["hbm_peak_bytes"] = torch.cuda.max_memory_allocated(fns.device)
    out["device"] = torch.cuda.get_device_name(fns.device) if cuda else "cpu"
    return out


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
                    help="vocab-streamed head+CE block size (0 = off)")
    ap.add_argument("--ce-chunk", type=int, default=0,
                    help="token-chunked head+CE chunk size (0 = dense CE)")
    ap.add_argument("--experts", type=int, default=0,
                    help="MoE experts per block (0 = dense MLP)")
    ap.add_argument("--expert-top-k", type=int, default=2)
    ap.add_argument("--capacity-factor", type=float, default=1.5)
    ap.add_argument("--moe-dispatch", default="auto", choices=["auto", "sort", "einsum"])
    ap.add_argument("--moe-group", type=int, default=256,
                    help="routing-group size in tokens (0 = the whole sequence)")
    ap.add_argument("--d-ff", type=int, default=0,
                    help="MLP/expert hidden size (0 = 4*d_model)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = lm_bench_config(args.vocab, args.d_model, args.layers, args.kv_heads,
                          args.attn_window, args.d_ff, args.flash, args.remat_policy,
                          args.no_remat, args.experts, args.expert_top_k,
                          args.capacity_factor, args.moe_dispatch, args.moe_group,
                          args.ce_chunk, args.ce_vocab_chunk)
    out = bench_lm(cfg, args.batch, args.seq_len, args.iters, device=args.device)
    out["flash_mode"] = args.flash
    print(json.dumps(out))


if __name__ == "__main__":
    main()
