"""Quality bound for the int8 serving path: what does quantization cost?
(counterpart of ``ddl_tpu/bench/decode_quality.py``)

The int8 levers (``ops/quant.py``) halve decode memory traffic; this tool
pins what they cost in output quality, on REAL trained weights (any
``ddl_tpu_torch.examples.train_lm`` snapshot and its corpus):

1. **Held-out ppl delta** (weight-only int8): teacher-forced CE over the
   corpus's held-out tail through the eval step (``make_lm_step_fns``),
   f32 masters (computing in bf16 on the card) vs ``quantize_lm_params``
   -- the weight-quant quality bound.  Its products have batch x seq rows,
   so the int8 weights take the widening path, not the small-M kernel.
2. **Greedy token agreement** (KV + weight int8): greedy generations from
   held-out prompts, the bf16-cache generator vs ``kv`` vs ``kv+w`` --
   position-wise token match rate, plus the first divergence.  (Greedy
   decode amplifies near-ties; agreement is the *strict* bound -- a
   disagreement is usually an equally likely token, not an error.)  The
   generators run the decode kernels, and with ``kv+w`` and at most 8
   rows (``--batch 8``) the int8 small-M matmul.

Prints one JSON line per mode, with the JAX tool's keys.

    python -m ddl_tpu_torch.bench.decode_quality --checkpoint-dir ck --step N \\
        --corpus corpus.npy --d-model 512 --layers 8

``--device`` (default: the card) replaces the JAX tool's
``--cpu-devices``; ``--device cpu`` runs the CPU tests, where every
kernel wrapper takes its plain version.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ddl_tpu_torch.checkpoint import load_params, require_one_device_layout
from ddl_tpu_torch.data.lm_corpus import TokenCorpus
from ddl_tpu_torch.infer import make_lm_generator
from ddl_tpu_torch.models.transformer import LMConfig, TransformerLM
from ddl_tpu_torch.ops.quant import quantize_lm_params
from ddl_tpu_torch.parallel.sharding import LMMeshSpec
from ddl_tpu_torch.train.lm_steps import LMTrainState, make_lm_step_fns
from ddl_tpu_torch.train.state import Optimizer
from ddl_tpu_torch.utils.device import resolve_device

__all__ = ["main"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint-dir", required=True)
    ap.add_argument("--job-id", default="lm")
    ap.add_argument("--step", type=int, required=True)
    ap.add_argument("--corpus", required=True, help="token .npy (byte-level)")
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=0)
    ap.add_argument("--attn-window", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--seq-len", type=int, default=256,
                    help="eval window length (must match training windows)")
    ap.add_argument("--eval-frac", type=float, default=0.05)
    ap.add_argument("--eval-batches", type=int, default=8)
    ap.add_argument("--batch", type=int, default=16,
                    help="eval and generation batch; at most 8 lets the int8 weights' "
                    "decode products take the small-M kernel")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=128)
    ap.add_argument("--gen-batches", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the CPU tests)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = LMConfig(
        vocab_size=args.vocab,
        d_model=args.d_model,
        n_layers=args.layers,
        n_heads=args.heads,
        n_kv_heads=args.kv_heads,
        attn_window=args.attn_window,
        head_dim=args.d_model // args.heads,
        d_ff=4 * args.d_model,
        compute_dtype="bfloat16" if device.type != "cpu" else "float32",
        remat=False,
    )
    spec = LMMeshSpec()
    # params-only restore: any optimizer the training run used is
    # irrelevant here; vocab_size resolves a format-less snapshot's
    # lm_head orientation
    params = load_params(args.checkpoint_dir, args.job_id, args.step, vocab_size=cfg.vocab_size)
    require_one_device_layout(params, "decode_quality")
    params = {k: v.to(device) for k, v in params.items()}
    qparams = quantize_lm_params(params)

    # --- held-out ppl: exact vs weight-only int8 -------------------------
    corpus = TokenCorpus(args.corpus, args.seq_len)
    _, eval_view = corpus.split(args.eval_frac)
    fns = make_lm_step_fns(cfg, spec, lambda p: Optimizer(p, 1e-3), 0, args.batch,
                           args.seq_len, device=device)
    n_eval = min(args.eval_batches, len(eval_view) // args.batch)
    if n_eval < 1:
        raise SystemExit(
            f"held-out split has {len(eval_view)} windows < one batch of "
            f"{args.batch}; grow --eval-frac or shrink --batch"
        )

    def windows(bi: int, part: int, length: int | None = None) -> torch.Tensor:
        idx = range(bi * args.batch, (bi + 1) * args.batch)
        rows = np.stack([eval_view[i][part][:length] for i in idx])
        return torch.from_numpy(rows.astype(np.int64)).to(device)

    def heldout_ce(p) -> float:
        # evaluate only reads the model; no optimizer is built
        with torch.device("meta"):
            model = TransformerLM(cfg)
        model.load_state_dict(p, assign=True)
        st = LMTrainState(step=0, model=model, optimizer=None)
        ces = [float(fns.evaluate(st, windows(bi, 0), windows(bi, 1))["ce"])
               for bi in range(n_eval)]
        return float(np.mean(ces))

    ce_ref = heldout_ce(params)
    ce_q = heldout_ce(qparams)
    print(json.dumps({
        "metric": "heldout_ppl",
        "exact": round(float(np.exp(ce_ref)), 4),
        "int8_weights": round(float(np.exp(ce_q)), 4),
        "ppl_delta_pct": round(100 * (np.exp(ce_q) / np.exp(ce_ref) - 1), 3),
        "eval_tokens": n_eval * args.batch * args.seq_len,
    }), flush=True)

    # --- greedy agreement: bf16 vs kv vs kv+w ----------------------------
    gen_kw = dict(prompt_len=args.prompt_len, max_new=args.max_new, batch=args.batch,
                  device=device)
    gen_exact = make_lm_generator(cfg, **gen_kw)
    gen_kvq = make_lm_generator(cfg, **gen_kw, kv_quant=True)
    gens = {
        "none": (gen_exact, params),
        "kv": (gen_kvq, params),
        # weight quant needs no generator flag: the int8 dict loads as
        # QDense/LMHead int8 kernels with their scales
        "kv+w": (gen_kvq, qparams),
    }
    outs = {k: [] for k in gens}
    gen_batches = min(args.gen_batches, len(eval_view) // args.batch)
    for bi in range(gen_batches):
        prompts = windows(bi, 0, args.prompt_len)
        for k, (g, p) in gens.items():
            outs[k].append(g(p, prompts).cpu().numpy())
    ref = np.concatenate(outs["none"])
    for k in ("kv", "kv+w"):
        got = np.concatenate(outs[k])
        match = (got == ref).mean()
        # first divergence per sequence (max_new = fully agreed)
        div = np.where((got != ref).any(1), (got != ref).argmax(1), args.max_new)
        print(json.dumps({
            "metric": "greedy_agreement",
            "quant": k,
            "token_match_rate": round(float(match), 4),
            "sequences": int(ref.shape[0]),
            "max_new": args.max_new,
            "median_first_divergence": int(np.median(div)),
            "fully_agreed_frac": round(float((div == args.max_new).mean()), 4),
        }), flush=True)


if __name__ == "__main__":
    main()
