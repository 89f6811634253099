"""Generate from a transformer-LM training snapshot (KV-cached decode;
counterpart of ``examples/generate_lm.py``).

Companion to ``train_lm``: point it at the same ``--checkpoint-dir`` /
``--job-id`` and the same model flags, and it decodes from the saved
weights (``checkpoint.load_params``: the model only, the optimizer state
stays on disk):

    python -m ddl_tpu_torch.examples.train_lm --steps 200 \\
        --checkpoint-dir /tmp/ck --save-every 100
    python -m ddl_tpu_torch.examples.generate_lm --step 200 \\
        --checkpoint-dir /tmp/ck --max-new 64

The JAX script's flags, names and defaults, with ``--device`` in place of
``--cpu-devices``.  One device: ``--data`` or ``--model`` above 1 raises,
naming ROADMAP item 11; the per-request decode telemetry
(``--obs-log-dir``) is serving's, item 12.  ``--int8 kv+w`` decodes with
int8 weights and cache, whose products of at most 8 rows (``--batch``)
take the int8 small-M kernel.
"""

from __future__ import annotations

import argparse
from time import perf_counter

import numpy as np
import torch

from ddl_tpu_torch.examples.train_lm import require_one_device

__all__ = ["main"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint-dir", required=True)
    ap.add_argument("--job-id", default="lm")
    ap.add_argument("--step", type=int, required=True,
                    help="snapshot step to load")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1,
                    help="tensor-parallel axis for decode (ROADMAP item 11)")
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--kv-heads", type=int, default=0,
                    help="must match the training run's --kv-heads (GQA)")
    ap.add_argument("--attn-window", type=int, default=0,
                    help="must match the training run's --attn-window "
                    "(sliding-window decode reads an O(window) cache slice)")
    ap.add_argument("--experts", type=int, default=0)
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--prompt-text", default=None,
                    help="byte-level text prompt (e.g. for --corpus-trained models); "
                    "output is decoded as text")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--top-k", type=int, default=None,
                    help="restrict sampling to the k most likely tokens")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--int8", default="none", choices=["none", "kv", "kv+w"],
                    help="int8 serving quantization (ops/quant.py): 'kv' stores the KV "
                    "cache int8 (+per-token scales), 'kv+w' also int8 weights")
    ap.add_argument("--obs-log-dir", default=None,
                    help="per-request decode telemetry (ROADMAP item 12: serving)")
    ap.add_argument("--requests", type=int, default=1,
                    help="decode the prompt batch this many times")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    require_one_device(args)
    if args.obs_log_dir:
        raise NotImplementedError(
            "--obs-log-dir: the decode telemetry is not ported yet (ROADMAP item 12)")

    from ddl_tpu_torch.checkpoint import load_params, require_one_device_layout
    from ddl_tpu_torch.infer import make_lm_generator
    from ddl_tpu_torch.models.transformer import LMConfig
    from ddl_tpu_torch.ops.quant import quantize_lm_params
    from ddl_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = LMConfig(
        vocab_size=256,
        d_model=args.d_model,
        n_layers=args.layers,
        n_heads=8,
        n_kv_heads=args.kv_heads,
        attn_window=args.attn_window,
        head_dim=args.d_model // 8,
        d_ff=4 * args.d_model,
        num_experts=args.experts,
        compute_dtype="bfloat16" if device.type != "cpu" else "float32",
        fsdp=args.fsdp,
    )
    params = load_params(args.checkpoint_dir, args.job_id, args.step,
                         vocab_size=cfg.vocab_size)
    require_one_device_layout(params, "generate_lm")
    params = {k: v.to(device) for k, v in params.items()}
    print(f"loaded step {args.step}")
    if args.int8 == "kv+w":
        params = quantize_lm_params(params)
    gen = make_lm_generator(
        cfg,
        prompt_len=args.prompt_len,
        max_new=args.max_new,
        batch=args.batch,
        temperature=args.temperature,
        top_k=args.top_k,
        kv_quant=args.int8 != "none",
        device=device,
    )

    def generator():
        return torch.Generator(device).manual_seed(args.seed)

    if args.prompt_text is not None:
        enc = args.prompt_text.encode()
        if len(enc) > args.prompt_len:
            print(f"note: keeping the LAST {args.prompt_len} of {len(enc)} prompt bytes "
                  "(raise --prompt-len to keep all)")
        raw = enc[-args.prompt_len:]  # trailing bytes = continuation context
        raw = raw.rjust(args.prompt_len, b" ")  # left-pad to the fixed shape
        prompts = np.tile(np.frombuffer(raw, np.uint8).astype(np.int64), (args.batch, 1))
        toks = gen(params, torch.from_numpy(prompts), generator()).cpu().numpy()
        for b in range(args.batch):
            text = bytes(int(t) % 256 for t in toks[b]).decode(errors="replace")
            print(f"{raw.decode(errors='replace')!r} -> {text!r}")
        return

    # default: prompts drawn from the synthetic training stream's Markov
    # chain (the seed-0 chain train_lm trains on)
    from ddl_tpu_torch.data.synthetic_lm import MarkovChain

    chain = MarkovChain()
    prompts = chain.sample(np.random.default_rng(args.seed), args.batch, args.prompt_len)
    prompt_t = torch.from_numpy(prompts.astype(np.int64))
    for _ in range(max(0, args.requests - 1)):
        gen(params, prompt_t, generator())  # warm requests
    t0 = perf_counter()
    toks = gen(params, prompt_t, generator()).cpu().numpy()
    dt = perf_counter() - t0
    # score the continuations under the true chain: the fraction of steps
    # that follow a plausible (top-8) transition; random tokens score ~8/256
    follows = chain.on_chain_fraction(prompts, toks)
    for b in range(args.batch):
        print(f"prompt {prompts[b].tolist()} -> {toks[b].tolist()}")
    print(f"fraction of generated steps on a top-8 chain transition: {follows:.3f} "
          f"(random would be ~{8 / 256:.3f}); last request {dt:.3f} s")


if __name__ == "__main__":
    main()
