"""Train the transformer LM on synthetic byte sequences or a corpus
(counterpart of ``examples/train_lm.py``).

Argparse shim over ``ddl_tpu_torch.train.lm_trainer.LMTrainer`` (the
shared training loop: default-on CSV logging and event stream, NaN
policy, SIGTERM snapshot-and-exit, profiler hook, snapshots with exact
resume).  The JAX script's flags, names and defaults, with ``--device``
in place of ``--cpu-devices``:

    python -m ddl_tpu_torch.examples.train_lm --steps 100
    python -m ddl_tpu_torch.tools.repo_corpus --out /tmp/repo_corpus.txt
    python -m ddl_tpu_torch.examples.train_lm --corpus /tmp/repo_corpus.txt \\
        --eval-every 25 --checkpoint-dir /tmp/ck --save-every 50

A relaunch with the same ``--job-id`` and ``--checkpoint-dir`` resumes
from the newest valid snapshot (``--fresh`` starts over).  The port runs
on one device: a mesh flag above 1 (``--data``, ``--seq``, ``--model``,
``--expert-axis``, ``--pipe``, ``--microbatches``) raises, naming ROADMAP
item 11, and ``--zero`` item 9.  ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse

__all__ = ["main", "require_one_device"]


def require_one_device(args) -> None:
    """Refuse the mesh flags the port cannot run yet, before anything is
    built."""
    for flag in ("data", "seq", "model", "expert_axis", "pipe", "microbatches"):
        value = getattr(args, flag, None)
        if value is not None and value > 1:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} {value}: the port trains and decodes on one "
                "device; LM parallelism is ROADMAP item 11"
            )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--seq", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--expert-axis", type=int, default=1)
    ap.add_argument("--pipe", type=int, default=1,
                    help="pipeline stages over the decoder layers (ROADMAP item 11)")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="pipeline microbatches when --pipe > 1 (default: --pipe)")
    ap.add_argument("--pipeline-schedule", default="gpipe",
                    choices=["gpipe", "1f1b", "zb"],
                    help="pipeline schedule when --pipe > 1 (ROADMAP item 11)")
    ap.add_argument("--virtual-stages", type=int, default=1,
                    help="interleaved pipeline: layer chunks per device (ROADMAP item 11)")
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation chunks per step (pipe=1 only)")
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="residual dropout rate")
    ap.add_argument("--experts", type=int, default=0, help="0 = dense MLP")
    ap.add_argument("--capacity-factor", type=float, default=1.5,
                    help="MoE warm-up expert capacity (see LMConfig)")
    ap.add_argument("--capacity-factor-min", type=float, default=1.0,
                    help="post-warm-up capacity the trainer anneals to once the live "
                    "router drop fraction converges (= --capacity-factor disables the "
                    "anneal)")
    ap.add_argument("--capacity-anneal-step", type=int, default=0,
                    help="anneal at this step regardless of the metric")
    ap.add_argument("--moe-ep", default="auto",
                    choices=["auto", "gspmd", "alltoall"],
                    help="expert-parallel exchange (one device: the one-device dispatch)")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--attn", default=None, choices=["dense", "ring", "ulysses"],
                    help="attention impl (default: dense; ring and ulysses are "
                    "sequence parallelism, ROADMAP item 11)")
    ap.add_argument("--flash", nargs="?", const="on", default="off",
                    choices=["on", "off", "auto"],
                    help="the flash-attention kernels: '--flash' / '--flash on' forces "
                    "them, '--flash auto' picks per run from the seq-len crossover.  "
                    "The 8 query heads give head_dim d_model/8, and the kernels take "
                    "64 and 128: at --d-model 768 (head_dim 96) '--flash on' raises on "
                    "the card when the model is built, and '--flash auto' runs dense")
    ap.add_argument("--remat-policy", default="full",
                    help="per-block checkpoint policy (speed/memory dial; 'dots' keeps "
                    "matmul outputs)")
    ap.add_argument("--no-remat", action="store_true",
                    help="disable activation rematerialisation entirely")
    ap.add_argument("--corpus", default=None,
                    help="token .npy or raw text file to train on "
                    "(default: synthetic Markov-chain bytes)")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="with --corpus: evaluate held-out perplexity every N steps "
                    "(0 = off)")
    ap.add_argument("--eval-frac", type=float, default=0.05,
                    help="tail fraction of corpus windows held out for eval")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10,
                    help="console/CSV/obs period cadence in steps")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=0,
                    help="linear LR warmup steps")
    ap.add_argument("--cosine", action="store_true",
                    help="cosine-decay the LR to 0 over --steps")
    ap.add_argument("--weight-decay", type=float, default=0.0,
                    help=">0 switches to decoupled AdamW")
    ap.add_argument("--clip-norm", type=float, default=0.0,
                    help=">0 enables global-norm gradient clipping")
    ap.add_argument("--zero", action="store_true",
                    help="ZeRO-1 optimizer-state sharding over 'data' (ROADMAP item 9)")
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--kv-heads", type=int, default=0,
                    help="grouped-query attention: K/V head count (0 = same as query "
                    "heads; must divide the 8 query heads)")
    ap.add_argument("--attn-window", type=int, default=0,
                    help="sliding-window attention: each position attends only the last "
                    "N positions (0 = full causal history)")
    ap.add_argument("--ce-chunk", type=int, default=0,
                    help="chunked head+CE fusion: sequence-chunk size for the loss edge "
                    "(0 = dense CE)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the CPU)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save a snapshot every --save-every steps (and on held-out "
                    "perplexity improvements / SIGTERM preemption)")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--keep-snapshots", type=int, default=0,
                    help="snapshot GC: keep only the newest K valid snapshots (corrupt "
                    "ones never count; 0 = keep all)")
    ap.add_argument("--resume-step", type=int, default=None,
                    help="restore the snapshot saved at this step")
    ap.add_argument("--fresh", action="store_true",
                    help="start from scratch even if this job id already has snapshots "
                    "(auto-resume is the default: a relaunch with the same --job-id "
                    "continues from the latest one)")
    ap.add_argument("--job-id", default="lm")
    ap.add_argument("--log-dir", default="training_logs",
                    help="MetricLogger CSV suite and event stream directory; '' disables")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace of one post-warm-up step window "
                    "into this dir")
    ap.add_argument("--no-halt-on-nan", action="store_true",
                    help="keep training through non-finite losses")
    args = ap.parse_args(argv)

    require_one_device(args)
    if args.zero:
        raise NotImplementedError("--zero: ZeRO sharding is not ported yet (ROADMAP item 9)")

    from ddl_tpu_torch.models.transformer import REMAT_POLICIES, LMConfig
    from ddl_tpu_torch.parallel.sharding import LMMeshSpec
    from ddl_tpu_torch.train.lm_trainer import LMRunConfig, LMTrainer
    from ddl_tpu_torch.train.state import Optimizer
    from ddl_tpu_torch.utils.device import resolve_device

    if args.remat_policy not in REMAT_POLICIES:
        ap.error(f"--remat-policy must be one of {REMAT_POLICIES}")
    device = resolve_device(args.device)

    flash = {"on": True, "off": False, "auto": "auto"}[args.flash]
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
        capacity_factor=args.capacity_factor,
        capacity_factor_min=args.capacity_factor_min,
        capacity_anneal_step=args.capacity_anneal_step,
        moe_ep=args.moe_ep,
        compute_dtype="bfloat16" if device.type != "cpu" else "float32",
        attn_impl=args.attn or "dense",
        flash=flash,
        remat=not args.no_remat,
        remat_policy=args.remat_policy,
        fsdp=args.fsdp,
        dropout_rate=args.dropout,
        ce_chunk=args.ce_chunk,
    )
    spec = LMMeshSpec()

    def tx(params):
        # the JAX script's build_optimizer flags
        return Optimizer(
            params,
            args.lr,
            weight_decay=args.weight_decay,
            grad_clip_norm=args.clip_norm,
            lr_schedule="cosine" if args.cosine else "constant",
            warmup_steps=args.warmup,
            decay_steps=args.steps if args.cosine else 0,
        )

    run = LMRunConfig(
        batch=args.batch,
        seq_len=args.seq_len,
        steps=args.steps,
        log_every=args.log_every,
        num_microbatches=args.microbatches,
        accum_steps=args.accum,
        pipeline_schedule=args.pipeline_schedule,
        virtual_stages=args.virtual_stages,
        corpus=args.corpus,
        eval_every=args.eval_every,
        eval_frac=args.eval_frac,
        checkpoint_dir=args.checkpoint_dir,
        save_every=args.save_every,
        keep_snapshots=args.keep_snapshots,
        resume_step=args.resume_step,
        auto_resume=not args.fresh,
        job_id=args.job_id,
        log_dir=args.log_dir or None,
        halt_on_nan=not args.no_halt_on_nan,
        profile_dir=args.profile_dir,
    )
    trainer = LMTrainer(cfg, spec, tx, run, device=device)
    print(f"mesh={spec} experts={args.experts} fsdp={args.fsdp} device={device}")
    trainer.train()


if __name__ == "__main__":
    main()
