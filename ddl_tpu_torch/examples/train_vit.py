"""Train the ViT family on the APTOS-shape image data path (counterpart of
``examples/train_vit.py``).

Argparse shim over ``ddl_tpu_torch.train.vit_trainer.ViTTrainer`` (the
shared training loop: default-on CSV logging and event stream, NaN
policy, QWK-gated snapshots, SIGTERM snapshot-and-exit, profiler hook).
The JAX script's flags, names and defaults, plus ``--device``:

    python -m ddl_tpu_torch.examples.train_vit --device cpu --image-size 32 \\
        --patch 8 --d-model 64 --layers 2 --epochs 2
    python -m ddl_tpu_torch.examples.train_vit --cpu-devices 2 --pipe 2 \\
        --pipeline-schedule zb --image-size 32 --patch 8 --d-model 64 --layers 2
    python -m ddl_tpu_torch.examples.train_vit --data 2 --pipe 2   # four GPUs

    python -m ddl_tpu_torch.examples.train_vit --cpu-devices 2 --model 2 \
        --image-size 32 --patch 8 --d-model 128 --layers 2

``--data``/``--pipe``/``--model`` above 1 start one rank per GPU
(``launch.run_as_world``, as the DenseNet command line does; ``--data``
x ``--pipe`` x ``--model`` ranks), ``--cpu-devices N`` that many gloo
ranks on the CPU; ``--model`` splits the encoder blocks' heads and MLP
over its ranks (tensor parallelism).  ``--fsdp`` with ``--data`` above 1
raises (ROADMAP item 11b, FSDP).  bf16 on the card, f32 on the CPU (the
JAX script picks by backend).  The synthetic APTOS-shape set is used when
``DDL_DATASET_DIR`` is unset; point it at the real data for the 224px task.
A relaunch with the same ``--job-id`` resumes from the newest valid
snapshot (``--fresh`` starts over).
"""

from __future__ import annotations

import argparse
import sys

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--pipe", type=int, default=1,
                    help="pipeline stages over the encoder blocks")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="microbatches when --pipe > 1 (default: --pipe)")
    ap.add_argument("--pipeline-schedule", default="gpipe",
                    choices=["gpipe", "1f1b", "zb"],
                    help="pipeline schedule when --pipe > 1 (1f1b: interleaved, O(pipe) "
                    "stage-activation residency; zb: zero-bubble B/W-split 1f1b, "
                    "--virtual-stages 1)")
    ap.add_argument("--virtual-stages", type=int, default=1,
                    help="interleaved pipeline: layer chunks per device (>1 shrinks the "
                    "bubble by that factor)")
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation chunks per step (pipe=1 only)")
    ap.add_argument("--dropout", type=float, default=0.0, help="residual dropout rate")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--zero", action="store_true",
                    help="ZeRO-1 optimizer-state sharding over 'data'. Switches to the "
                    "plain fused Adam (drops this example's default weight-decay/clip "
                    "chain); flat step path only")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--patch", type=int, default=16)
    ap.add_argument("--d-model", type=int, default=384)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--kv-heads", type=int, default=0,
                    help="grouped-query attention K/V head count (0 = MHA)")
    ap.add_argument("--num-train", type=int, default=256,
                    help="synthetic train examples (when no real dataset)")
    ap.add_argument("--num-test", type=int, default=64)
    ap.add_argument("--cpu-devices", type=int, default=0,
                    help="run on the CPU, as that many gloo ranks when --data x --pipe > 1")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the CPU)")
    ap.add_argument("--checkpoint-dir", default="checkpoints",
                    help="QWK-gated / preemption snapshot dir ('' disables)")
    ap.add_argument("--keep-snapshots", type=int, default=0,
                    help="snapshot GC: keep only the newest K valid snapshots (corrupt "
                    "ones never count; 0 = keep all)")
    ap.add_argument("--resume-epoch", type=int, default=None,
                    help="restore the snapshot saved at this epoch")
    ap.add_argument("--fresh", action="store_true",
                    help="start from scratch even if this job id already has snapshots "
                    "(auto-resume is the default: a relaunch with the same --job-id "
                    "continues from the latest one)")
    ap.add_argument("--job-id", default="vit")
    ap.add_argument("--log-dir", default="training_logs",
                    help="MetricLogger CSV suite and event stream directory; '' disables")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace of one post-warm-up epoch into "
                    "this dir")
    ap.add_argument("--no-halt-on-nan", action="store_true",
                    help="keep training through non-finite losses")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    if args.fsdp and args.data > 1:
        raise NotImplementedError(
            f"--fsdp with --data {args.data}: the port does not shard the embed dimension "
            "over data yet; FSDP is ROADMAP item 11b (FSDP)")

    from ddl_tpu_torch import launch
    from ddl_tpu_torch.config import DataConfig
    from ddl_tpu_torch.models.vit import ViTConfig
    from ddl_tpu_torch.parallel.sharding import LMMeshSpec
    from ddl_tpu_torch.train.state import Optimizer
    from ddl_tpu_torch.train.vit_trainer import ViTRunConfig, ViTTrainer

    device = "cpu" if args.cpu_devices else args.device
    mesh_spec = LMMeshSpec(data=args.data, model=args.model, pipe=args.pipe)
    if launch.run_as_world("ddl_tpu_torch.examples.train_vit", argv, mesh_spec.num_devices,
                           device, args.cpu_devices, mesh_spec):
        return None
    launch.bootstrap(device)
    device = launch.resolve_rank_device(device)

    cfg = ViTConfig(
        image_size=args.image_size,
        patch_size=args.patch,
        d_model=args.d_model,
        n_layers=args.layers,
        n_heads=max(2, args.d_model // 64),
        n_kv_heads=args.kv_heads,
        head_dim=64 if args.d_model >= 128 else args.d_model // 2,
        d_ff=4 * args.d_model,
        compute_dtype="bfloat16" if device.type != "cpu" else "float32",
        fsdp=args.fsdp,
        dropout_rate=args.dropout,
    )
    spec = LMMeshSpec(data=args.data, model=args.model, pipe=args.pipe)

    def tx(params):
        if args.zero:
            return Optimizer(params, args.lr, fused=True)
        return Optimizer(params, args.lr, weight_decay=0.05, grad_clip_norm=1.0)

    run = ViTRunConfig(
        batch=args.batch,
        epochs=args.epochs,
        num_microbatches=args.microbatches,
        accum_steps=args.accum,
        pipeline_schedule=args.pipeline_schedule,
        virtual_stages=args.virtual_stages,
        zero_sharding=args.zero,
        checkpoint_dir=args.checkpoint_dir or None,
        keep_snapshots=args.keep_snapshots,
        resume_epoch=args.resume_epoch,
        auto_resume=not args.fresh,
        job_id=args.job_id,
        log_dir=args.log_dir or None,
        halt_on_nan=not args.no_halt_on_nan,
        profile_dir=args.profile_dir,
    )
    dc = DataConfig(
        image_size=args.image_size,
        global_batch_size=args.batch,
        eval_batch_size=args.batch,
        synthetic_num_train=args.num_train,
        synthetic_num_test=args.num_test,
    )
    trainer = ViTTrainer(cfg, spec, tx, run, data=dc, device=device)
    if trainer.is_logging_process:
        print(f"mesh=(data={args.data}, model={args.model}, pipe={args.pipe}) "
              f"fsdp={args.fsdp} patches={cfg.num_patches} device={device}")
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
