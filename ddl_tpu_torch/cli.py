"""Command-line entry point: ``python -m ddl_tpu_torch.cli --preset single``
(counterpart of ``ddl_tpu/cli.py``).

The reference's ``single.py`` is the ``single`` preset, its ``ddp.py`` the
``dp`` preset, its ``pp.py`` the ``pp`` preset and its ``ddp_n_pp.py`` the
``dp_pp`` preset, with dotted overrides and the torch device:

    python -m ddl_tpu_torch.cli --preset single \\
        --set data.dataset_dir=/data/aptos train.max_epochs=30 [--device cpu]
    python -m ddl_tpu_torch.cli --preset dp --set mesh.data=4 [--cpu-devices 4]
    python -m ddl_tpu_torch.cli --preset pp [--cpu-devices 2]
    python -m ddl_tpu_torch.cli --preset dp_pp --set mesh.data=2 [--cpu-devices 4]

``--preset dp`` is ``mesh.data`` ranks and the pipelines ``mesh.data *
mesh.pipe`` ranks (one a stage, ``train.pipeline_schedule`` gpipe or
1f1b), one process and one device each (``cuda:<rank>``; the CPU under
``--device cpu``/``--cpu-devices N``, with N CPU devices), joined by
``torch.distributed`` (NCCL on the card, gloo on the CPU).  Without a
world in the environment the command line starts the ranks itself
(``launch.run_as_world``, as ``tools.smoke`` and ``bench.comm`` do), each
running this same command, and exits with the world's exit code; with
one (``DDL_COORDINATOR``/``DDL_NUM_PROCESSES``/``DDL_PROCESS_ID``, or
``DDL_MULTIHOST=1`` and a cluster launcher's variables) this process is
one rank of it.

``data.dataset_dir`` (or ``DDL_DATASET_DIR``) holding ``train.csv`` trains
on the APTOS image files, decoded by the native loader
(``ddl_tpu_torch/native/``); without it the synthetic APTOS-shaped set is
used.  The DenseNet kernels run with ``model.compute_dtype=bfloat16
model.dense_block_impl=fused model.pallas_normalize=true``.  Without
``--device`` the run is on CUDA, and raises where CUDA is absent;
``--cpu-devices 1`` (the JAX flag) means ``--device cpu``.

Supervised, the trainer runs as a child process that is relaunched after
a preemption or a crash and resumes from its newest valid snapshot
(``ddl_tpu_torch/supervisor.py``):

    python -m ddl_tpu_torch.cli train --supervise --max-restarts 5 \\
        --preset single --set train.max_epochs=30

The leading ``train`` is optional; a supervised run of several ranks
relaunches its whole world.  Across the hosts of a pod every host runs
the same command with ``--pod`` (a directory all hosts share), the pod's
host count and its own id (``--hosts``/``--host-id``, else
``DDL_COORD_HOSTS``/``DDL_NUM_PROCESSES`` and ``DDL_COORD_HOST``/
``DDL_HOST_ID``/``DDL_PROCESS_ID``, as in the JAX package); the hosts
restart together, and ``--elastic`` continues on the survivors of a lost
host and grows the pod back when it returns:

    python -m ddl_tpu_torch.cli train --supervise --pod /shared/coord \
        --hosts 2 --host-id 0 --preset dp --set mesh.data=4

Each host then starts ``mesh.data * mesh.pipe / hosts`` ranks of one
world (``launch.run_pod_host``).  ``--set train.zero_sharding=true``
shards Adam's moments over the ``dp`` ranks (ZeRO-1,
``train/fused_optim.py``), as in the JAX package, which has no flag of its
own for it either.  ``serve-bench`` runs the continuous-batching
serving engine's benchmark (``ddl_tpu_torch/serve/bench.py``):

    python -m ddl_tpu_torch.cli serve-bench --device cpu --clients 8 \
        --prompt-len 8:24 --max-new 16:32 --compare-sequential

What the port does not run yet is refused with its ROADMAP item: the
``obs`` and ``bench`` subcommands (item 13).  ``lint``
analyses JAX-traced code and has no counterpart here.

In-process callers get the finished ``Trainer`` back from ``main`` (None
from the process that started a world's ranks).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

__all__ = ["main"]

# subcommands of the JAX command line the port refuses, with the reason
REFUSED = {
    "obs": "the obs subcommand (event-stream reports) is not ported yet (ROADMAP item 13)",
    "bench": "the bench subcommand (the headline perf gate) is not ported yet "
             "(ROADMAP item 13)",
    "lint": "the lint subcommand analyses JAX-traced code (its AST rules and compiled-HLO "
            "passes) and is not ported",
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in REFUSED:
        raise SystemExit(f"[ddl_tpu_torch] {REFUSED[argv[0]]}")
    if argv and argv[0] == "serve-bench":
        from ddl_tpu_torch.serve.bench import main as serve_bench

        return serve_bench(argv[1:])
    if argv and argv[0] == "train":
        argv = argv[1:]

    # supervision flags are peeled off before config parsing: the
    # supervisor process must not initialise CUDA (the child owns the card)
    sup = argparse.ArgumentParser(add_help=False)
    sup.add_argument("--supervise", action="store_true")
    sup.add_argument("--max-restarts", type=int, default=None)
    sup.add_argument("--pod", metavar="DIR", default=None)
    sup.add_argument("--hosts", type=int, default=None)
    sup.add_argument("--host-id", type=int, default=None)
    sup.add_argument("--elastic", action="store_true")
    sup_args, rest = sup.parse_known_args(argv)
    # loud, never silently dropped: each flag promises a behaviour
    if sup_args.max_restarts is not None and not sup_args.supervise:
        raise SystemExit("--max-restarts requires --supervise")
    if sup_args.pod is not None and not sup_args.supervise:
        raise SystemExit("--pod requires --supervise")
    if sup_args.pod is None and (sup_args.hosts is not None or sup_args.host_id is not None):
        raise SystemExit("--hosts/--host-id require --pod")
    if sup_args.elastic and sup_args.pod is None:
        raise SystemExit("--elastic requires --pod")
    if sup_args.supervise:
        max_restarts = 5 if sup_args.max_restarts is None else sup_args.max_restarts
        child_argv = [sys.executable, "-m", "ddl_tpu_torch.cli", *rest]
        if sup_args.pod is not None:
            from ddl_tpu_torch.supervisor import supervise_pod_command

            n_hosts = sup_args.hosts or int(os.environ.get("DDL_COORD_HOSTS")
                                            or os.environ.get("DDL_NUM_PROCESSES") or 1)
            host = sup_args.host_id
            if host is None:
                host = int(os.environ.get("DDL_COORD_HOST") or os.environ.get("DDL_HOST_ID")
                           or os.environ.get("DDL_PROCESS_ID") or 0)
            raise SystemExit(supervise_pod_command(
                child_argv, sup_args.pod, host, n_hosts, max_restarts=max_restarts,
                elastic=sup_args.elastic))
        from ddl_tpu_torch.supervisor import supervise_command

        raise SystemExit(supervise_command(child_argv, max_restarts=max_restarts))

    from ddl_tpu_torch import launch
    from ddl_tpu_torch.config import parse_cli, to_dict
    from ddl_tpu_torch.parallel.mesh import MeshSpec
    from ddl_tpu_torch.train import Trainer

    cfg, device = parse_cli(rest)
    peek = argparse.ArgumentParser(add_help=False)
    peek.add_argument("--cpu-devices", type=int, default=0)
    if launch.run_as_world("ddl_tpu_torch.cli", rest, cfg.mesh.num_devices, device,
                           peek.parse_known_args(rest)[0].cpu_devices,
                           MeshSpec(cfg.mesh.data, cfg.mesh.pipe)):
        return None
    launch.bootstrap(device)
    device = launch.resolve_rank_device(device)
    print(f"[ddl_tpu_torch] world: {json.dumps(launch.world_info(device))}")
    if not launch.in_world() or launch.host_id() == 0:
        print(f"[ddl_tpu_torch] config: {json.dumps(to_dict(cfg))}")

    trainer = Trainer(cfg, device=device)
    completed = False
    try:
        trainer.train()
        completed = True
    finally:
        _report(trainer, completed)
    if trainer.preempted and os.environ.get("DDL_SUPERVISED") == "1":
        # a resumable interruption, not a finished run: the supervisor
        # relaunches and auto-resume does the rest
        from ddl_tpu_torch.supervisor import EXIT_PREEMPTED

        raise SystemExit(EXIT_PREEMPTED)
    return trainer


def _report(trainer, completed: bool) -> None:
    """With ``DDL_RUN_REPORT`` (a directory) set, write what this rank's
    run did to ``report-e<restart epoch>-r<rank>.json`` there, for a caller
    outside the ranks (a pod's or a supervised world's): the DenseNet
    kernels' launches (#1-#3's counters), whether the run completed, this
    rank's optimizer bytes (ZeRO's shard under ``train.zero_sharding``), and
    a SHA-256 over the model's parameters and BatchNorm statistics, whose
    tensors a completed run also saves beside it (``state-e<E>-r<rank>.pt``)."""
    out = os.environ.get("DDL_RUN_REPORT")
    if not out:
        return
    import hashlib

    import torch

    from ddl_tpu_torch import launch
    from ddl_tpu_torch.ops import fused_dense_block, fused_dense_block_bwd, normalize

    state = {k: t.detach().cpu().contiguous() for k, t in trainer.model.state_dict().items()}
    digest = hashlib.sha256()
    for name, t in sorted(state.items()):
        digest.update(name.encode())
        digest.update(t.view(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b"")
    rank = int(os.environ.get("DDL_PROCESS_ID") or 0) if launch.in_world() else 0
    tag = f"e{launch.restart_epoch()}-r{rank}"
    report = {"launches": {f.__name__: f.launches for f in (normalize, fused_dense_block,
                                                             fused_dense_block_bwd)},
              "completed": completed, "opt_bytes": trainer.opt_state_hbm_bytes(),
              "state_sha256": digest.hexdigest()}
    os.makedirs(out, exist_ok=True)
    if completed:
        torch.save(state, os.path.join(out, f"state-{tag}.pt"))
    with open(os.path.join(out, f"report-{tag}.json"), "w") as f:
        json.dump(report, f)


if __name__ == "__main__":
    main()
