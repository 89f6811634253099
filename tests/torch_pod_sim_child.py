"""Trainer child for the port's pod-recovery simulations
(tests/test_torch_pod_sim.py, and chip_smoke.py's phase 13 (b) on the
card): the port's copy of ``tests/pod_sim_child.py``.

One "host" of a simulated pod: a real tiny-LM trainer (the port's
``LMTrainer``, one process, one device) under pod supervision.  The hosts
share one checkpoint store (the tmpdir standing in for a shared
directory), with host 0 as the snapshot writer, and every host logs each
consumed batch (the global step, since the LM stream is pure in the step)
to ``consumed_h<i>.log`` so the caller can audit exact resume: no batch
replayed, none skipped.  The hosts have no process group between them:
the rendezvous's file agreements are their only agreement.

Steps are paced (``DDL_SIM_PACE`` seconds each) so the pod's hosts are
mid-training when one host's injected fault trips.  The device is
``--device`` or ``DDL_SIM_DEVICE`` (default the CPU); on ``cuda`` a host
with no GPU raises instead of training on the CPU, and the child writes
its flash kernels' launch counters to ``launches_h<i>.log``.
``DDL_SIM_CONFIG`` (JSON, ``{"model": {...}, "run": {...}}``) overrides
the tiny LMConfig and LMRunConfig fields.  Not collected by pytest (no
``test_`` prefix).
"""

import argparse
import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from ddl_tpu_torch.models.transformer import LMConfig  # noqa: E402
from ddl_tpu_torch.parallel.sharding import LMMeshSpec  # noqa: E402
from ddl_tpu_torch.train.lm_trainer import LMRunConfig, LMTrainer  # noqa: E402
from ddl_tpu_torch.train.state import Optimizer  # noqa: E402
from ddl_tpu_torch.utils import faultinject  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=os.environ.get("DDL_SIM_DEVICE", "cpu"))
    device = ap.parse_args().device
    sim = os.environ["DDL_SIM_DIR"]
    host = int(os.environ.get("DDL_COORD_HOST", "0"))
    pace = float(os.environ.get("DDL_SIM_PACE", "0"))
    steps = int(os.environ.get("DDL_SIM_STEPS", "10"))
    epoch = os.environ.get("DDL_RESTART_EPOCH", "0")
    over = json.loads(os.environ.get("DDL_SIM_CONFIG") or "{}")

    # membership/respec audit: what the supervisor's spawn env said about
    # this incarnation's world
    with open(os.path.join(sim, f"env_h{host}.log"), "a") as fh:
        fh.write(
            f"{epoch} members={os.environ.get('DDL_COORD_MEMBERS', '-')} "
            f"nproc={os.environ.get('DDL_NUM_PROCESSES', '-')} "
            f"pid={os.environ.get('DDL_PROCESS_ID', '-')}\n"
        )

    # elastic scale-up drill (DDL_FAULT="rejoin@epoch:K"): leave the pod on
    # purpose once this incarnation's restart epoch reaches K, before
    # training, so the leave lands at a restart boundary
    if faultinject.check_epoch(int(epoch)):
        from ddl_tpu_torch.supervisor import EXIT_REJOIN

        print(f"[child h{host}] injected rejoin at epoch {epoch}", flush=True)
        sys.exit(EXIT_REJOIN)

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"host {host}: --device {device} but this host has no GPU")
    torch.manual_seed(0)
    cfg = LMConfig(**{**dict(vocab_size=256, d_model=16, n_layers=1, n_heads=2, head_dim=8,
                             d_ff=32, compute_dtype="float32", remat=False),
                      **over.get("model", {})})
    run = LMRunConfig(**{**dict(
        batch=2, seq_len=8, steps=steps, save_every=3, log_every=1,
        job_id=os.environ.get("DDL_JOB_ID", "podsim"),
        checkpoint_dir=os.path.join(sim, "ckpt"),  # the shared store
        log_dir=os.path.join(sim, f"logs_h{host}"),
    ), **over.get("run", {})})
    t = LMTrainer(cfg, LMMeshSpec(), lambda p: Optimizer(p, 1e-2), run, device=device)

    # audit trail: every batch this incarnation consumes, keyed by the
    # global step (the LM data cursor), tagged with the restart epoch
    consumed = os.path.join(sim, f"consumed_h{host}.log")
    orig_sample = t._sample_batch

    def sample(step):
        with open(consumed, "a") as fh:
            fh.write(f"{epoch} {step}\n")
            fh.flush()
        return orig_sample(step)

    t._sample_batch = sample

    if pace > 0:
        fns = t.fns
        orig_train = fns.train

        def paced(state, inp, tgt):
            time.sleep(pace)
            return orig_train(state, inp, tgt)

        t.fns = fns._replace(train=paced)

    if host != 0:
        # hosts 1+ read the shared store but never write it
        t.save_snapshot = lambda period: None

    counters = {}
    if torch.device(device).type == "cuda":
        from ddl_tpu_torch.ops.flash_attention import (
            flash_attention_bwd_dkdv,
            flash_attention_bwd_dq,
            flash_attention_with_lse,
        )

        counters = {"flash_attention_fwd": flash_attention_with_lse,
                    "flash_attention_bwd_dq": flash_attention_bwd_dq,
                    "flash_attention_bwd_dkdv": flash_attention_bwd_dkdv}
        for fn in counters.values():
            fn.launches = 0

    print(f"[child h{host}] start at step {t._start_step} (restart epoch {epoch})", flush=True)
    t.train()
    final = int(t.state.step)
    # the decisive cross-host check: a SHA-256 over the full parameter
    # state, identical final step AND identical weights on every host
    h = hashlib.sha256()
    for name, leaf in sorted(t.state.model.state_dict().items()):
        h.update(name.encode())
        h.update(leaf.detach().float().cpu().contiguous().numpy().tobytes())
    with open(os.path.join(sim, f"final_h{host}.log"), "a") as fh:
        fh.write(f"{epoch} {final} {h.hexdigest()}\n")
    if counters:
        with open(os.path.join(sim, f"launches_h{host}.log"), "a") as fh:
            fh.write(f"{epoch} {json.dumps({k: f.launches for k, f in counters.items()})}\n")
    print(f"[child h{host}] CHILD_OK step={final}", flush=True)
    if t.preempted and os.environ.get("DDL_SUPERVISED") == "1":
        from ddl_tpu_torch.supervisor import EXIT_PREEMPTED

        sys.exit(EXIT_PREEMPTED)


if __name__ == "__main__":
    main()
