"""LM training throughput (counterpart of ``ddl_tpu/bench/lm.py``).

    python -m ddl_tpu_torch.bench.lm                 # the 124M LM, T=1024, batch 8
    python -m ddl_tpu_torch.bench.lm --seq-len 2048 --batch 4 --flash
    python -m ddl_tpu_torch.bench.lm --batch 16 --experts 8 --d-ff 1536 --flash
    python -m ddl_tpu_torch.bench.lm --flash --ce-chunk 256
    python -m ddl_tpu_torch.bench.lm --seq 4 --attn ring --flash --parity   # four GPUs
    python -m ddl_tpu_torch.bench.lm --pipe 4 --microbatches 8 --schedule 1f1b --flash
    python -m ddl_tpu_torch.bench.lm --model 4 --flash --parity                # four GPUs
    python -m ddl_tpu_torch.bench.lm --pipe 2 --seq 2 --attn ring --flash --parity

Steady-state timing of the full train step (forward, backward, AdamW):
three warm-up steps, then ``--windows`` windows of ``--iters`` steps, each
between two ``torch.cuda.synchronize()`` calls, and their median per step
beside every window's (the host's speed moves a step's wall between
windows; ``bench/vit.py``'s method).  Prints one JSON line: ms_per_step,
tokens_per_sec, the flash path actually taken, the remat policy, the loss
edge (``ce_chunk``, ``ce_vocab_chunk``), the last loss and the device
memory peak; with ``--experts``, the resolved ``moe_dispatch`` and
``moe_group`` and the last step's router metrics.  The flags are the JAX
bench's; MFU waits for the port of ``bench/mfu.py`` (ROADMAP item 13).
``--device`` (default ``cuda``) is the port's own flag: ``--device cpu``
exists for the CPU smoke test, whose times mean nothing.

``--data``/``--seq``/``--model``/``--pipe`` above 1 start one rank per
GPU (``launch.run_as_world``; ``--cpu-devices N`` gloo ranks on the CPU),
each on its block of the global batch, with ``--attn`` (dense, ring,
ulysses) as the sequence core; ``--model`` splits every block's heads and
MLP and the vocabulary over its ranks; ``--pipe`` above 1 cuts the layers
into that many stages, one a rank, run in ``--microbatches`` (default
``--pipe``) under ``--schedule`` (gpipe, 1f1b, zb) with
``--virtual-stages``.  The line is rank 0's, with the device-busy time of
a step (the union of its kernels' intervals) and its share of the wall.
``--parity`` first runs ``PARITY_STEPS`` steps from the seed's weights on
the mesh and, on rank 0's card, on one device through the same kernels
and in f32 (dense attention): ``parity`` in the line holds the worst
relative loss gap to one card (phase 6's limit, 1e-2) and, against the f32
run, the first step's gradient and the steps' weight updates no farther
than 1.25x one card's (``lm_parity``: bf16 runs are never compared leaf by
leaf); a pipeline's stages and the model ranks' parts are gathered onto
rank 0 for it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import dataclasses

import numpy as np
import torch

from ddl_tpu_torch.models.transformer import REMAT_POLICIES, LMConfig, moe_routing_plan
from ddl_tpu_torch.parallel.sharding import LMMeshSpec, normalize_flash
from ddl_tpu_torch.train.lm_steps import local_block, make_lm_step_fns
from ddl_tpu_torch.train.state import Optimizer
from ddl_tpu_torch.utils.device import resolve_device

__all__ = ["PARITY_STEPS", "bench_lm", "lm_bench_config", "lm_parity", "lm_record", "main"]

PARITY_STEPS = 3
# phase 6's limits (chip_smoke.py STEP_LOSS_TOL, STEP_GRAD_RATIO)
PARITY_LOSS_TOL, PARITY_RATIO = 1e-2, 1.25


def _adamw(params):
    """optax.adamw(3e-4): decoupled weight decay 1e-4."""
    return Optimizer(params, 3e-4, weight_decay=1e-4)


def _cpu_f32(tensors) -> dict:
    return {k: v.detach().float().cpu().clone() for k, v in tensors}


def lm_record(cfg: LMConfig, batches, seed: int = 0, spec: LMMeshSpec = LMMeshSpec(),
              device=None, mesh=None, **kw) -> dict:
    """``len(batches)`` train steps of ``cfg`` from ``seed``'s weights on the
    global (inputs, targets) ``batches``, each rank on its block: the
    losses, the first step's (global) gradient, the weights before and
    after (f32, on the CPU; a pipeline rank's: its stage's).  ``kw`` goes
    to ``make_lm_step_fns`` (the pipeline's arguments)."""
    batch, seq_len = batches[0][0].shape
    fns = make_lm_step_fns(cfg, spec, _adamw, seed, batch, seq_len, device=device, mesh=mesh,
                           **kw)
    state = fns.init_state()
    rec = {"losses": [], "params0": _cpu_f32(state.model.state_dict().items())}
    for i, (inp, tgt) in enumerate(batches):
        state, m = fns.train(state, local_block(inp, fns.mesh), local_block(tgt, fns.mesh))
        rec["losses"].append(float(m["loss"]))
        if i == 0:
            rec["grads"] = _cpu_f32((n, p.grad) for n, p in state.model.named_parameters())
    rec["params"] = _cpu_f32(state.model.state_dict().items())
    return rec


def _rel_l2(a: dict, b: dict) -> float:
    """||a - b|| / ||b|| over the whole vector of every tensor."""
    num = sum(float((a[k] - b[k]).square().sum()) for k in b)
    return (num / sum(float(v.square().sum()) for v in b.values())) ** 0.5


def lm_parity(mesh_rec: dict, one_rec: dict, f32_rec: dict, loss_tol: float = PARITY_LOSS_TOL,
              ratio: float = PARITY_RATIO) -> dict:
    """A mesh run's records against one card's through the same kernels
    and against f32: the worst relative loss gap to one card, and the
    first step's gradient and the weight updates at most ``ratio`` times
    one card's relative L2 distance from the f32 run's."""
    def update(rec):
        return {k: rec["params"][k] - rec["params0"][k] for k in rec["params"]}

    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(mesh_rec["losses"], one_rec["losses"]))
    grad = (_rel_l2(mesh_rec["grads"], f32_rec["grads"]),
            _rel_l2(one_rec["grads"], f32_rec["grads"]))
    u32 = update(f32_rec)
    upd = (_rel_l2(update(mesh_rec), u32), _rel_l2(update(one_rec), u32))
    return {"loss_rel": loss_rel, "grad_l2_to_f32": grad, "update_l2_to_f32": upd,
            "losses": {"mesh": mesh_rec["losses"], "one": one_rec["losses"],
                       "f32": f32_rec["losses"]},
            "ok": loss_rel <= loss_tol and grad[0] <= ratio * grad[1]
            and upd[0] <= ratio * upd[1]}


def _merge_parts(rec: dict, mesh, vocab: int) -> dict | None:
    """A pipelined or tensor-parallel run's ``lm_record``s, data row 0's
    stages and model ranks gathered onto rank 0, each stage's model ranks
    joined (``models/convert.gather_lm_state``) and the stages merged by
    key (the losses are every rank's); None elsewhere."""
    from ddl_tpu_torch.checkpoint import gather_parts
    from ddl_tpu_torch.models.convert import gather_lm_state

    got = gather_parts(mesh, lambda: rec)
    if got is None:
        return None
    stages = sorted({p for p, _ in got})
    models = sorted({m for _, m in got})
    out = {"losses": rec["losses"]}
    for k in ("params0", "grads", "params"):
        out[k] = {n: t for p in stages for n, t in gather_lm_state(
            [{"model": got[p, m][k]} for m in models], vocab_size=vocab)["model"].items()}
    return out


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
             device=None, spec: LMMeshSpec = LMMeshSpec(), mesh=None,
             busy: bool = False, windows: int = 1, **kw) -> dict:
    """Time ``windows`` windows of ``iters`` train steps of ``cfg`` after
    three warm-up steps (``ms_per_step`` their median, ``ms_windows``
    each), on random tokens from ``seed`` (this rank's block of the global
    ``batch`` x ``seq_len`` on a ``spec`` mesh), with
    ``optax.adamw(3e-4)``'s update (``Optimizer(..., weight_decay=1e-4)``);
    ``kw`` goes to ``make_lm_step_fns`` (the pipeline's arguments).  On
    the card the numbers are walls between synchronisations and the memory
    peak is ``max_memory_allocated`` over the timed steps; on the CPU (the
    smoke test) there is no peak.  ``busy`` profiles ``iters`` more steps
    on the card for the device-busy time a step."""
    device = mesh.device if mesh is not None else resolve_device(device)
    cfg = normalize_flash(cfg, spec, seq_len, device.type)
    fns = make_lm_step_fns(cfg, spec, _adamw, seed, batch, seq_len, device=device, mesh=mesh,
                           **kw)
    cuda = fns.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(fns.device)

    state = fns.init_state()
    toks = torch.from_numpy(
        np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq_len + 1))
    ).to(fns.device)
    inp, tgt = local_block(toks[:, :-1], fns.mesh), local_block(toks[:, 1:], fns.mesh)
    for _ in range(3):
        state, m = fns.train(state, inp, tgt)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(fns.device)
    walls = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            state, m = fns.train(state, inp, tgt)
        sync()
        walls.append((time.perf_counter() - t0) / iters * 1e3)
    dt = statistics.median(walls) / 1e3
    out = {
        "ms_per_step": dt * 1e3,
        "ms_windows": walls,
        "tokens_per_sec": batch * seq_len / dt,
        "seq_len": seq_len,
        "batch": batch,
        "flash": bool(cfg.flash),  # the path auto actually picked
        "remat": cfg.remat_policy if cfg.remat else "off",
        "ce_chunk": cfg.ce_chunk,
        "ce_vocab_chunk": cfg.ce_vocab_chunk,
        "loss": float(m["loss"]),
    }
    if spec.data * spec.seq * spec.model > 1:
        out.update(data=spec.data, seq=spec.seq, model=spec.model, attn=cfg.attn_impl)
    if spec.pipe > 1:
        out.update(data=spec.data, pipe=spec.pipe,
                   microbatches=kw.get("num_microbatches") or spec.pipe,
                   schedule=kw.get("pipeline_schedule", "gpipe"),
                   virtual_stages=kw.get("virtual_stages", 1))
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
    if cuda and busy:
        from torch.profiler import ProfilerActivity, profile

        from ddl_tpu_torch.bench.vit import device_busy_ms

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                state, m = fns.train(state, inp, tgt)
            sync()
        out["device_busy_ms"] = device_busy_ms(prof) / iters
        out["busy_share"] = out["device_busy_ms"] / out["ms_per_step"]
    out["device"] = torch.cuda.get_device_name(fns.device) if cuda else "cpu"
    return out


def main(argv=None) -> dict | None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
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
    ap.add_argument("--windows", type=int, default=1,
                    help="timed windows of --iters steps; the median is reported")
    ap.add_argument("--data", type=int, default=1, help="data-parallel ranks")
    ap.add_argument("--seq", type=int, default=1, help="sequence-parallel ranks")
    ap.add_argument("--model", type=int, default=1, help="tensor-parallel ranks")
    ap.add_argument("--pipe", type=int, default=1, help="pipeline stages, one a rank")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="pipeline microbatches when --pipe > 1 (default: --pipe)")
    ap.add_argument("--schedule", default="gpipe", choices=["gpipe", "1f1b", "zb"],
                    help="pipeline schedule when --pipe > 1")
    ap.add_argument("--virtual-stages", type=int, default=1,
                    help="interleaved pipeline: layer chunks per rank")
    ap.add_argument("--attn", default="dense", choices=["dense", "ring", "ulysses"])
    ap.add_argument("--parity", action="store_true",
                    help="hold the mesh's first steps to one card's and to f32 first")
    ap.add_argument("--cpu-devices", type=int, default=0,
                    help="gloo ranks on the CPU when --data x --seq x --model x --pipe > 1")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    cfg = lm_bench_config(args.vocab, args.d_model, args.layers, args.kv_heads,
                          args.attn_window, args.d_ff, args.flash, args.remat_policy,
                          args.no_remat, args.experts, args.expert_top_k,
                          args.capacity_factor, args.moe_dispatch, args.moe_group,
                          args.ce_chunk, args.ce_vocab_chunk)
    cfg = dataclasses.replace(cfg, attn_impl=args.attn)
    spec = LMMeshSpec(data=args.data, seq=args.seq, pipe=args.pipe, model=args.model)
    kw = {}
    if spec.pipe > 1:
        kw = dict(num_microbatches=args.microbatches, pipeline_schedule=args.schedule,
                  virtual_stages=args.virtual_stages)
    mesh = None
    if spec.num_devices > 1:
        from ddl_tpu_torch import launch
        from ddl_tpu_torch.parallel.mesh import build_lm_mesh

        device = "cpu" if args.cpu_devices else args.device
        if launch.run_as_world("ddl_tpu_torch.bench.lm", argv, spec.num_devices, device,
                               args.cpu_devices, spec):
            return None
        launch.bootstrap(device)
        mesh = build_lm_mesh(spec, device)
    device = mesh.device if mesh is not None else resolve_device(args.device or "cuda")
    first = mesh is None or mesh.rank == 0
    parity = None
    if args.parity:
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (PARITY_STEPS, args.batch, args.seq_len + 1))).to(device)
        batches = [(t[:, :-1], t[:, 1:]) for t in toks]
        cfg = normalize_flash(cfg, spec, args.seq_len, device.type)
        rec = lm_record(cfg, batches, spec=spec, device=device, mesh=mesh, **kw)
        if spec.pipe * spec.model > 1:  # every part's records of data row 0, on rank 0
            rec = _merge_parts(rec, mesh, cfg.vocab_size)
        if first:  # one card and f32 on rank 0's card, the others waiting
            one = lm_record(dataclasses.replace(cfg, attn_impl="dense"), batches, device=device)
            f32 = lm_record(dataclasses.replace(cfg, attn_impl="dense", flash=False,
                                                compute_dtype="float32"), batches,
                            device=device)
            parity = lm_parity(rec, one, f32)
            del one, f32
        if mesh is not None:
            mesh.barrier()
        del rec
    out = bench_lm(cfg, args.batch, args.seq_len, args.iters, device=device, spec=spec,
                   mesh=mesh, busy=True, windows=args.windows, **kw)
    out["flash_mode"] = args.flash
    if parity is not None:
        out["parity"] = parity
    if first:
        print(json.dumps(out))
    if parity is not None and not parity["ok"]:
        raise SystemExit(f"parity failed: {json.dumps(parity)}")
    return out


if __name__ == "__main__":
    main()
