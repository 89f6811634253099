"""``serve-bench``: synthetic concurrent clients -> percentile report (the
port of ``ddl_tpu/serve/bench.py``, one device).

Fires N clients at the continuous-batching engine with configurable
prompt/output-length distributions and a deterministic arrival process,
then renders the serving report: p50/p95/p99 latency / queue delay /
TTFT / per-request tokens/s (the ``obs/serving.py`` accumulators — the
same table ``obs summarize`` shows), aggregate tokens/s (and per chip),
admission/shed counts, prefix-cache hit rate + prefill tokens actually
computed, pool occupancy, and the count of program shapes run for the
first time (eager PyTorch compiles nothing: a shape's first run builds
the kernels of a new process and warms cuBLAS and the allocator).

``--scenario`` selects a parameterized client mix:

    shared-prefix   every client = one shared system prompt
                    (``--shared-prefix-len``) + a unique tail drawn from
                    ``--prompt-len`` — the prefix-cache economics case
    long-prompt     one ``--long-prompt-len`` prompt in a crowd of short
                    ones — chunked prefill (``--prefill-chunk``, auto-set
                    here) must keep the short requests' queue delay
                    bounded instead of stalling them behind the monolith
    bursty          Poisson bursts: groups arrive together, bursts
                    spaced exponentially (``--arrival-s`` = mean gap)
    mixed           shared-prefix cohort + a long prompt + unique short
                    fillers under bursty arrivals
    multi-tenant    a weighted tenant mix (~50% interactive / 30% batch
                    / 20% best-effort) with per-class arrival rates and
                    prompt shapes; every request carries its
                    ``tenant``/``priority_class`` tags through the
                    event stream, the report gains a per-tenant block,
                    and (with --obs-log-dir) a declarative ``slo.json``
                    lands in the job dir for the JAX package's
                    ``obs slo <job>`` (its port is ROADMAP item 12b)

``--compare-sequential`` replays the same requests one-at-a-time
through ``infer.decode.make_lm_generator`` (batch 1, the request's
seeded generator) at equal per-request settings — the one-request-at-a-time baseline continuous batching
exists to beat.  The report prints the throughput ratio AND verifies
the engine's tokens are bit-identical to the sequential replay,
**exiting nonzero on any mismatch** — the CI gate that the prefix
cache + chunked prefill change scheduling only, never tokens.  (With
``--int8 kv|kv+w`` AND the prefix cache on, reused prefixes are
attended at int8 precision while a fresh prefill attends raw
activations, so exactness is not expected there — the report says so
instead of failing.)  On the CPU the engine's tokens are the
sequential ones; on a GPU the batched products and the wider attention
views round differently in bf16, so a near-tie can flip a token there.

With ``--obs-log-dir/--job-id`` every request lands in the job's event
stream (the JAX package's schema: its ``obs summarize <job>`` renders the
percentiles; the port's readers are ROADMAP item 13).

The JAX command's flags, with ``--device`` in place of ``--cpu-devices``
(default CUDA; ``--device cpu`` computes in f32, CUDA in bf16).  One
device: ``--data``, ``--model`` or ``--seq`` above 1 raises, naming ROADMAP
item 11.  Examples::

    python -m ddl_tpu_torch.cli serve-bench --device cpu --clients 8 \
        --prompt-len 8:24 --max-new 16:32 --block-size 8 --num-blocks 64
    python -m ddl_tpu_torch.cli serve-bench --clients 16 --d-model 768 \
        --heads 12 --layers 12 --prompt-len 64:512 --max-new 32:64 \
        --block-size 16 --num-blocks 512 --compare-sequential
    python -m ddl_tpu_torch.examples.serve_lm --checkpoint-dir /tmp/ck --step 200 ...
"""

from __future__ import annotations

import argparse
import time
from time import perf_counter

__all__ = ["main", "run_clients"]


def _parse_range(s: str, name: str) -> tuple[int, int]:
    """"8" -> (8, 8); "8:24" -> (8, 24) inclusive uniform range."""
    parts = s.split(":")
    try:
        if len(parts) == 1:
            lo = hi = int(parts[0])
        elif len(parts) == 2:
            lo, hi = int(parts[0]), int(parts[1])
        else:
            raise ValueError
    except ValueError:
        raise SystemExit(
            f"--{name} must be an int or lo:hi range, got {s!r}"
        )
    if lo < 1 or hi < lo:
        raise SystemExit(f"--{name} range {s!r} is empty or non-positive")
    return lo, hi


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="ddl_tpu_torch serve-bench", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--clients", type=int, default=8,
                    help="number of synthetic client requests")
    ap.add_argument("--prompt-len", default="8:16", metavar="N|LO:HI",
                    help="prompt length distribution (uniform)")
    ap.add_argument("--max-new", default="16", metavar="N|LO:HI",
                    help="output length distribution (uniform)")
    ap.add_argument("--arrival-s", type=float, default=0.0,
                    help="mean client interarrival seconds (exponential; "
                    "0 = all arrive at t0, the closed-burst worst case)")
    ap.add_argument("--scenario", default="none",
                    choices=["none", "shared-prefix", "long-prompt",
                             "bursty", "mixed", "multi-tenant"],
                    help="parameterized client mix (see module docstring); "
                    "'none' keeps the plain --prompt-len/--max-new mix")
    ap.add_argument("--shared-prefix-len", type=int, default=64,
                    help="shared system-prompt length for the "
                    "shared-prefix/mixed scenarios (tokens)")
    ap.add_argument("--long-prompt-len", type=int, default=256,
                    help="the long prompt's length for the "
                    "long-prompt/mixed scenarios (tokens)")
    ap.add_argument("--prefix-cache", default="auto",
                    choices=["auto", "on", "off"],
                    help="shared-prefix KV block reuse (refcounted pool "
                    "blocks + content-keyed index).  auto = on for "
                    "lossless pools, OFF for --int8 kv/kv+w (reused "
                    "prefixes there attend quantized rows — reuse is "
                    "token-accurate, not bit-identical, so it is an "
                    "explicit opt-in)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="max prompt tokens per prefill dispatch (power-"
                    "of-two multiple of --block-size); longer prompts run "
                    "as chunks interleaved with decode so they cannot "
                    "stall admission.  Auto-set for long-prompt/mixed "
                    "scenarios when omitted")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=None)
    # engine envelope
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--num-blocks", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--policy", default="reject",
                    choices=["reject", "shed_oldest"])
    ap.add_argument("--min-free-blocks", type=int, default=0,
                    help="pool watermark: keep this many blocks free "
                    "after every admission")
    ap.add_argument("--steps-per-dispatch", type=int, default=8,
                    help="max decode steps fused into one dispatch "
                    "(bounds admission latency; 1 = step-at-a-time)")
    ap.add_argument("--int8", default="none", choices=["none", "kv", "kv+w"],
                    help="int8 serving quantization (ops/quant.py): 'kv+w' also "
                    "int8 weights, whose products of at most 8 rows (the decode "
                    "batch) take the int8 small-M kernel")
    # model / mesh
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=0)
    ap.add_argument("--attn-window", type=int, default=0)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--seq", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the CPU)")
    # weights
    ap.add_argument("--checkpoint-dir", default=None,
                    help="serve a training snapshot (any layout); "
                    "omitted = random-init weights (smoke mode)")
    ap.add_argument("--job-id", default="serve-bench")
    ap.add_argument("--step", type=int, default=None,
                    help="snapshot step (required with --checkpoint-dir)")
    # obs / report
    ap.add_argument("--obs-log-dir", default=None,
                    help="emit decode/serve_*/kv_pool_stats events into "
                    "this log dir (the JAX package's `obs summarize` reads them)")
    ap.add_argument("--compare-sequential", action="store_true",
                    help="also run the one-request-at-a-time baseline "
                    "and report the throughput ratio")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip running every shape once before the clock "
                    "starts (requests that take a shape's first run are cold "
                    "and left out of the percentiles)")
    args = ap.parse_args(argv)

    from ddl_tpu_torch.examples.train_lm import require_one_device

    require_one_device(args)
    import numpy as np

    from ddl_tpu_torch.models.transformer import LMConfig, TransformerLM, init_lm_weights
    from ddl_tpu_torch.obs.serving import ServingStats, render_percentiles
    from ddl_tpu_torch.serve.engine import ServeEngine
    from ddl_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    p_lo, p_hi = _parse_range(args.prompt_len, "prompt-len")
    n_lo, n_hi = _parse_range(args.max_new, "max-new")

    cfg = LMConfig(
        vocab_size=256,
        d_model=args.d_model,
        n_layers=args.layers,
        n_heads=args.heads,
        n_kv_heads=args.kv_heads,
        head_dim=args.d_model // args.heads,
        d_ff=4 * args.d_model,
        attn_window=args.attn_window,
        compute_dtype="bfloat16" if device.type != "cpu" else "float32",
    )

    if args.checkpoint_dir:
        if args.step is None:
            raise SystemExit("--checkpoint-dir requires --step")
        params = _load_params(cfg, args)
    else:
        model = TransformerLM(cfg)
        init_lm_weights(model, args.seed)
        params = model.state_dict()
        del model
    params = {k: v.to(device) for k, v in params.items()}
    if args.int8 == "kv+w":
        from ddl_tpu_torch.ops.quant import quantize_lm_params

        params = quantize_lm_params(params)

    obs = None
    if args.obs_log_dir:
        from ddl_tpu_torch.obs import EventWriter

        obs = EventWriter(args.obs_log_dir, args.job_id)
        if args.scenario == "multi-tenant":
            _write_bench_slo(args.obs_log_dir, args.job_id)

    prefill_chunk = args.prefill_chunk
    if prefill_chunk is None and args.scenario in ("long-prompt", "mixed"):
        # the scenario exists to show chunked prefill keeping short
        # requests' queue delay bounded — default the smallest
        # power-of-two multiple of the block size at or above 64
        # tokens (the form ServeEngine validates; doubling the block
        # size always terminates, unlike padding 64 up to an arbitrary
        # block size)
        prefill_chunk = args.block_size
        while prefill_chunk < 64:
            prefill_chunk *= 2

    engine = ServeEngine(
        cfg, params,
        block_size=args.block_size, num_blocks=args.num_blocks,
        max_batch=args.max_batch, temperature=args.temperature,
        top_k=args.top_k, kv_quant=args.int8 != "none",
        max_queue=args.max_queue, policy=args.policy,
        min_free_blocks=args.min_free_blocks,
        max_steps_per_dispatch=args.steps_per_dispatch,
        prefix_cache=(
            "auto" if args.prefix_cache == "auto"
            else args.prefix_cache == "on"
        ),
        prefill_chunk=prefill_chunk,
        scenario=args.scenario if args.scenario != "none" else None,
        obs=obs,
        device=device,
    )

    clients = _make_clients(args, cfg, p_lo, p_hi, n_lo, n_hi)
    max_prompt = max(len(c["prompt"]) for c in clients)
    max_new_hi = max(c["max_new"] for c in clients)

    if not args.no_warmup:
        # run every reachable shape before the clock starts (the
        # sequential baseline warms all ITS shapes too — equal footing)
        pre = engine.precompile(max_prompt, max_new_hi)
        print(
            f"shapes run before timing: {pre['prefill']} prefill bucket(s), "
            f"{pre['decode']} decode program(s), "
            f"{pre['chunk']} chunk program(s)"
        )

    wall = run_clients(engine, clients, args.seed)

    # ---- report ---------------------------------------------------------
    results = engine.results
    out_tokens = sum(len(v) for v in results.values())
    agg = out_tokens / wall if wall > 0 else 0.0
    chips = 1
    st = engine.stats
    print("== serve-bench report ==")
    scen = f" | scenario: {args.scenario}" if args.scenario != "none" else ""
    print(
        f"clients: {args.clients} | completed: {st['completed']} | "
        f"shed: {st['shed']} | queue policy: {args.policy}{scen}"
    )
    print(
        f"engine: block_size={args.block_size} num_blocks={args.num_blocks} "
        f"max_batch={args.max_batch} int8={args.int8} "
        f"prefix_cache={'on' if engine.prefix is not None else 'off'} "
        f"prefill_chunk={prefill_chunk} | "
        f"peak lanes {engine.scheduler.peak_lanes}, peak blocks "
        f"{st['peak_blocks']}/{args.num_blocks}"
    )
    print(
        f"first runs (eager PyTorch compiles nothing; a shape's first run is "
        f"cold): prefill buckets {sorted(engine._run_buckets)} "
        f"({st['prefill_first_runs']}), decode {st['decode_first_runs']} | "
        f"decode steps: {st['decode_steps']}"
    )
    total_prompt = st["prefix_hit_tokens"] + st["prefill_tokens"]
    if engine.prefix is not None or st["prefix_hit_tokens"]:
        hit_rate = (
            st["prefix_hit_tokens"] / total_prompt if total_prompt else 0.0
        )
        alloc_stats = engine.allocator.stats()
        print(
            f"prefix cache: {st['prefix_hits']} hit(s), "
            f"{st['prefix_hit_tokens']}/{total_prompt} prompt tokens "
            f"cached ({hit_rate:.0%} hit rate) | prefill tokens computed: "
            f"{st['prefill_tokens']} in {st['prefill_chunks']} chunk "
            f"dispatch(es) | cow copies: {st['cow_copies']} | cached "
            f"blocks: {alloc_stats['cached']}, evictions: "
            f"{alloc_stats['evictions']}"
        )
    elif prefill_chunk is not None:
        print(
            f"prefill tokens computed: {st['prefill_tokens']} in "
            f"{st['prefill_chunks']} chunk dispatch(es)"
        )
    print(
        f"aggregate: {agg:.1f} tok/s over {wall:.2f}s "
        f"({agg / chips:.1f} tok/s/chip on {chips} chip(s))"
    )
    # user-level first-token time: the engine's ttft starts at ADMIT
    # (matching one-shot decode semantics), so a run that trades queue
    # delay for admission concurrency — exactly what the prefix cache
    # does — must be compared on submit -> first token
    e2e_ttft = sorted(
        r["queue_delay"] + r["ttft"] for r in engine.request_log
        if r.get("kind") == "decode"
        and r.get("queue_delay") is not None and r.get("ttft") is not None
    )
    if e2e_ttft:
        n_r = len(e2e_ttft)
        print(
            f"submit->first-token: p50 "
            f"{e2e_ttft[n_r // 2]:.3f}s p99 "
            f"{e2e_ttft[min(n_r - 1, int(0.99 * n_r))]:.3f}s "
            f"(queue delay + ttft over {n_r} request(s))"
        )
    if args.scenario in ("long-prompt", "mixed"):
        # the scenario's acceptance signal: short requests must not
        # inherit the long prompt's prefill time as queue delay
        short = [
            r["queue_delay"] for r in engine.request_log
            if r.get("kind") == "decode"
            and not str(r.get("request_id", "")).startswith("long")
            and r.get("queue_delay") is not None
        ]
        if short:
            short.sort()
            p99 = short[min(len(short) - 1, int(0.99 * len(short)))]
            print(
                f"short-request queue delay: p99 {p99:.3f}s max "
                f"{short[-1]:.3f}s over {len(short)} request(s)"
            )
    # the engine keeps the canonical per-request records in memory
    # (identical content to the emitted decode events), so the
    # percentile table renders with or without an event stream
    stats = ServingStats.from_events(engine.request_log)
    summary = stats.summary()
    if summary and summary.get("percentiles"):
        print("-- percentiles (warm requests) --")
        for line in render_percentiles(summary["percentiles"]):
            print(line)
    tenants = (summary or {}).get("tenants") or {}
    if tenants:
        # per-class separation is the scenario's acceptance signal:
        # each tenant's percentiles come from its OWN digest, so a
        # tail-heavy class can't hide inside the aggregate table above
        print("-- per-tenant (warm requests) --")
        print(
            f"{'tenant':<12} {'class':<14} {'reqs':>5} "
            f"{'p99 ttft':>9} {'p99 lat':>9} {'tokens':>8}"
        )
        for t in sorted(tenants):
            tb = tenants[t]
            pct = tb.get("percentiles") or {}

            def _p99(metric, pct=pct):
                v = (pct.get(metric) or {}).get("p99")
                return f"{v:>9.4g}" if v is not None else f"{'-':>9}"

            print(
                f"{t[:12]:<12} {(tb.get('class') or '-')[:14]:<14} "
                f"{tb.get('requests', 0):>5} {_p99('ttft_s')} "
                f"{_p99('latency_s')} {tb.get('tokens', 0):>8}"
            )
    if summary and summary.get("agg_tok_per_s") is not None:
        print(
            f"warm-span aggregate: {summary['agg_tok_per_s']:.1f} tok/s "
            f"({summary['agg_tok_per_s_per_chip']:.1f} tok/s/chip)"
        )

    if args.compare_sequential:
        seq_rate, seq_tokens = _sequential_baseline(
            cfg, params, clients, args, device
        )
        ratio = agg / seq_rate if seq_rate else float("inf")
        print(
            f"sequential baseline: {seq_rate:.1f} tok/s -> continuous "
            f"batching x{ratio:.2f}"
        )
        # the exactness gate: every completed request's tokens must be
        # bit-identical to its one-at-a-time LMDecode replay — the
        # prefix cache and chunked prefill change SCHEDULING, not tokens
        mismatched = [
            cid for cid, want in seq_tokens.items()
            if cid in results and not np.array_equal(results[cid], want)
        ]
        if mismatched:
            msg = (
                f"token MISMATCH vs sequential replay for "
                f"{len(mismatched)}/{len(seq_tokens)} request(s): "
                f"{mismatched[:8]}"
            )
            if args.int8 != "none" and engine.prefix is not None:
                # int8 pools store K/V lossily: a reused prefix is
                # attended at int8 precision while a fresh prefill
                # attends the raw activations — mismatches here are the
                # documented quantization tolerance, not a bug
                print(
                    f"note: {msg} (expected with int8 + prefix cache; "
                    "run --prefix-cache off to verify exactness)"
                )
            else:
                raise SystemExit(f"FAIL: {msg}")
        else:
            compared = sum(cid in results for cid in seq_tokens)
            skipped = len(seq_tokens) - compared
            print(
                f"token check: {compared} completed request(s) "
                "bit-identical to the sequential replay"
                + (f" ({skipped} shed/incomplete not compared)"
                   if skipped else "")
            )


def run_clients(engine, clients: list[dict], seed: int) -> float:
    """Submit each client at its arrival time (seconds from the start,
    ``_make_clients``) and step the engine until it drains; returns the
    wall seconds.  Every request samples with ``rng_seed=seed``."""
    t_start = perf_counter()
    pending = list(clients)
    while pending or engine.busy:
        now = perf_counter() - t_start
        while pending and pending[0]["arrival"] <= now:
            c = pending.pop(0)
            engine.submit(
                c["prompt"], c["max_new"], request_id=c["id"],
                submitted_at=t_start + c["arrival"],
                rng_seed=seed,
                tenant=c.get("tenant"),
                priority_class=c.get("priority_class"),
            )
        progressed = engine.step()
        if not progressed and pending:
            time.sleep(
                max(0.0, min(0.01, pending[0]["arrival"] - now))
            )
    return perf_counter() - t_start


def _make_clients(args, cfg, p_lo, p_hi, n_lo, n_hi) -> list[dict]:
    """Deterministic synthetic client mix for the selected scenario.
    Every client: {id, prompt, max_new, arrival} with arrivals in
    seconds from t0 (0.0 = present at start)."""
    import numpy as np

    rng = np.random.default_rng(args.seed)
    n = args.clients

    def toks(length):
        return rng.integers(0, cfg.vocab_size, int(length)).astype(np.int32)

    def rint(lo, hi):
        return int(rng.integers(lo, hi + 1))

    # arrivals: plain exponential gaps ("none"/"shared-prefix"/
    # "long-prompt" honor --arrival-s; 0 = closed burst), or grouped
    # Poisson bursts ("bursty"/"mixed": groups of 4 arrive together,
    # bursts spaced exponentially)
    def arrivals(count):
        if args.scenario in ("bursty", "mixed"):
            mean = args.arrival_s or 0.05
            out, t = [], 0.0
            for i in range(count):
                if i and i % 4 == 0:
                    t += rng.exponential(mean * 4)
                out.append(t)
            return out
        out, t = [], 0.0
        for _ in range(count):
            if args.arrival_s:
                t += rng.exponential(args.arrival_s)
            out.append(t)
        return out

    clients = []
    if args.scenario == "shared-prefix":
        prefix = toks(args.shared_prefix_len)
        for i in range(n):
            tail = toks(rint(p_lo, p_hi))
            clients.append({
                "id": f"c{i:04d}",
                "prompt": np.concatenate([prefix, tail]),
                "max_new": rint(n_lo, n_hi),
            })
    elif args.scenario == "long-prompt":
        # the long prompt goes FIRST: without chunked prefill it
        # monopolizes the loop and every short request queues behind it
        clients.append({
            "id": "long0000",
            "prompt": toks(args.long_prompt_len),
            "max_new": rint(n_lo, n_hi),
        })
        for i in range(1, n):
            clients.append({
                "id": f"c{i:04d}",
                "prompt": toks(rint(p_lo, p_hi)),
                "max_new": rint(n_lo, n_hi),
            })
    elif args.scenario == "mixed":
        prefix = toks(args.shared_prefix_len)
        for i in range(n):
            if i == 1:
                prompt = toks(args.long_prompt_len)
                cid = f"long{i:04d}"
            elif i % 2 == 0:  # half the crowd shares the system prompt
                prompt = np.concatenate([prefix, toks(rint(p_lo, p_hi))])
                cid = f"c{i:04d}"
            else:
                prompt = toks(rint(p_lo, p_hi))
                cid = f"c{i:04d}"
            clients.append(
                {"id": cid, "prompt": prompt, "max_new": rint(n_lo, n_hi)}
            )
    elif args.scenario == "multi-tenant":
        # weighted tenant mix: interactive traffic dominates and
        # arrives steadily, batch sends fewer/longer requests at a
        # slower rate, best-effort dumps its whole backlog at t0 —
        # three genuinely different distributions for the per-tenant
        # digests and SLO budgets to separate.  Each entry:
        # (tenant, priority class, weight, prompt range, max_new range,
        # arrival-gap multiplier on --arrival-s; 0 = all present at t0)
        mix = [
            ("acme", "interactive", 5, (p_lo, p_hi),
             (n_lo, max(n_lo, (n_lo + n_hi) // 2)), 1.0),
            ("bulk", "batch", 3, (p_hi, 2 * p_hi), (n_hi, n_hi), 3.0),
            ("scav", "best_effort", 2, (p_lo, p_hi), (n_lo, n_hi), 0.0),
        ]
        weights = np.array([m[2] for m in mix], dtype=float)
        draws = rng.choice(len(mix), size=n, p=weights / weights.sum())
        t_cls = [0.0] * len(mix)
        for i in range(n):
            k = int(draws[i])
            tenant, cls, _w, (plo, phi), (nlo, nhi), pace = mix[k]
            if pace and args.arrival_s:
                t_cls[k] += rng.exponential(args.arrival_s * pace)
            clients.append({
                "id": f"{tenant}-{i:04d}",
                "prompt": toks(rint(plo, phi)),
                "max_new": rint(nlo, nhi),
                "tenant": tenant,
                "priority_class": cls,
                "arrival": t_cls[k],
            })
        # the submit loop drains pending in list order against a
        # nondecreasing clock — interleave the per-class arrival
        # processes into one timeline
        clients.sort(key=lambda c: c["arrival"])
        return clients
    else:  # "none" and "bursty" use the plain length mix
        for i in range(n):
            clients.append({
                "id": f"c{i:04d}",
                "prompt": toks(rint(p_lo, p_hi)),
                "max_new": rint(n_lo, n_hi),
            })
    for c, t in zip(clients, arrivals(len(clients))):
        c["arrival"] = t
    return clients


def _write_bench_slo(log_dir, job_id) -> None:
    """Drop a declarative ``slo.json`` next to the run's event streams
    so ``obs slo <job>`` / ``obs diff --fail-slo-burn`` evaluate the
    bench without hand-authoring budgets.  Latency targets are generous
    (the smoke runs on CPU where absolute times mean little), so
    availability — 1 - shed rate — is the budget a mis-provisioned run
    actually burns."""
    import json
    from pathlib import Path

    job_dir = Path(log_dir) / "by_job_id" / str(job_id)
    job_dir.mkdir(parents=True, exist_ok=True)
    cfg = {
        "classes": {
            "interactive": {
                "p99_ttft_s": 30.0,
                "p99_latency_s": 60.0,
                "availability": 0.999,
            },
            "batch": {"p99_latency_s": 120.0, "availability": 0.99},
            "best_effort": {"availability": 0.9},
        },
        "default_class": "batch",
        "alerts": {"page_fast_burn": 14.4, "ticket_slow_burn": 2.0},
    }
    (job_dir / "slo.json").write_text(json.dumps(cfg, indent=2) + "\n")


def _sequential_baseline(cfg, params, clients, args, device):
    """One-request-at-a-time replay at equal per-request settings:
    ``make_lm_generator`` per distinct (prompt_len, max_new) at batch 1,
    each warmed, then all requests played back to back, each with its own
    generator seeded ``--seed`` (the engine's per-request draw).  Returns
    ``(tok_per_s, {client_id: tokens})`` — the tokens are the exactness
    reference ``--compare-sequential`` gates on."""
    import numpy as np
    import torch

    from ddl_tpu_torch.infer import make_lm_generator

    gens = {}
    for c in clients:
        key = (len(c["prompt"]), c["max_new"])
        if key not in gens:
            gens[key] = make_lm_generator(
                cfg, prompt_len=key[0], max_new=key[1], batch=1,
                temperature=args.temperature, top_k=args.top_k,
                kv_quant=args.int8 != "none", device=device,
            )

    def seeded():
        return torch.Generator(device).manual_seed(args.seed)

    # pay every shape's first run before timing (the engine's discipline)
    for (p, _n), gen in gens.items():
        gen(params, torch.zeros((1, p), dtype=torch.long), seeded()).cpu()
    t0 = perf_counter()
    total = 0
    tokens = {}
    for c in clients:
        gen = gens[(len(c["prompt"]), c["max_new"])]
        toks = gen(params, torch.from_numpy(c["prompt"][None, :].astype(np.int64)),
                   seeded()).cpu().numpy()
        tokens[c["id"]] = toks.reshape(-1).astype(np.int32)
        total += int(toks.size)
    dur = perf_counter() - t0
    return (total / dur if dur > 0 else 0.0), tokens


def _load_params(cfg, args):
    """Restore a training snapshot's model ``state_dict`` (the one-device
    layout; a pipelined JAX layout raises), as ``examples/generate_lm``
    does."""
    from ddl_tpu_torch.checkpoint import load_params, require_one_device_layout

    params = load_params(args.checkpoint_dir, args.job_id, args.step,
                         vocab_size=cfg.vocab_size)
    require_one_device_layout(params, "serve-bench")
    return params


if __name__ == "__main__":
    main()
