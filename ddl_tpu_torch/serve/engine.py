"""Continuous-batching serving engine over the paged KV pool (counterpart of
``ddl_tpu/serve/engine.py``, one device).

The JAX engine's program families, run eagerly in the same order:

* **prefill** (one per prompt-length bucket): ``infer.decode.LMDecode``'s
  causal forward over ONE prompt right-padded to a power-of-two multiple of
  the block size (causal attention makes right-padding exact: pad rows
  influence nothing before them), the first token sampled at the true
  prompt end (what TTFT covers), and the prompt's K/V scattered from its
  contiguous prefill cache into the request's pool blocks
  (``kv_pool.pool_write_prefill``).  The prompt pass rides the flash
  kernel where ``make_lm_generator`` would: ``cfg.flash`` True, or
  ``"auto"`` from ``FLASH_AUTO_MIN_T`` bucket rows on.
* **decode** (one per (chunk length K, block-table width)): K single-token
  steps for EVERY lane in one dispatch.  Each lane's block table is
  gathered ONCE per dispatch into a contiguous per-lane view; every step
  forwards the lanes' pending tokens through ``ServeDecode`` (the
  parameter names of ``TransformerLM``, so any LM ``state_dict`` or
  ``models/convert.lm_params_from_jax(tree)`` serves as it is), writes each
  lane's K/V row into the pool at its block-table position AND appends it
  to the view, then attends the view under a per-lane length mask
  (``ops.quant.kv_attend(use_kernel=True)``: on CUDA the bf16 or int8
  decode kernel behind ``decode_kernel_takes``, with one (B, L) bias row
  per lane).  The batch is always ``max_batch`` lanes (idle lanes write to
  a dropped block id and are masked); K and the table width are powers of
  two (K capped by ``max_steps_per_dispatch`` and the soonest lane
  completion), so the shapes the kernels see stay on a log x log grid.
* **chunk prefill** (one per (chunk bucket, view width, mode)): prompt rows
  computed against context already IN the pool -- an earlier chunk of the
  same request, or another request's blocks through the prefix cache.  As
  in JAX, where the chunk program's traced offset selects ``LMDecode``'s
  masked cached-attention branch even at offset 0, the chunk model is an
  ``LMDecode(masked_prefill=True)``.  Chunks interleave with decode
  dispatches in the scheduler loop.

Nothing compiles in eager PyTorch.  Where the JAX engine counts XLA
compiles, this engine counts a program shape's first run in the engine
(``stats["prefill_first_runs"]``, ``["decode_first_runs"]``): the run that
builds the kernels of a new process and warms cuBLAS and the allocator for
the shape.  Such a run marks its requests cold (excluded from the
percentiles), and the ``compiled`` field of the ``serve_admit`` and
``trace_span`` events, kept under the JAX name for the stream's readers,
means it.  ``precompile``/``warmup`` run every reachable shape once.

Sampling draws from one ``torch.Generator`` per request, seeded with its
``rng_seed`` (``sample_tokens``: the draws of a batch-1
``make_lm_generator`` call with that generator), so on the CPU the engine's
tokens are those of sequential batch-1 decodes.

The HBM ledger (``obs/hbm.py``), as in the JAX engine: one ``hbm_sample``
with every ``kv_pool_stats`` event (the weights, and the pool split into
the allocator's cached, private and free blocks), and one ``hbm_plan`` per
program shape, taken over that shape's first run (where the JAX engine
stamps one per compile; ``DDL_HBM_PLAN=off|aval``).

Left for later (ROADMAP.md): serving on a sharded mesh (item 11).
"""

from __future__ import annotations

import os
import time
from collections import deque, namedtuple
from functools import partial
from time import perf_counter

import numpy as np
import torch

from ddl_tpu_torch.infer.decode import LMDecode, init_kv_cache, sample_tokens
from ddl_tpu_torch.models.transformer import (
    Attention,
    Block,
    LMConfig,
    TransformerLM,
    _rope,
    apply_final_norm_and_head,
    dense_kernel_names,
)
from ddl_tpu_torch.ops.flash_attention import flash_attention, require_flash_kernel, use_flash
from ddl_tpu_torch.ops.int8_matvec import int8_matmul_small_m
from ddl_tpu_torch.ops.quant import QuantKV, kv_attend, kv_decode, kv_slice, quantize_q8
from ddl_tpu_torch.parallel.sharding import require_lm_one_device
from ddl_tpu_torch.serve.admission import AdmissionController
from ddl_tpu_torch.serve.kv_pool import (
    BlockAllocator,
    PrefixIndex,
    apply_block_permutation,
    blocks_for,
    cache_write_token,
    init_kv_pool,
    pool_copy_block,
    pool_gather,
    pool_write_prefill,
    pool_write_token,
    token_targets,
)
from ddl_tpu_torch.serve.scheduler import ContinuousScheduler, Request, tenant_tags
from ddl_tpu_torch.utils.device import resolve_device

__all__ = [
    "MIN_CHUNK_VIEW_ROWS", "ServeAttention", "ServeBlock", "ServeDecode", "ServeEngine",
    "make_serve_step_fns", "pow2_at_least", "pow2_at_most", "prompt_bucket",
]


def prompt_bucket(prompt_len: int, block_size: int) -> int:
    """Padded prompt length: the smallest power-of-two multiple of
    ``block_size`` at or above ``prompt_len`` -- O(log) distinct prefill
    shapes over any prompt-length distribution."""
    if prompt_len < 1:
        raise ValueError(f"prompt_len must be >= 1, got {prompt_len}")
    n = 1
    while n * block_size < prompt_len:
        n *= 2
    return n * block_size


def pow2_at_most(n: int) -> int:
    """Largest power of two <= n (n >= 1) -- chunk lengths are floored to
    this so the decode grid stays logarithmic."""
    if n < 1:
        raise ValueError(f"need n >= 1, got {n}")
    return 1 << (n.bit_length() - 1)


def pow2_at_least(n: int) -> int:
    """Smallest power of two >= n (n >= 1) -- block-table widths are
    rounded up to this, same reasoning."""
    if n < 1:
        raise ValueError(f"need n >= 1, got {n}")
    return 1 << (n - 1).bit_length()


class ServeAttention(Attention):
    """One cached-attention step over the paged pool for every lane, with
    ``Attention``'s parameters (q/k/v/out, int8 kernels included).

    ``x`` (B, 1, D); ``targets``: the step's pool writes
    (``kv_pool.token_targets``); ``lengths`` (B,): each lane's position;
    ``mask`` (B, 1, L) bool: the keys each lane attends."""

    def forward(self, x, pool, cache, targets, lengths, mask):
        cfg = self.cfg
        b, t, _ = x.shape
        q = self.q(x).reshape(b, t, cfg.n_heads, cfg.head_dim)
        k = self.k(x).reshape(b, t, cfg.kv_heads, cfg.head_dim)
        v = self.v(x).reshape(b, t, cfg.kv_heads, cfg.head_dim)
        positions = lengths[:, None] + torch.arange(t, device=x.device)[None, :]
        q = _rope(q, cfg.rope_theta, positions)
        k = _rope(k, cfg.rope_theta, positions)
        # each lane's row lands in the pool (idle lanes' writes are dropped)
        # and at the same index of the dispatch's gathered view: lane b's
        # view row (lengths // bs) * bs + lengths % bs == lengths, so
        # attention here equals attention over a fresh gather; an int8
        # pool's rows are quantized once for both writes
        if isinstance(pool, QuantKV):
            k, v = quantize_q8(k), quantize_q8(v)
        pool_write_token(pool, k, v, None, None, targets=targets)
        cache_write_token(cache, k, v, lengths)
        o = kv_attend(q, cache, mask, use_kernel=True, decode=self.decode_attend)
        return self.out(o.reshape(b, t, cfg.n_heads * cfg.head_dim)), pool, cache


class ServeBlock(Block):
    """Pre-norm decoder block over the paged pool: ``Block``'s decode path
    with the contiguous cache swapped for (pool, view, write targets,
    lengths, mask)."""

    def __init__(self, cfg: LMConfig, decode_attend=kv_decode,
                 int8_matmul=int8_matmul_small_m) -> None:
        super().__init__(cfg, None, decode_attend, int8_matmul)
        self.attn = ServeAttention(cfg, None, decode_attend, int8_matmul)

    def forward(self, x, pool, cache, targets, lengths, mask):
        a, pool, cache = self.attn(self.norm_attn(x), pool, cache, targets, lengths, mask)
        x = x + a
        h = self.norm_mlp(x)
        y = self.moe(h)[0] if self.is_moe else self.mlp(h)
        return x + y, pool, cache


class ServeDecode(TransformerLM):
    """One batched decode step over the full layer stack; submodule names
    are ``TransformerLM``'s, so its ``state_dict`` loads as it is."""

    def __init__(self, cfg: LMConfig, decode_attend=kv_decode,
                 int8_matmul=int8_matmul_small_m) -> None:
        super().__init__(cfg, None, decode_attend, int8_matmul)
        for i in range(cfg.n_layers):
            setattr(self, f"block{i}", ServeBlock(cfg, decode_attend, int8_matmul))

    def forward(self, tokens, pools, caches, targets, lengths, mask):
        x = self.embed(tokens)
        for i, block in enumerate(self.blocks()):
            x, _, _ = block(x, pools[i], caches[i], targets, lengths, mask)
        return apply_final_norm_and_head(self, x), pools, caches


ServeStepFns = namedtuple(
    "ServeStepFns",
    ["prefill_for", "chunk_for", "decode_for", "load", "models", "cfg", "device",
     "block_size", "num_blocks", "max_batch", "max_blocks_per_seq", "kv_quant",
     "init_pools"],
)

# Minimum gathered-view rows for the CHUNK prefill programs (Tq > 1 masked
# attention over a pool view), the JAX engine's clamp: XLA's masked cached
# attention reproduced its fused causal prefill bit for bit from 64-row
# views on, and 16/32-row views drifted ~1e-6.  Kept so that the port's
# chunk shapes are the JAX engine's.
MIN_CHUNK_VIEW_ROWS = 64


def make_serve_step_fns(
    cfg: LMConfig,
    *,
    block_size: int,
    num_blocks: int,
    max_batch: int,
    max_blocks_per_seq: int | None = None,
    temperature: float = 0.0,
    top_k: int | None = None,
    kv_quant: bool = False,
    device=None,
):
    """Build the serving engine's program families over one set of weights.

    Returns a ``ServeStepFns``: ``load(params)`` places a ``TransformerLM``
    ``state_dict`` (f32 masters, or ``ops.quant.quantize_lm_params``'s int8
    dict) in every model once (the dense kernels cast to the compute dtype,
    int8 ones kept); ``prefill_for(bucket)`` is the per-bucket prefill,
    ``decode_for(k, nmax)`` and ``chunk_for(cb, nmax, mode)`` return
    ``(program, first_use)``.  Programs write the pools in place and take
    one ``torch.Generator`` per request (``None`` for an idle lane).
    ``models`` names the modules that hold the weights: ``"decode"`` (the
    ``ServeDecode``), ``"chunk"`` and the prefills ``"prefill"`` and
    ``"prefill_flash"`` (``LMDecode``s).  ``device`` None means CUDA, as
    ``make_lm_generator``'s."""
    if not cfg.causal:
        raise ValueError("serving decode requires a causal LM")
    if top_k is not None and temperature == 0.0:
        raise ValueError("top_k has no effect with temperature=0 (greedy decoding)")
    if max_blocks_per_seq is None:
        max_blocks_per_seq = num_blocks
    if max_blocks_per_seq > num_blocks:
        raise ValueError(f"max_blocks_per_seq {max_blocks_per_seq} > pool size {num_blocks}")
    device = resolve_device(device)
    require_flash_kernel(cfg, device.type)
    with torch.device("meta"):
        model = ServeDecode(cfg)
        chunk_model = LMDecode(cfg, masked_prefill=True)
        pre_models = {False: LMDecode(cfg),
                      True: LMDecode(cfg, attn_core=partial(flash_attention, causal=True,
                                                            window=cfg.attn_window))}
    models = (model, chunk_model, *pre_models.values())
    cast_names = set(dense_kernel_names(model))

    def load(params) -> None:
        weights = {k: v.to(device=device, dtype=cfg.dtype if k in cast_names
                           and v.is_floating_point() else v.dtype)
                   for k, v in params.items()}
        for m in models:  # the same tensors in every model
            m.load_state_dict(weights, assign=True)

    def sample(logits, gen):
        """(1, V) logits -> (1,) token: ``make_lm_generator``'s draw."""
        return sample_tokens(logits, temperature, top_k, gen)

    def sample_lanes(last, gens):
        """(B, V) -> (B,): greedy in one argmax; sampled lane by lane, each
        from its request's generator (an idle lane takes the argmax)."""
        toks = torch.argmax(last, dim=-1)
        if temperature != 0.0:
            for b, gen in enumerate(gens):
                if gen is not None:
                    toks[b:b + 1] = sample(last[b:b + 1], gen)
        return toks

    lanes = torch.arange(max_batch, device=device)

    def _decode_chunk(pools, tables, lengths, pending, gens, *, k):
        """K single-token steps for every lane; returns toks (K, B) on the
        device.  ``tables`` (B, nmax), ``lengths``/``pending`` (B,) on the
        device."""
        nmax = tables.shape[1]
        caches = tuple(pool_gather(p, tables) for p in pools)
        key_pos = torch.arange(nmax * block_size, device=device)
        toks = []
        with torch.inference_mode():
            for _ in range(k):
                blk = tables[lanes, torch.clamp(lengths // block_size, max=nmax - 1)]
                targets = token_targets(blk, lengths % block_size, num_blocks)
                # lane b's query sits at position lengths[b] (its row is
                # written first): the mask of the contiguous decode, per lane
                mask = key_pos[None, None, :] <= lengths[:, None, None]
                if cfg.attn_window:
                    mask &= key_pos[None, None, :] > lengths[:, None, None] - cfg.attn_window
                logits, _, _ = model(pending[:, None], pools, caches, targets, lengths, mask)
                pending = sample_lanes(logits[:, 0], gens)
                toks.append(pending)
                lengths = lengths + 1
        return torch.stack(toks)

    _decode_cache: set = set()

    def decode_for(k: int, nmax: int):
        """The K-step decode over (B, nmax) block tables: ``(program,
        first_use)``; callers pass power-of-two ``k``/``nmax``."""
        first = (k, nmax) not in _decode_cache
        _decode_cache.add((k, nmax))
        return partial(_decode_chunk, k=k), first

    _prefill_cache: dict[int, object] = {}

    def prefill_for(bucket_len: int):
        """The prefill+first-token program for one prompt-length bucket:
        ``(pools, prompt (1, Pb), block_ids (Pb / bs,), true_len, gen) ->
        tok0`` (a 0-d tensor on the device)."""
        if bucket_len % block_size:
            raise ValueError(
                f"bucket {bucket_len} must be a multiple of block_size {block_size}")
        prog = _prefill_cache.get(bucket_len)
        if prog is not None:
            return prog
        pre_model = pre_models[use_flash(cfg, bucket_len, device.type)]

        def _prefill(pools, prompt, block_ids, true_len, gen):
            with torch.inference_mode():
                caches = init_kv_cache(cfg, 1, bucket_len, quant=kv_quant, device=device)
                # logits at the TRUE prompt end: right-pad rows are causally
                # invisible, and last_index slices before the final norm and
                # head, which run on the generator's (1, 1, D) shape
                logits, caches = pre_model(prompt, caches, 0, last_index=true_len - 1)
                tok0 = sample(logits[:, 0], gen)[0]
                for i in range(cfg.n_layers):
                    pool_write_prefill(pools[i], caches[i], block_ids)
            return tok0

        _prefill_cache[bucket_len] = _prefill
        return _prefill

    _chunk_cache: set = set()

    def chunk_for(cb: int, nmax: int, mode: str = "final"):
        """The CHUNK prefill over one request's block table: ``(pools,
        tokens (1, cb), table (nmax,), off, last_index, gen)`` computes
        prompt rows [off, off + cb) against the context [0, off) gathered
        from the pool and scatters them into the table's blocks; ``"mid"``
        returns None, ``"final"`` the first token sampled at
        ``last_index`` (the one-shot prefill's draw).  ``off`` is
        block-aligned.  Returns ``(program, first_use)``."""
        if mode not in ("mid", "final"):
            raise ValueError(f"unknown chunk mode {mode!r}")
        if cb % block_size:
            raise ValueError(f"chunk {cb} must be a multiple of block_size {block_size}")
        first = (cb, nmax, mode) not in _chunk_cache
        _chunk_cache.add((cb, nmax, mode))

        def _chunk(pools, tokens, table, off, last_index, gen):
            with torch.inference_mode():
                caches = tuple(pool_gather(p, table[None, :]) for p in pools)
                logits, caches = chunk_model(tokens, caches, off,
                                             last_index=last_index if mode != "mid" else 0)
                ids = table[off // block_size:(off + cb) // block_size]
                for i in range(cfg.n_layers):
                    pool_write_prefill(pools[i], kv_slice(caches[i], off, cb), ids)
                if mode == "mid":
                    return None
                return sample(logits[:, 0], gen)[0]

        return _chunk, first

    return ServeStepFns(
        prefill_for=prefill_for, chunk_for=chunk_for, decode_for=decode_for, load=load,
        models={"decode": model, "chunk": chunk_model, "prefill": pre_models[False],
                "prefill_flash": pre_models[True]},
        cfg=cfg, device=device, block_size=block_size,
        num_blocks=num_blocks, max_batch=max_batch,
        max_blocks_per_seq=max_blocks_per_seq, kv_quant=kv_quant,
        init_pools=lambda: init_kv_pool(cfg, num_blocks, block_size, quant=kv_quant,
                                        device=device),
    )


def _fence(pools) -> None:
    """Wait for the pools' last writes (one element read back)."""
    p = pools[0]
    (p.kq if isinstance(p, QuantKV) else p[0]).view(-1)[:1].cpu()


class ServeEngine:
    """The serving loop: admission queue -> continuous decode batch.

    ``submit()`` enqueues prompts (admission control may shed); ``step()``
    runs one scheduler iteration (retire, admit+prefill, one prefill chunk,
    one batched decode dispatch); ``run()`` loops until drained and returns
    ``{request_id: np.ndarray of sampled tokens}``.  Per-request ``decode``
    obs events (duration, queue delay, a fenced TTFT, tokens/s) feed the
    same percentiles as the one-shot path, beside the ``serve_admit``/
    ``serve_retire``/``serve_shed``/``kv_pool_stats`` engine events.

    ``params`` is a ``TransformerLM`` ``state_dict`` (or the int8 dict of
    ``ops.quant.quantize_lm_params``).  The engine serves on one device
    (sharded serving is item 11: a ``spec`` with an axis above 1 raises);
    ``device`` None means CUDA."""

    def __init__(
        self,
        cfg: LMConfig,
        params,
        *,
        block_size: int = 16,
        num_blocks: int = 64,
        max_batch: int = 8,
        max_blocks_per_seq: int | None = None,
        temperature: float = 0.0,
        top_k: int | None = None,
        kv_quant: bool = False,
        max_queue: int = 64,
        policy: str = "reject",
        min_free_blocks: int = 0,
        max_steps_per_dispatch: int = 8,
        defrag_threshold: float | None = None,
        prefix_cache: bool | str = "auto",
        prefill_chunk: int | None = None,
        scenario: str | None = None,
        trace_sample: int | None = None,
        obs=None,
        trace_requests: bool = True,
        guard=None,
        device=None,
        spec=None,
    ) -> None:
        require_lm_one_device(spec, "ServeEngine")
        self.fns = make_serve_step_fns(
            cfg, block_size=block_size, num_blocks=num_blocks,
            max_batch=max_batch, max_blocks_per_seq=max_blocks_per_seq,
            temperature=temperature, top_k=top_k, kv_quant=kv_quant, device=device,
        )
        self.fns.load(params)
        self.cfg = cfg
        self.device = self.fns.device
        self.obs = obs
        # per-request causal tracing: a root span plus queue/prefill/
        # decode-dispatch children per request; 1-in-N by request sequence
        # number with ``trace_sample`` (default DDL_OBS_TRACE_SAMPLE, else 1)
        self.trace_requests = bool(trace_requests)
        if trace_sample is None:
            try:
                trace_sample = int(os.environ.get("DDL_OBS_TRACE_SAMPLE") or 1)
            except ValueError:
                trace_sample = 1
        self.trace_sample = max(1, int(trace_sample))
        self.defrag_threshold = defrag_threshold
        # prefix caching: "auto" enables it for lossless (non-int8) pools
        # only -- an int8 pool stores K/V lossily, so a reused prefix is
        # attended at quantization precision while a fresh prefill attends
        # the raw activations; with int8 it is an explicit opt-in
        if prefix_cache == "auto":
            prefix_cache = not kv_quant
        self.prefix = PrefixIndex(block_size) if prefix_cache else None
        # chunked prefill: a prompt longer than this runs as bounded chunks
        # interleaved with decode dispatches, so one long prompt cannot
        # stall admission
        if prefill_chunk is not None:
            if (prefill_chunk < block_size
                    or prompt_bucket(prefill_chunk, block_size) != prefill_chunk):
                raise ValueError(
                    f"prefill_chunk must be a power-of-two multiple of "
                    f"block_size {block_size}, got {prefill_chunk}")
        self.prefill_chunk = prefill_chunk
        self.scenario = scenario
        self.pools = self.fns.init_pools()
        self.allocator = BlockAllocator(num_blocks, block_size)
        if self.prefix is not None:
            self.allocator.on_evict = self.prefix.forget_block
        self.scheduler = ContinuousScheduler(
            self.allocator, max_batch, self.fns.max_blocks_per_seq,
            min_free_blocks=min_free_blocks, prefix_index=self.prefix,
        )
        self.admission = AdmissionController(
            max_queue=max_queue, policy=policy, obs=obs,
            on_shed=self._record_shed, trace=self.trace_requests,
        )
        if max_steps_per_dispatch < 1:
            raise ValueError(
                f"max_steps_per_dispatch must be >= 1, got {max_steps_per_dispatch}")
        self.max_steps_per_dispatch = int(max_steps_per_dispatch)
        self.results: dict[str, np.ndarray] = {}
        self.outcomes: dict[str, str] = {}  # id -> ok | shed:<reason> | parked:<reason>
        # per-request decode records (the emitted events' fields), so the
        # percentiles work without an EventWriter too; bounded (the durable
        # stream is the EventWriter), and results/outcomes are the caller's
        # to drain through pop_result()
        self.request_log: deque = deque(maxlen=65536)
        self._gens: list = [None] * max_batch  # each lane's request generator
        self._req_counter = 0
        self.stats = {
            "submitted": 0, "completed": 0, "shed": 0,
            "prefill_first_runs": 0, "decode_first_runs": 0,
            "decode_steps": 0, "decode_dispatches": 0, "peak_blocks": 0,
            "prefix_hits": 0, "prefix_hit_tokens": 0, "prefix_inserts": 0,
            "prefill_tokens": 0, "prefill_chunks": 0, "cow_copies": 0,
        }
        self._run_buckets: set[int] = set()
        # HBM ledger: the per-block and weight bytes, computed once
        self._hbm_block_bytes: int | None = None
        self._hbm_params_bytes: int | None = None
        # preempt-drain: ``guard`` (anything with ``.requested``, e.g. a
        # utils/preemption.PreemptionGuard) is polled at every step(); when
        # it trips the engine drains (admission closed, queued requests
        # shed, in-flight lanes finishing) instead of dying mid-dispatch
        self.guard = guard
        self.draining = False
        self.drain_reason: str | None = None
        # drain(park=True)'s resume records: the request, its partial
        # outputs and its generator's state
        self.parked: dict[str, dict] = {}

    # -- submission -------------------------------------------------------
    def submit(
        self, prompt, max_new: int, request_id: str | None = None,
        submitted_at: float | None = None, rng_seed: int = 0,
        tenant: str | None = None, priority_class: str | None = None,
    ) -> str:
        """Offer one prompt; returns its admission outcome (see
        ``AdmissionController.offer``).  ``tenant``/``priority_class`` tag
        every event the request emits."""
        if request_id is None:
            request_id = f"r{self._req_counter:05d}"
        seq = self._req_counter
        self._req_counter += 1
        req = Request(
            id=request_id,
            prompt=np.asarray(prompt, np.int32).reshape(-1),
            max_new=int(max_new),
            submitted_at=perf_counter() if submitted_at is None else submitted_at,
            rng_seed=rng_seed,
            # 1-in-N trace sampling by request sequence number (no RNG):
            # re-runs sample the same requests
            traced=self.trace_requests and seq % self.trace_sample == 0,
            tenant=str(tenant) if tenant else None,
            priority_class=str(priority_class) if priority_class else None,
        )
        self.stats["submitted"] += 1
        if self.draining:
            # admission is closed: shed at the door, tenant-tagged
            self.admission.shed_request(req, "draining")
            outcome = "rejected"
        else:
            outcome = self.admission.offer(req, fits_ever=self.scheduler.fits_ever(req))
        if outcome == "rejected":
            self.stats["shed"] += 1
        return outcome

    def _record_shed(self, req: Request, reason: str) -> None:
        self.outcomes[req.id] = f"shed:{reason}"
        if reason == "queue_full" and self.admission.policy == "shed_oldest":
            self.stats["shed"] += 1

    @property
    def busy(self) -> bool:
        return bool(self.scheduler.active()) or bool(self.admission.queue)

    # -- engine iteration -------------------------------------------------
    def _emit_trace_span(
        self, name: str, t0_pc: float, t1_pc: float, *,
        trace: str, span: str, parent: str | None, traced: bool = True, **args,
    ) -> None:
        """One completed causal span into the obs stream, its
        ``perf_counter`` stamps mapped to wall clock through the current
        (wall, perf_counter) pair; ``traced`` is the request's sampling
        decision."""
        if self.obs is None or not self.trace_requests or not traced:
            return
        wall, pc = time.time(), perf_counter()
        self.obs.emit(
            "trace_span", trace=trace, span=span, parent=parent, name=name, cat="serve",
            t0=wall - (pc - t0_pc), t1=wall - (pc - t1_pc), **args,
        )

    def _emit_pool_stats(self, **extra) -> None:
        if self.obs is not None:
            stats = self.allocator.stats()
            self.obs.emit(
                "kv_pool_stats", **stats,
                queue_depth=len(self.admission),
                active_lanes=len(self.scheduler.active()), **extra,
            )
            self._emit_hbm_sample(stats)

    def _emit_hbm_sample(self, stats: dict) -> None:
        """One ``hbm_sample`` per pool-stats emission: the weights, and the
        KV pool split by what the allocator knows: ``kv_private``
        (lane-owned), ``kv_cached`` (refcount-0 prefix blocks kept for
        reuse), ``kv_free`` (headroom).  The three partition the pool, so
        their sum is its whole footprint."""
        from ddl_tpu_torch.obs import hbm

        if self._hbm_block_bytes is None:
            pool_bytes = hbm.tree_shard_bytes(self.pools) or 0
            self._hbm_block_bytes = pool_bytes // max(1, self.fns.num_blocks)
            self._hbm_params_bytes = hbm.tree_shard_bytes(
                self.fns.models["decode"].state_dict())
        bb = self._hbm_block_bytes
        hbm.live_sample(
            self.obs, params_bytes=self._hbm_params_bytes,
            kv_cached_bytes=stats["cached"] * bb, kv_private_bytes=stats["used"] * bb,
            kv_free_bytes=stats["free"] * bb, context="serve", device=self.device,
        )

    def _run_program(self, first: bool, label: str, prog, *args):
        """``prog(*args)``; a program shape's first run goes through
        ``obs/hbm.plan_program``, which emits its ``hbm_plan``."""
        if not first or self.obs is None:
            return prog(*args)
        from ddl_tpu_torch.obs import hbm

        mode = hbm.plan_mode()
        if mode == "off":
            return prog(*args)
        return hbm.plan_program(self.obs, label, prog, args, mode=mode, resident=self.pools,
                                device=self.device)[0]

    def _retire_finished(self) -> None:
        for state in self.scheduler.finished():
            self.scheduler.retire(state.lane)
            self._gens[state.lane] = None
            req = state.request
            toks = state.outputs
            if req.resume_prefix is not None:
                # a resumed request: the tokens generated before the park,
                # then this incarnation's
                toks = list(req.resume_prefix) + list(state.outputs)
            self.results[req.id] = np.asarray(toks, np.int32)
            self.outcomes[req.id] = "ok"
            self.stats["completed"] += 1
            end = state.finished_at or perf_counter()
            dur = max(end - state.admitted_at, 1e-9)
            queue_delay = (max(0.0, state.admitted_at - req.submitted_at)
                           if req.submitted_at is not None else 0.0)
            record = dict(
                request_id=req.id, prompt_len=req.prompt_len,
                new_tokens=len(state.outputs), batch=1, dur=dur,
                queue_delay=queue_delay, ttft=state.ttft_s,
                tok_per_s=len(state.outputs) / dur, warm=not state.cold, chips=1,
                engine="serve", **tenant_tags(req),
            )
            self.request_log.append({"kind": "decode", "ts": time.time(), **record})
            # the trace ROOT: submit -> retire
            self._emit_trace_span(
                "request",
                req.submitted_at if req.submitted_at is not None else state.admitted_at,
                end, trace=req.id, span=f"{req.id}/req", parent=None, traced=req.traced,
                request_id=req.id, lane=state.lane, prompt_len=req.prompt_len,
                new_tokens=len(state.outputs), dispatches=len(state.dispatches),
                outcome="ok", cached_tokens=state.cached_tokens, **tenant_tags(req),
            )
            if self.obs is not None:
                self.obs.emit("decode", **record)
                self.obs.emit(
                    "serve_retire", request_id=req.id, lane=state.lane,
                    new_tokens=len(state.outputs), dur=dur,
                    freed_blocks=len(state.block_ids), **tenant_tags(req),
                )
                self._emit_pool_stats()

    def _admit_one(self, req: Request, shared: list[int] | None = None) -> None:
        state = self.scheduler.try_admit(req, shared)
        assert state is not None  # the caller checked can_admit
        fns = self.fns
        t0 = perf_counter()
        state.admitted_at = t0
        # the pool peak is set at ADMISSION (the reservation just happened)
        self.stats["peak_blocks"] = max(self.stats["peak_blocks"], self.allocator.used_blocks)
        if state.cached_tokens:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_hit_tokens"] += state.cached_tokens
            if self.obs is not None:
                self.obs.emit(
                    "prefix_hit", request_id=req.id, cached_tokens=state.cached_tokens,
                    blocks=state.shared_blocks, prompt_len=req.prompt_len,
                )
        # chunked prefill engages when the prompt continues a cached prefix
        # or exceeds the chunk bound; otherwise the whole-prompt bucketed
        # prefill runs inline
        chunked = state.prefill_pos > 0 or (
            self.prefill_chunk is not None and req.prompt_len > self.prefill_chunk)
        if not chunked:
            self._full_prefill(state, t0)
        if req.submitted_at is not None and req.submitted_at < t0:
            self._emit_trace_span(
                "queue", req.submitted_at, t0, trace=req.id, span=f"{req.id}/queue",
                parent=f"{req.id}/req", traced=req.traced, request_id=req.id,
                **tenant_tags(req),
            )
        if self.obs is not None:
            self.obs.emit(
                "serve_admit", request_id=req.id, lane=state.lane,
                bucket=prompt_bucket(req.prompt_len, fns.block_size),
                prompt_len=req.prompt_len, max_new=req.max_new,
                blocks=len(state.block_ids), cached_tokens=state.cached_tokens,
                prefill_tokens=req.prompt_len - state.cached_tokens,
                queue_delay=(max(0.0, t0 - req.submitted_at)
                             if req.submitted_at is not None else 0.0),
                # an inline full prefill's first-run flag; a chunked
                # admission has run nothing yet (its chunks' flags ride the
                # prefill trace spans)
                compiled=state.cold, chunked=chunked,
                **({"scenario": self.scenario} if self.scenario else {}),
                **tenant_tags(req),
            )
            self._emit_pool_stats()

    def _prefill_rng(self, req: Request) -> torch.Generator:
        """The generator a prefill samples with: seeded with ``rng_seed``,
        or, for a resumed request, the parked lane's generator state, so
        the continuation draws exactly what the interrupted decode would
        have."""
        gen = torch.Generator(self.device)
        if req.resume_rng is not None:
            gen.set_state(req.resume_rng)
        else:
            gen.manual_seed(req.rng_seed)
        return gen

    def _full_prefill(self, state, t0: float) -> None:
        """The whole-prompt bucketed prefill, inline at admission (prompts
        with no cached prefix, within the chunk bound)."""
        req = state.request
        fns = self.fns
        bucket = prompt_bucket(req.prompt_len, fns.block_size)
        first_run = bucket not in self._run_buckets
        prompt = np.zeros((1, bucket), np.int64)
        prompt[0, : req.prompt_len] = req.prompt
        ids = np.full((bucket // fns.block_size,), fns.num_blocks, np.int64)
        n = min(len(ids), len(state.block_ids))
        ids[:n] = state.block_ids[:n]
        gen = self._prefill_rng(req)
        tok0 = self._run_program(
            first_run, f"serve_prefill_b{bucket}", fns.prefill_for(bucket),
            self.pools, torch.from_numpy(prompt).to(self.device),
            torch.from_numpy(ids).to(self.device), req.prompt_len, gen)
        tok0 = int(tok0)  # fences the first token: a REAL TTFT
        self._run_buckets.add(bucket)
        if first_run:
            self.stats["prefill_first_runs"] += 1
        self.stats["prefill_tokens"] += req.prompt_len
        self._emit_trace_span(
            "prefill", t0, perf_counter(), trace=req.id, span=f"{req.id}/prefill",
            parent=f"{req.id}/req", traced=req.traced, request_id=req.id, lane=state.lane,
            bucket=bucket, compiled=first_run, **tenant_tags(req),
        )
        self._finish_prefill(state, tok0, gen, cold=first_run)

    def _finish_prefill(self, state, tok0: int, gen, cold: bool) -> None:
        """Common prefill completion: the first token recorded (already
        fenced), the generator parked in the lane, the prompt's blocks
        registered in the prefix index."""
        req = state.request
        state.ttft_s = perf_counter() - state.admitted_at
        state.pending_tok = tok0
        state.outputs.append(tok0)
        state.cold = state.cold or cold
        state.prefill_done = True
        state.prefill_pos = req.prompt_len
        state.length = req.prompt_len
        if state.done:
            state.finished_at = perf_counter()
        self._gens[state.lane] = gen
        self.stats["peak_blocks"] = max(self.stats["peak_blocks"], self.allocator.used_blocks)
        if self.prefix is not None:
            n = self.prefix.insert(req.prompt, state.block_ids, self.allocator,
                                   keys=req.chain_keys)
            if n:
                self.stats["prefix_inserts"] += n
                if self.obs is not None:
                    self.obs.emit("prefix_insert", request_id=req.id, blocks=n,
                                  tokens=n * self.fns.block_size)

    # -- chunked prefill --------------------------------------------------
    def _view_blocks(self, n_blocks: int) -> int:
        """Block-table width for a chunk program over an ``n_blocks``
        reservation: rounded up to a power of two, floored at
        MIN_CHUNK_VIEW_ROWS rows, capped by the engine envelope (the one
        width formula ``precompile`` walks too)."""
        fns = self.fns
        vmin = pow2_at_least(blocks_for(max(MIN_CHUNK_VIEW_ROWS, fns.block_size),
                                        fns.block_size))
        return min(fns.max_blocks_per_seq, max(pow2_at_least(n_blocks), vmin))

    def _chunk_view_blocks(self, state) -> int:
        return self._view_blocks(len(state.block_ids))

    def _cow(self, state, block_index: int) -> None:
        """Copy-on-write: the lane is about to write into a block other
        tables (or the prefix index) still need -- give it a private
        bit-identical copy first (the target pre-allocated at admission
        when the trigger was known, else drawn from the pool)."""
        src = state.block_ids[block_index]
        if state.cow_block is not None:
            dst, state.cow_block = state.cow_block, None
        else:  # structurally unreachable today; the guard stays honest
            dst = self.allocator.alloc(1)[0]
        pool_copy_block(self.pools, src, dst)
        state.block_ids[block_index] = dst
        self.allocator.free([src])  # drop this lane's share of the original
        self.stats["cow_copies"] += 1
        if self.obs is not None:
            self.obs.emit("kv_cow_copy", request_id=state.request.id, src=src, dst=dst,
                          block_index=block_index)

    def _advance_prefill(self) -> None:
        """Run ONE chunk of the oldest still-prefilling lane -- the
        interleaving that bounds how long any prompt keeps the batched
        decode waiting."""
        lanes = [s for s in self.scheduler.active() if not s.prefill_done]
        if lanes:
            self._prefill_chunk(min(lanes, key=lambda s: s.admitted_at))

    def _prefill_chunk(self, state) -> None:
        fns = self.fns
        req = state.request
        p = req.prompt_len
        off = state.prefill_pos
        remaining = p - off
        c = min(remaining, self.prefill_chunk if self.prefill_chunk else remaining)
        cb = prompt_bucket(c, fns.block_size)
        nmax_rows = self._chunk_view_blocks(state) * fns.block_size
        # the bucket rounds the chunk UP, and a late start can push the
        # padded end past the gathered view (a 17-token tail at off 40
        # buckets to 32 rows against a 64-row view: 72 > 64): shrink the
        # chunk so the padded span fits; the remainder runs as another chunk
        while off + cb > nmax_rows:
            cb //= 2
        assert cb >= fns.block_size, (off, cb, nmax_rows)
        c = min(c, cb)
        mode = "final" if off + c >= p else "mid"
        # copy-on-write guard: the span scatter targets only the lane's
        # private tail by construction, EXCEPT the fully-cached recompute
        # of the last shared block -- a block still shared or indexed gets
        # a private copy before being written
        for bi in range(off // fns.block_size,
                        min(-(-(off + cb) // fns.block_size), len(state.block_ids))):
            bid = state.block_ids[bi]
            if self.allocator.refcount(bid) > 1 or self.allocator.is_indexed(bid):
                self._cow(state, bi)
        final = mode != "mid"
        nmax = self._chunk_view_blocks(state)
        tokens = np.zeros((1, cb), np.int64)
        tokens[0, :c] = req.prompt[off:off + c]
        table = np.full((nmax,), fns.num_blocks, np.int64)
        n = min(nmax, len(state.block_ids))
        table[:n] = state.block_ids[:n]
        t0 = perf_counter()
        prog, first_run = fns.chunk_for(cb, nmax, mode)
        gen = self._prefill_rng(req)
        tok0 = self._run_program(
            first_run, f"serve_chunk_c{cb}_n{nmax}_{mode}", prog, self.pools,
            torch.from_numpy(tokens).to(self.device), torch.from_numpy(table).to(self.device),
            off, c - 1, gen)
        if final:
            tok0 = int(tok0)  # fences the first token: a REAL TTFT
        else:
            _fence(self.pools)
        if first_run:
            self.stats["prefill_first_runs"] += 1
            state.cold = True
        self.stats["prefill_tokens"] += c
        self.stats["prefill_chunks"] += 1
        chunk_idx = state.prefill_chunks
        state.prefill_chunks += 1
        state.prefill_pos = off + c
        self._emit_trace_span(
            "prefill", t0, perf_counter(), trace=req.id, span=f"{req.id}/p{chunk_idx}",
            parent=f"{req.id}/req", traced=req.traced, request_id=req.id, lane=state.lane,
            bucket=cb, chunk=chunk_idx, offset=off, compiled=first_run, mode=mode,
            **tenant_tags(req),
        )
        if final:
            self._finish_prefill(state, tok0, gen, cold=first_run)

    def _decode_batch(self) -> None:
        fns = self.fns
        # a lane can be done straight out of admission (max_new=1), and a
        # lane mid-chunked-prefill has no pending token: both sit out
        active = [s for s in self.scheduler.active() if s.prefill_done and not s.done]
        if not active:
            return
        # chunk length: up to max_steps_per_dispatch steps in one dispatch,
        # never past the soonest lane completion (retire/admit stay exact);
        # the power-of-two floor bounds the grid
        remaining = min(s.request.max_new - len(s.outputs) for s in active)
        k = pow2_at_most(min(remaining, self.max_steps_per_dispatch))
        # table width: the widest active reservation, rounded up -- short
        # requests must not pay gather and attention over the whole pool
        nmax = min(pow2_at_least(max(len(s.block_ids) for s in active)),
                   fns.max_blocks_per_seq)
        tables = np.full((fns.max_batch, nmax), fns.num_blocks, np.int64)
        lengths = np.zeros((fns.max_batch,), np.int64)
        pending = np.zeros((fns.max_batch,), np.int64)
        gens = [None] * fns.max_batch
        for s in active:
            n = min(nmax, len(s.block_ids))
            tables[s.lane, :n] = s.block_ids[:n]
            lengths[s.lane] = s.length
            pending[s.lane] = s.pending_tok
            gens[s.lane] = self._gens[s.lane]
        seq = self.stats["decode_dispatches"]  # this dispatch's number
        t0 = perf_counter()
        prog, first_run = fns.decode_for(k, nmax)
        host = torch.from_numpy(np.stack([lengths, pending]))
        lengths_d, pending_d = host.to(self.device)
        toks = self._run_program(first_run, f"serve_decode_k{k}_n{nmax}", prog, self.pools,
                                 torch.from_numpy(tables).to(self.device), lengths_d,
                                 pending_d, gens)
        if first_run:
            self.stats["decode_first_runs"] += 1
            for s in active:
                s.cold = True
        self.stats["decode_steps"] += k
        self.stats["decode_dispatches"] += 1
        toks = toks.cpu().numpy()  # (K, B): ONE fence per dispatch
        now = perf_counter()
        for s in active:
            s.length += k
            lane_toks = toks[:, s.lane]
            s.pending_tok = int(lane_toks[-1])
            s.outputs.extend(int(t) for t in lane_toks)
            s.dispatches.append(seq)
            # one causal span per riding request, the co-riders in args
            self._emit_trace_span(
                "decode", t0, now, trace=s.request.id, span=f"{s.request.id}/d{seq}",
                parent=f"{s.request.id}/req", traced=s.request.traced,
                request_id=s.request.id, lane=s.lane, dispatch=seq, steps=k,
                riders=len(active), **tenant_tags(s.request),
            )
            if s.done:
                s.finished_at = now

    def drain(self, reason: str = "preempt", park: bool = False) -> dict:
        """Close admission and shed everything queued (``serve_shed``,
        reason ``"drained"``); in-flight lanes keep decoding to completion
        through later ``step()`` calls.  ``park=True`` is the hard stop:
        every unfinished lane retires NOW (blocks recycled), its partial
        outputs recorded under outcome ``parked:<reason>`` and its resume
        state kept in ``self.parked`` for :meth:`resume_parked`.
        Idempotent; emits one ``serve_drain`` event."""
        if self.draining and not park:
            return {"shed": 0, "parked": 0}
        first = not self.draining
        self.draining = True
        self.drain_reason = self.drain_reason or reason
        shed = 0
        while self.admission.queue:
            self.admission.shed_request(self.admission.pop(), "drained")
            self.stats["shed"] += 1
            shed += 1
        parked = 0
        if park:
            # finished lanes retire through the normal path first; only
            # unfinished lanes park
            self._retire_finished()
            for state in self.scheduler.park_all():
                gen, self._gens[state.lane] = self._gens[state.lane], None
                if state.request.id in self.results:
                    continue
                self.results[state.request.id] = np.asarray(state.outputs, np.int32)
                self.outcomes[state.request.id] = f"parked:{reason}"
                # the resume cursor: the partial outputs and the state of
                # the lane's generator after its last draw (a lane parked
                # mid-chunked-prefill has drawn nothing: a plain resubmit)
                self.parked[state.request.id] = {
                    "request": state.request,
                    "outputs": list(state.outputs),
                    "rng": (gen.get_state() if state.prefill_done and state.outputs
                            else None),
                }
                parked += 1
        if self.obs is not None and (first or parked):
            self.obs.emit("serve_drain", reason=reason, shed=shed, parked=parked,
                          active_lanes=len(self.scheduler.active()))
        return {"shed": shed, "parked": parked}

    def resume_parked(self) -> dict:
        """Re-open admission and resubmit every request parked by
        ``drain(park=True)``: same id and tags, its prompt extended by the
        tokens it already generated (prefill recomputes their K/V rows),
        its generator restored, and ``_retire_finished`` prepends the
        prefix back.  The pool footprint is unchanged: (p + j) + (m - j)
        - 1 rows.  Returns ``{"resumed", "rejected"}``; a request that can
        never fit is shed through normal admission."""
        self.draining = False
        self.drain_reason = None
        parked, self.parked = self.parked, {}
        resumed = rejected = 0
        for rid, rec in parked.items():
            req = rec["request"]
            outputs = rec["outputs"]
            if len(outputs) >= req.max_new:  # defensive: already complete
                self.results[rid] = np.asarray(outputs, np.int32)
                self.outcomes[rid] = "ok"
                continue
            prompt = np.asarray(req.prompt, np.int32).reshape(-1)
            if outputs:
                prompt = np.concatenate([prompt, np.asarray(outputs, np.int32)])
            new = Request(
                id=rid, prompt=prompt, max_new=req.max_new - len(outputs),
                submitted_at=req.submitted_at, rng_seed=req.rng_seed, traced=req.traced,
                tenant=req.tenant, priority_class=req.priority_class,
                resume_prefix=list(outputs), resume_rng=rec["rng"],
            )
            # the parked partials were surfaced under parked:<reason>; the
            # resumed completion replaces them
            self.results.pop(rid, None)
            self.outcomes.pop(rid, None)
            outcome = self.admission.offer(new, fits_ever=self.scheduler.fits_ever(new))
            if outcome == "rejected":
                self.stats["shed"] += 1
                rejected += 1
            else:
                resumed += 1
            if self.obs is not None:
                self.obs.emit("serve_resume", request_id=rid, resumed_tokens=len(outputs),
                              remaining=new.max_new, outcome=outcome, **tenant_tags(new))
        return {"resumed": resumed, "rejected": rejected}

    def step(self) -> bool:
        """One scheduler iteration; False when fully drained.  Order:
        retire -> admit -> ONE prefill chunk -> one batched decode
        dispatch.  A tripped preemption guard (or ``drain()``) stops
        admission, and the in-flight lanes finish."""
        if (not self.draining and self.guard is not None
                and getattr(self.guard, "requested", False)):
            self.drain("preempt")
        self._retire_finished()
        while not self.draining and self.admission.queue:
            head = self.admission.peek()
            # ONE chain-hash lookup per head per iteration, threaded
            # through fits/can_admit/admit
            shared = self.scheduler.cached_prefix(head)
            if not self.scheduler.fits_ever(head, len(shared)):
                # defensive: fits_ever is invariant to cache eviction today,
                # but a head that can never fit would park forever and
                # livelock the queue behind it
                self.admission.shed_request(self.admission.pop(), "too_large")
                self.stats["shed"] += 1
                continue
            if not self.scheduler.can_admit(head, shared):
                break
            self._admit_one(self.admission.pop(), shared)
        self._advance_prefill()
        if self.scheduler.active():
            self._decode_batch()
        if (self.defrag_threshold is not None
                and self.allocator.fragmentation() > self.defrag_threshold):
            self.defrag()
        return self.busy

    def run(self) -> dict[str, np.ndarray]:
        """Drive to drain; returns completed outputs by request id (shed
        requests appear in ``outcomes`` only)."""
        while self.step():
            pass
        self._retire_finished()
        return self.results

    def pop_result(self, request_id: str) -> np.ndarray:
        """Hand over and FORGET one completed request's tokens (a
        continuous server evicts as it responds)."""
        self.outcomes.pop(request_id, None)
        return self.results.pop(request_id)

    def precompile(self, max_prompt_len: int, max_new: int) -> dict:
        """Run once every program shape a client mix bounded by
        ``(max_prompt_len, max_new)`` can reach -- every smaller prefill
        bucket, the (chunk length, table width) decode grid and, with a
        prefix cache or a chunk bound, the chunk grid -- so that steady-
        state requests never take a shape's first run (the JAX engine's
        name: there it compiles them).  Every block id is out of range, so
        the pool writes are dropped and the pool's content stays.  Returns
        the counts of shapes run for the first time, ``{"prefill",
        "decode", "chunk"}`` (also in ``stats['prewarmed_*']``)."""
        fns = self.fns
        dev = self.device
        ran = {"prefill": 0, "decode": 0, "chunk": 0}
        top_bucket = prompt_bucket(max(1, max_prompt_len), fns.block_size)
        buckets = []
        b = fns.block_size
        while b < top_bucket:
            buckets.append(b)
            b *= 2
        buckets.append(top_bucket)
        if self.prefill_chunk is not None:
            # prompts past the chunk bound never take a whole-prompt bucket
            full_cap = prompt_bucket(self.prefill_chunk, fns.block_size)
            buckets = [b for b in buckets if b <= full_cap]
        max_blocks = min(blocks_for(max(1, max_prompt_len) + max(1, max_new) - 1,
                                    fns.block_size), fns.max_blocks_per_seq)
        nmaxes = sorted({min(pow2_at_least(n), fns.max_blocks_per_seq)
                         for n in range(1, max_blocks + 1)})
        ks = [1 << i for i in range(pow2_at_most(self.max_steps_per_dispatch).bit_length())]
        zeros = torch.zeros((fns.max_batch,), dtype=torch.long, device=dev)
        gens = [None] * fns.max_batch
        for nmax in nmaxes:
            t = torch.full((fns.max_batch, nmax), fns.num_blocks, dtype=torch.long, device=dev)
            for k in ks:
                prog, first = fns.decode_for(k, nmax)
                if first:
                    self._run_program(True, f"serve_decode_k{k}_n{nmax}", prog, self.pools,
                                      t, zeros, zeros, gens).cpu()
                    ran["decode"] += 1
        for bucket in buckets:
            if bucket in self._run_buckets:
                continue
            ids = torch.full((bucket // fns.block_size,), fns.num_blocks, dtype=torch.long,
                             device=dev)
            int(self._run_program(
                True, f"serve_prefill_b{bucket}", fns.prefill_for(bucket), self.pools,
                torch.zeros((1, bucket), dtype=torch.long, device=dev), ids, 1,
                torch.Generator(dev).manual_seed(0)))
            self._run_buckets.add(bucket)
            ran["prefill"] += 1
        # chunk programs: reachable when prompts can continue a cached prefix
        # or exceed the chunk bound ("mid" also without a bound: the view
        # clamp can split a prefix-hit tail); widths ride the same
        # reservation-derived grid, floored at the MIN_CHUNK_VIEW_ROWS clamp
        if self.prefill_chunk is not None or self.prefix is not None:
            vmaxes = sorted({self._view_blocks(n) for n in range(1, max_blocks + 1)})
            cap = min(self.prefill_chunk, top_bucket) if self.prefill_chunk else top_bucket
            cbs = [b for b in buckets if b <= cap] or [fns.block_size]
            for nmax in vmaxes:
                t = torch.full((nmax,), fns.num_blocks, dtype=torch.long, device=dev)
                for mode in ("mid", "final"):
                    for cb in cbs:
                        if cb > nmax * fns.block_size:
                            # a chunk never outgrows its own view
                            continue
                        prog, first = fns.chunk_for(cb, nmax, mode)
                        if not first:
                            continue
                        self._run_program(
                            True, f"serve_chunk_c{cb}_n{nmax}_{mode}", prog, self.pools,
                            torch.zeros((1, cb), dtype=torch.long, device=dev), t, 0, 0,
                            torch.Generator(dev).manual_seed(0))
                        _fence(self.pools)
                        ran["chunk"] += 1
        for kind, n in ran.items():
            self.stats[f"prewarmed_{kind}"] = self.stats.get(f"prewarmed_{kind}", 0) + n
        return ran

    def warmup(self, prompt_len: int, max_new: int = 2) -> None:
        """Run one synthetic request of ``prompt_len`` tokens through the
        engine before timing (its bucket and decode shapes take their first
        run here); it leaves no result, stats count or trace, and neither
        enters nor hits the prefix index."""
        prev_trace, self.trace_requests = self.trace_requests, False
        prev_prefix = self.prefix
        self.prefix = self.scheduler.prefix_index = None
        try:
            outcome = self.submit(np.zeros((prompt_len,), np.int32), max_new,
                                  request_id="_warmup")
            if outcome == "queued":
                self.run()
                self.results.pop("_warmup", None)
                self.outcomes.pop("_warmup", None)
                self.request_log = deque(
                    (r for r in self.request_log if r.get("request_id") != "_warmup"),
                    maxlen=self.request_log.maxlen,
                )
                self.stats["submitted"] -= 1
                self.stats["completed"] -= 1
        finally:
            self.trace_requests = prev_trace
            self.prefix = self.scheduler.prefix_index = prev_prefix

    def defrag(self) -> bool:
        """Compact live blocks to the lowest pool ids (device copy + table
        rewrite); returns whether anything moved."""
        plan = self.allocator.compaction_plan()
        if not plan:
            return False
        self.pools = apply_block_permutation(self.pools, plan, self.fns.num_blocks)
        self.scheduler.remap_blocks(plan)
        if self.prefix is not None:
            self.prefix.remap(plan)  # cached (evictable) blocks move too
        self.allocator.commit_plan(plan)
        self._emit_pool_stats(defrag=True)
        return True
