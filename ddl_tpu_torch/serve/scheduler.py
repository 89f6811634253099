"""Continuous-batching scheduler: lanes, block tables, admit/retire (own copy
of ``ddl_tpu/serve/scheduler.py``, pure host-side bookkeeping).

The decode batch is ``max_batch`` **lanes**; every engine iteration:

1. finished lanes retire — their pool blocks go back to the allocator
   and the lane frees up (``retire``),
2. queued prompts are admitted into free lanes while the pool can hold
   their worst-case footprint (``try_admit`` — prefill runs per request
   as its own program, so a long prompt never stalls in-flight decodes
   behind a monolithic batch rebuild),
3. one batched decode step advances ALL active lanes together.

Admission reserves ``blocks_for(prompt + max_new)`` up front: a request
that is admitted can always run to completion — the scheduler never
needs to preempt a lane mid-flight to reclaim memory, which keeps the
retire path trivial and the shed policy (``serve/admission.py``) the
only place requests are dropped.  With a ``PrefixIndex`` attached,
the reservation is split: block-aligned prompt prefixes
already resident in the pool are **shared** (refcount +1, read-only —
decode appends only ever touch the private tail) and only the private
remainder is newly allocated, so the pool precheck and the
``min_free_blocks`` watermark charge a shared-prefix burst its TRUE
footprint, not the worst case (a request whose prefix is fully cached
must never be rejected for blocks it will never allocate).

Pure host-side bookkeeping (no torch import): the engine
(``serve/engine.py``) owns the device tensors, this module owns which
lane/block holds what, so admission order, retire-and-recycle and shed
determinism are unit-testable in microseconds.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from ddl_tpu_torch.serve.kv_pool import BlockAllocator, PrefixIndex, blocks_for

__all__ = ["Request", "LaneState", "ContinuousScheduler", "tenant_tags"]


def tenant_tags(req: "Request") -> dict:
    """Event-field dict for a request's tenant tags.  Fields appear only
    when set (the serve_admit scenario-tag pattern), so untagged runs'
    event bytes are unchanged and pre-tenant streams keep folding; every
    consumer normalizes absence — or a falsy tag — to the ``"default"``
    tenant (obs/serving.py, obs/fold.py)."""
    out = {}
    if getattr(req, "tenant", None):
        out["tenant"] = req.tenant
    if getattr(req, "priority_class", None):
        out["priority_class"] = req.priority_class
    return out


@dataclasses.dataclass
class Request:
    """One client prompt.  ``prompt`` is a 1-D int32 token array (numpy
    — nothing here touches devices); ``submitted_at`` is a
    ``perf_counter`` timestamp so queueing delay is measurable.
    ``traced`` marks whether this request emits causal trace spans (the
    ``DDL_OBS_TRACE_SAMPLE`` 1-in-N sampler clears it).  ``tenant`` /
    ``priority_class`` are the multi-tenant attribution tags: carried
    onto every serve_admit/serve_shed/serve_retire/decode/trace event so
    the obs stack can split latency percentiles, shed rates, and
    chip-seconds per tenant (obs/serving.py, obs/slo.py).  None means
    untagged — every consumer folds that into the ``"default"`` tenant,
    so old and new streams aggregate together."""

    id: str
    prompt: Any
    max_new: int
    submitted_at: float | None = None
    rng_seed: int = 0
    traced: bool = True
    tenant: str | None = None
    priority_class: str | None = None
    # memoized PrefixIndex.chain_keys over the immutable prompt: a
    # parked queue head is looked up every scheduler tick, and only the
    # index-dict walk needs to be fresh — not O(prompt) SHA-1 hashing
    chain_keys: Any = dataclasses.field(
        default=None, repr=False, compare=False
    )
    # elastic resume: a request re-admitted after
    # ``drain(park=True)`` carries the tokens it already generated
    # (``resume_prefix`` — folded into ``prompt`` so prefill recomputes
    # their KV rows, prepended back at retire so the client stream is
    # complete) and the state of the parked lane's generator
    # (``resume_rng``, ``torch.Generator.get_state()``) — prefill
    # restores it instead of seeding ``rng_seed``, so a sampled resume
    # draws exactly what an uninterrupted decode would have.  Both None
    # for ordinary requests.
    resume_prefix: Any = dataclasses.field(
        default=None, repr=False, compare=False
    )
    resume_rng: Any = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def __post_init__(self):
        if self.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")
        if len(self.prompt) < 1:
            raise ValueError("empty prompt")

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    def total_tokens(self) -> int:
        # cache rows the request can ever hold: the prompt plus every
        # generated token except the last (sampled, never forwarded)
        return self.prompt_len + self.max_new - 1


@dataclasses.dataclass
class LaneState:
    """One in-flight request bound to a decode-batch lane."""

    lane: int
    request: Request
    block_ids: list[int]
    length: int  # cache rows written so far
    pending_tok: int  # sampled, not yet forwarded
    outputs: list[int]  # sampled tokens, outputs[0] = the TTFT token
    admitted_at: float = 0.0
    ttft_s: float | None = None
    cold: bool = False  # a program's first run (excluded from percentiles)
    finished_at: float | None = None
    # engine dispatch sequence numbers this lane rode — the causal
    # ledger behind the per-request trace's decode spans (obs/trace.py)
    dispatches: list = dataclasses.field(default_factory=list)
    # prefix-cache / chunked-prefill state: rows [0,
    # cached_tokens) were shared from the pool, prefill computes from
    # ``prefill_pos`` upward in chunks; the lane joins the decode batch
    # only once ``prefill_done`` (tok0 sampled).  ``cow_block`` is the
    # pre-allocated copy-on-write target when the whole (block-aligned)
    # prompt was cached and the final token's row must be recomputed
    # into a private copy of the last shared block.
    cached_tokens: int = 0
    shared_blocks: int = 0
    prefill_pos: int = 0
    prefill_done: bool = True
    prefill_chunks: int = 0
    cow_block: int | None = None

    @property
    def done(self) -> bool:
        return self.prefill_done and len(self.outputs) >= self.request.max_new


class ContinuousScheduler:
    """Lane + block bookkeeping for the continuous batch.

    ``min_free_blocks`` is the pool watermark: admission keeps at least
    that many blocks free AFTER the reservation — headroom the operator
    sets so a burst of admissions cannot starve the pool to exactly
    zero (admission control's second watermark, next to queue depth).
    """

    def __init__(
        self,
        allocator: BlockAllocator,
        max_batch: int,
        max_blocks_per_seq: int,
        min_free_blocks: int = 0,
        prefix_index: Optional[PrefixIndex] = None,
    ) -> None:
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.allocator = allocator
        self.max_batch = int(max_batch)
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        self.min_free_blocks = int(min_free_blocks)
        self.prefix_index = prefix_index
        self.lanes: list[Optional[LaneState]] = [None] * max_batch
        self.peak_lanes = 0

    # -- capacity queries -------------------------------------------------
    def blocks_needed(self, req: Request) -> int:
        return blocks_for(req.total_tokens(), self.allocator.block_size)

    def cached_prefix(self, req: Request) -> list[int]:
        """Pool blocks already holding this prompt's block-aligned
        prefix (longest USABLE chain; empty without a prefix index).
        The chain hash is computed once per request and memoized on it.

        When the chain covers the whole (block-aligned) prompt, reusing
        ALL of it costs one extra resident block — the copy-on-write
        target for the final-token recompute.  If the pool (net of the
        watermark) cannot hold ``need + 1``, the last cached block is
        dropped and recomputed instead (residency exactly ``need``, the
        same as an uncached admit) — enabling the cache must never make
        a previously-servable request unservable."""
        if self.prefix_index is None:
            return []
        if req.chain_keys is None:
            req.chain_keys = self.prefix_index.chain_keys(req.prompt)
        chain = self.prefix_index.lookup(req.prompt, req.chain_keys)
        bs = self.allocator.block_size
        if chain and len(chain) * bs >= req.prompt_len:
            if len(chain) == 1 or (
                self.blocks_needed(req) + 1 + self.min_free_blocks
                > self.allocator.num_blocks
            ):
                # a single fully-covering block would be shared only to
                # be immediately copied and fully recomputed — no win;
                # and when the pool can't hold the CoW's +1 resident
                # block, drop the last cached block and recompute it
                # (residency == the uncached need) instead
                chain = chain[: (req.prompt_len - 1) // bs]
        return chain

    def private_need(self, req: Request, shared_n: int) -> int:
        """Blocks this request must newly ALLOCATE given ``shared_n``
        cached prefix blocks it can share.  When the cached chain covers
        the whole (block-aligned) prompt, one extra block is charged:
        the final prompt token's row must be recomputed to produce the
        first logits, and its write lands in the last shared block — the
        copy-on-write target (engine ``_admit_one``)."""
        need = self.blocks_needed(req) - shared_n
        if shared_n and shared_n * self.allocator.block_size >= req.prompt_len:
            need += 1
        return need

    def fits_ever(self, req: Request, shared_n: int | None = None) -> bool:
        """False when the request exceeds the engine's static envelope —
        it must be rejected outright, no amount of waiting helps: wider
        than a block table, or a total RESIDENCY (shared prefix blocks,
        which must stay resident for the request's whole life, plus its
        private remainder) the pool can never hold once the
        ``min_free_blocks`` watermark is held back.  Queueing such a
        request would park it at the head forever and livelock the
        drain loop behind it — ``can_admit`` can never beat
        ``num_blocks - shared_n`` headroom no matter how many other
        lanes retire.  (Sharing shrinks what a request ALLOCATES — the
        ``can_admit`` charge — never the blocks it needs to exist;
        the win is that N requests' shared prefix counts
        against the pool once, not N times.)"""
        if shared_n is None:
            shared_n = len(self.cached_prefix(req))
        need = self.blocks_needed(req)
        return (
            need <= self.max_blocks_per_seq
            and shared_n + self.private_need(req, shared_n)
            + self.min_free_blocks <= self.allocator.num_blocks
        )

    def free_lane(self) -> int | None:
        for i, lane in enumerate(self.lanes):
            if lane is None:
                return i
        return None

    def can_admit(self, req: Request, shared: list[int] | None = None) -> bool:
        """Lane + pool headroom for the request's PRIVATE demand.
        Shared prefix blocks that currently sit in the evictable set
        would be reactivated by the share, so they are discounted from
        the allocatable count the watermark check sees."""
        if self.free_lane() is None:
            return False
        if shared is None:
            shared = self.cached_prefix(req)
        alloc = self.allocator
        avail = alloc.free_blocks + alloc.cached_blocks - sum(
            1 for b in shared if alloc.refcount(b) == 0
        )
        return (
            self.private_need(req, len(shared)) + self.min_free_blocks
            <= avail
        )

    # -- state transitions ------------------------------------------------
    def try_admit(
        self, req: Request, shared: list[int] | None = None
    ) -> LaneState | None:
        """Bind ``req`` to a free lane: share its cached prefix blocks
        (refcount +1, read-only) and reserve the private remainder; None
        when a lane or the watermark says wait.  ``shared`` lets the
        caller reuse one ``cached_prefix`` lookup across the
        fits/can_admit/admit sequence (the chain hash is O(prompt))."""
        if shared is None:
            shared = self.cached_prefix(req)
        if not self.fits_ever(req, len(shared)):
            raise ValueError(
                f"request {req.id!r} needs {self.blocks_needed(req)} "
                f"blocks > max_blocks_per_seq={self.max_blocks_per_seq} "
                f"(or a private footprint past the pool)"
            )
        lane = self.free_lane()
        if lane is None or not self.can_admit(req, shared):
            return None
        bs = self.allocator.block_size
        self.allocator.share(shared)
        private = self.allocator.alloc(self.private_need(req, len(shared)))
        cow_block = None
        cached_tokens = len(shared) * bs
        if shared and cached_tokens >= req.prompt_len:
            # fully-cached block-aligned prompt: the final token must be
            # recomputed for its logits, so the whole LAST BLOCK is
            # re-prefilled at a block-aligned offset (chunk starts stay
            # aligned — an unaligned single-row chunk could overflow the
            # gathered view) and its write goes through copy-on-write
            # into this pre-allocated private copy of the shared block
            cow_block = private.pop()
            cached_tokens = req.prompt_len - bs
        state = LaneState(
            lane=lane, request=req, block_ids=shared + private,
            length=req.prompt_len, pending_tok=0, outputs=[],
            cached_tokens=cached_tokens, shared_blocks=len(shared),
            prefill_pos=cached_tokens, prefill_done=False,
            cow_block=cow_block,
        )
        self.lanes[lane] = state
        self.peak_lanes = max(
            self.peak_lanes, sum(l is not None for l in self.lanes)
        )
        return state

    def retire(self, lane: int) -> LaneState:
        """Unbind a lane and recycle its blocks."""
        state = self.lanes[lane]
        if state is None:
            raise ValueError(f"lane {lane} is not active")
        self.allocator.free(state.block_ids)
        self.lanes[lane] = None
        return state

    def park_all(self) -> list[LaneState]:
        """Retire every active lane NOW — the drain's hard stop.  Blocks
        are recycled through the normal ``retire`` path (refcounts and
        the prefix index stay coherent), and the states come back with
        whatever outputs they produced so the engine can record them as
        parked rather than silently dropped."""
        return [self.retire(s.lane) for s in self.active()]

    def active(self) -> list[LaneState]:
        return [l for l in self.lanes if l is not None]

    def finished(self) -> list[LaneState]:
        return [l for l in self.lanes if l is not None and l.done]

    def remap_blocks(self, plan: dict[int, int]) -> None:
        """Rewrite every live block table per a compaction plan (the
        host half of ``kv_pool.apply_block_permutation``).  A pending
        copy-on-write target is a live refcounted block too — it moves
        with the plan or the eventual copy lands on a stale row."""
        for state in self.active():
            state.block_ids = [plan.get(i, i) for i in state.block_ids]
            if state.cow_block is not None:
                state.cow_block = plan.get(state.cow_block, state.cow_block)
