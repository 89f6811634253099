"""Admission control and load shedding for the serving engine (own copy of
``ddl_tpu/serve/admission.py``).

A serving system that admits everything melts under overload: the queue
grows without bound, every request's latency inflates past its client's
timeout, and the system does work nobody will receive — the classic
load-shedding argument.  This module is the engine's front door:

* **bounded queue** — at most ``max_queue`` prompts wait for a lane;
* **queue-depth policy** when the bound is hit: ``"reject"`` turns the
  NEW request away (predictable for retrying clients), ``"shed_oldest"``
  drops the longest-waiting queued request in favour of the new one
  (freshest-first under overload, the deadline-aware choice when old
  requests' clients have likely timed out already);
* **pool watermark** — the scheduler additionally refuses to bind a
  request to a lane while doing so would leave fewer than
  ``min_free_blocks`` free (``serve/scheduler.py``), so a admission
  burst cannot starve the KV pool;
* requests whose worst-case footprint exceeds the engine envelope are
  rejected outright (waiting cannot help them).

Every shed/reject is emitted as a ``serve_shed`` obs event with the
reason and policy, so ``obs summarize``/dashboards can see overload as
it happens rather than inferring it from latency.  All decisions are
deterministic functions of (queue state, request).
"""

from __future__ import annotations

from collections import deque

from ddl_tpu_torch.serve.scheduler import Request, tenant_tags

__all__ = ["AdmissionController", "POLICIES"]

POLICIES = ("reject", "shed_oldest")


class AdmissionController:
    """Bounded FIFO request queue with a shed policy.

    ``obs`` is an ``obs.events.EventWriter`` (or None); ``on_shed`` is
    an optional callback ``(request, reason)`` the engine uses to fail
    the shed request's future."""

    def __init__(
        self,
        max_queue: int = 64,
        policy: str = "reject",
        obs=None,
        on_shed=None,
        trace: bool = True,
    ) -> None:
        if policy not in POLICIES:
            raise ValueError(
                f"policy must be one of {POLICIES}, got {policy!r}"
            )
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = int(max_queue)
        self.policy = policy
        self.obs = obs
        self.on_shed = on_shed
        self.trace = bool(trace)
        self.queue: deque[Request] = deque()
        self.admitted = 0  # accepted into the queue
        self.shed = 0  # dropped (either policy, any reason)

    def _emit_shed(self, req: Request, reason: str) -> None:
        self.shed += 1
        if self.obs is not None:
            self.obs.emit(
                "serve_shed",
                request_id=req.id,
                reason=reason,
                policy=self.policy,
                queue_depth=len(self.queue),
                **tenant_tags(req),
            )
            # terminal causal mark: a shed request's trace ends here,
            # not at a retire (obs/trace.py renders it as the trace's
            # final instant); the request's 1-in-N sampling decision
            # (Request.traced) applies here too
            if self.trace and getattr(req, "traced", True):
                self.obs.emit(
                    "trace_mark",
                    trace=req.id,
                    span=f"{req.id}/shed",
                    name="shed",
                    cat="serve",
                    request_id=req.id,
                    reason=reason,
                    policy=self.policy,
                    **tenant_tags(req),
                )
        if self.on_shed is not None:
            self.on_shed(req, reason)

    def offer(self, req: Request, fits_ever: bool = True) -> str:
        """Try to enqueue; returns the outcome:

        ``"queued"``            accepted
        ``"rejected"``          turned away (too large, or queue full
                                under the reject policy)
        ``"queued_shed_oldest"`` accepted after dropping the oldest
                                queued request (shed_oldest policy)
        """
        if not fits_ever:
            self._emit_shed(req, "too_large")
            return "rejected"
        if len(self.queue) < self.max_queue:
            self.queue.append(req)
            self.admitted += 1
            return "queued"
        if self.policy == "reject":
            self._emit_shed(req, "queue_full")
            return "rejected"
        oldest = self.queue.popleft()
        self._emit_shed(oldest, "queue_full")
        self.queue.append(req)
        self.admitted += 1
        return "queued_shed_oldest"

    def shed_request(self, req: Request, reason: str) -> None:
        """Shed an ALREADY-POPPED request (engine drain loop: a queued
        head whose cached prefix was evicted may no longer ever fit —
        parking it would livelock the requests behind it).  Same event/
        callback path as a queue-policy shed."""
        self._emit_shed(req, reason)

    def peek(self) -> Request | None:
        return self.queue[0] if self.queue else None

    def pop(self) -> Request:
        return self.queue.popleft()

    def __len__(self) -> int:
        return len(self.queue)
