"""Exponential backoff with jitter, plus a bounded retry helper (own copy
of ``ddl_tpu/utils/backoff.py``).

One policy object shared by the recovery paths that wait and retry:
snapshot-save I/O errors (``checkpoint.save_snapshot``: shared-NAS writes
flake) and transient data-loader read errors (``data/loader.DataLoader``).

Each delay is drawn uniformly from ``[(1 - jitter) * d, d]`` where ``d`` is
the capped exponential term, so hosts that restart after the same hiccup
do not retry in lockstep.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Iterable

__all__ = ["Backoff", "retry_with_backoff"]


class Backoff:
    """``delay(attempt)`` for attempt = 0, 1, 2, ... is

        d = min(max_delay, base * factor**attempt)
        delay ~ Uniform[(1 - jitter) * d,  d]

    so delays are monotonically bounded above by the capped exponential
    and never fall below the ``(1 - jitter)`` fraction of it — the bounds
    the jitter test pins down.  ``rng`` is injectable for determinism.
    """

    def __init__(
        self,
        base: float = 1.0,
        factor: float = 2.0,
        max_delay: float = 60.0,
        jitter: float = 0.5,
        rng: random.Random | None = None,
    ) -> None:
        if not 0.0 <= jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {jitter}")
        if base < 0 or factor < 1.0 or max_delay < 0:
            raise ValueError(
                f"need base >= 0, factor >= 1, max_delay >= 0; got "
                f"base={base} factor={factor} max_delay={max_delay}"
            )
        self.base = base
        self.factor = factor
        self.max_delay = max_delay
        self.jitter = jitter
        self.rng = rng if rng is not None else random.Random()

    def delay(self, attempt: int) -> float:
        d = min(self.max_delay, self.base * self.factor ** max(0, attempt))
        return d * (1.0 - self.jitter * self.rng.random())

    def delays(self, n: int) -> Iterable[float]:
        return [self.delay(i) for i in range(n)]


def retry_with_backoff(
    fn: Callable,
    retries: int,
    exceptions: tuple = (OSError,),
    backoff: Backoff | None = None,
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Callable[[BaseException, int], None] | None = None,
):
    """Call ``fn()``; on one of ``exceptions``, wait per ``backoff`` and
    try again, up to ``retries`` *re*-tries (``retries + 1`` total
    attempts).  The final failure propagates unmodified.  ``on_retry``
    (if given) observes ``(exception, attempt_index)`` before each wait —
    the hook observability counters hang off."""
    if backoff is None:
        backoff = Backoff()
    for attempt in range(retries + 1):
        try:
            return fn()
        except exceptions as e:
            if attempt >= retries:
                raise
            if on_retry is not None:
                on_retry(e, attempt)
            sleep(backoff.delay(attempt))
