"""Serving-side latency statistics over per-request ``decode`` events (own
copy of ``ddl_tpu/obs/serving.py``).

Serving comparisons are made on tail latency — the Gemma-on-TPU serving
study (PAPERS.md) reports p50/p95/p99, never means — because the mean of
a latency distribution hides exactly the requests users notice.  This
module turns the decode path's per-request events (``infer/decode.py``:
duration, queueing delay, time-to-first-token, tokens/s, prompt/output
lengths) into streaming percentiles for ``obs summarize`` and the
``obs diff --fail-slowdown`` regression gate.

``TDigest`` is the percentile accumulator: a deterministic, *mergeable*
t-digest.  While the stream fits ``exact_max`` points it stores raw
singletons and quantiles are exact (``numpy.quantile``'s default linear
interpolation, which the unit tests pin); beyond that the merging-digest
compression bounds memory at ~``compression`` centroids with singleton-
fine tails.  No RNG anywhere — the digest is a pure function of its
insertion sequence, and ``merge`` sorts the combined centroid set before
compressing, so merging per-stream digests is independent of operand
order.  Mergeability is what lets the incremental fold engine
(``obs/fold.py``) keep one digest PER STREAM and combine them at render
time: a resumed fold then reproduces a cold fold bit for bit, which a
shared reservoir (whose sampling depends on the global interleaving of
streams) cannot.

``QuantileAccumulator`` (the pre-digest bounded reservoir, Vitter's
algorithm R) is kept for callers that want a uniform *sample* rather
than a sketch; ``TDigest.from_state`` transparently migrates its
serialized state, so sidecars written by the reservoir era load into
digests without losing the accumulated distribution.
"""

from __future__ import annotations

import random

__all__ = [
    "QuantileAccumulator",
    "ServingStats",
    "TDigest",
    "PERCENTILES",
    "tenant_of",
]

PERCENTILES = (0.5, 0.95, 0.99)

# decode-event field -> summary metric name; values are seconds except
# the rate row.
METRICS = (
    ("dur", "latency_s"),
    ("queue_delay", "queue_delay_s"),
    ("ttft", "ttft_s"),
    ("tok_per_s", "tok_per_s"),
)


def tenant_of(event: dict) -> str:
    """An event's tenant tag, normalized: absence — or any falsy tag
    (None from a pre-tenant stream, an empty string from a sloppy
    client) — IS the ``"default"`` tenant.  The single normalization
    point every consumer shares, so mixed old/new streams fold into one
    coherent per-tenant account instead of a schema split."""
    return str(event.get("tenant") or "default")


class QuantileAccumulator:
    """Streaming quantiles over a bounded reservoir.

    ``add`` is O(1); ``quantile`` sorts the reservoir on demand (cached
    between adds).  While ``count <= capacity`` the reservoir IS the
    stream and quantiles are exact; beyond that it is a uniform random
    sample (algorithm R) with a deterministic seed, so summaries are
    reproducible run to run."""

    def __init__(self, capacity: int = 4096, seed: int = 0) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._rng = random.Random(seed)
        self._values: list[float] = []
        self._sorted: list[float] | None = None
        self.count = 0
        self.total = 0.0
        self.min: float | None = None
        self.max: float | None = None

    def state_dict(self) -> dict:
        """JSON-serializable snapshot.  Includes the reservoir RNG state
        so a restored accumulator samples the stream tail exactly as the
        uninterrupted one would."""
        st = self._rng.getstate()
        return {
            "capacity": self.capacity,
            "values": self._values,
            "count": self.count,
            "total": self.total,
            "min": self.min,
            "max": self.max,
            "rng": [st[0], list(st[1]), st[2]],
        }

    @classmethod
    def from_state(cls, state: dict) -> "QuantileAccumulator":
        acc = cls(capacity=state["capacity"])
        acc._values = [float(v) for v in state["values"]]
        acc.count = int(state["count"])
        acc.total = float(state["total"])
        acc.min = state["min"]
        acc.max = state["max"]
        v, internal, gauss = state["rng"]
        acc._rng.setstate((v, tuple(internal), gauss))
        return acc

    def add(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.total += x
        self.min = x if self.min is None else min(self.min, x)
        self.max = x if self.max is None else max(self.max, x)
        self._sorted = None
        if len(self._values) < self.capacity:
            self._values.append(x)
        else:
            j = self._rng.randrange(self.count)
            if j < self.capacity:
                self._values[j] = x

    @property
    def mean(self) -> float | None:
        return self.total / self.count if self.count else None

    def quantile(self, q: float) -> float | None:
        """Linear-interpolated quantile of the reservoir (numpy's
        default method), None on an empty stream."""
        if not self._values:
            return None
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self._sorted is None:
            self._sorted = sorted(self._values)
        return _linear_quantile(self._sorted, q)

    def summary(self, percentiles=PERCENTILES) -> dict:
        return {
            "count": self.count,
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            **{
                f"p{int(q * 100)}": self.quantile(q) for q in percentiles
            },
        }


def _linear_quantile(sorted_values: list[float], q: float) -> float:
    """numpy.quantile's default (linear) interpolation over an already
    sorted value list."""
    v = sorted_values
    pos = q * (len(v) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    frac = pos - lo
    return v[lo] * (1.0 - frac) + v[hi] * frac


# buffered adds between compressions: amortizes the sort without letting
# the unmerged tail grow past a small constant
_TDIGEST_BUFFER = 512


class TDigest:
    """Deterministic mergeable t-digest (see module docstring).

    ``exact_max`` is the singleton budget: while total weight stays at
    or below it nothing is ever merged, quantiles are numpy-exact, and
    the digest degenerates to a sorted value list (every CI smoke lives
    here).  Past it, the merging-digest pass bounds the centroid count
    near ``compression`` with a k1-style size limit (fine tails, coarse
    middle).  ``count``/``total``/``min``/``max`` always describe the
    FULL stream, including what compression summarized."""

    def __init__(
        self, compression: int = 256, exact_max: int = 4096
    ) -> None:
        if compression < 8:
            raise ValueError(
                f"compression must be >= 8, got {compression}"
            )
        if exact_max < 1:
            raise ValueError(f"exact_max must be >= 1, got {exact_max}")
        self.compression = int(compression)
        self.exact_max = int(exact_max)
        self._means: list[float] = []
        self._weights: list[float] = []
        self._buffer: list[float] = []
        self.count = 0
        self.total = 0.0
        self.min: float | None = None
        self.max: float | None = None

    # ------------------------------------------------------------ ingest

    def add(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.total += x
        self.min = x if self.min is None else min(self.min, x)
        self.max = x if self.max is None else max(self.max, x)
        self._buffer.append(x)
        if len(self._buffer) >= _TDIGEST_BUFFER:
            self._flush()

    def _flush(self) -> None:
        if not self._buffer:
            return
        pts = sorted(
            list(zip(self._means, self._weights))
            + [(x, 1.0) for x in self._buffer]
        )
        self._buffer = []
        weight = sum(w for _, w in pts)
        if weight <= self.exact_max:
            # singleton regime: keep every point, quantiles stay exact
            self._means = [m for m, _ in pts]
            self._weights = [w for _, w in pts]
            return
        self._means, self._weights = self._compress(pts, weight)

    def _compress(self, pts, weight):
        """One merging-digest pass over mean-sorted points.  A centroid
        may absorb the next point while its weight stays under the k1
        size limit ``4*W*q*(1-q)/compression`` at its midpoint quantile
        — singleton-fine tails, ~compression centroids total.  Pure
        function of the sorted input: deterministic, order-free."""
        means: list[float] = []
        weights: list[float] = []
        cur_m, cur_w = pts[0]
        done = 0.0  # weight fully emitted so far
        for m, w in pts[1:]:
            q = (done + (cur_w + w) / 2.0) / weight
            limit = 4.0 * weight * q * (1.0 - q) / self.compression
            if cur_w + w <= limit:
                cur_m += (m - cur_m) * (w / (cur_w + w))
                cur_w += w
            else:
                means.append(cur_m)
                weights.append(cur_w)
                done += cur_w
                cur_m, cur_w = m, w
        means.append(cur_m)
        weights.append(cur_w)
        return means, weights

    def merge(self, other: "TDigest") -> None:
        """Fold ``other``'s distribution into this digest without
        mutating it.  The combined centroid set is re-sorted before any
        compression, so ``a.merge(b)`` and ``b.merge(a)`` summarize
        identically — the property the per-stream fold accumulators rely
        on when they are combined at render time."""
        if not other.count:
            return
        self.count += other.count
        self.total += other.total
        if other.min is not None:
            self.min = (
                other.min if self.min is None else min(self.min, other.min)
            )
        if other.max is not None:
            self.max = (
                other.max if self.max is None else max(self.max, other.max)
            )
        pts = sorted(
            list(zip(self._means, self._weights))
            + [(x, 1.0) for x in self._buffer]
            + list(zip(other._means, other._weights))
            + [(x, 1.0) for x in other._buffer]
        )
        self._buffer = []
        weight = sum(w for _, w in pts)
        if weight <= self.exact_max:
            self._means = [m for m, _ in pts]
            self._weights = [w for _, w in pts]
        else:
            self._means, self._weights = self._compress(pts, weight)

    # ------------------------------------------------------------- query

    @property
    def mean(self) -> float | None:
        return self.total / self.count if self.count else None

    def quantile(self, q: float) -> float | None:
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        self._flush()
        if not self._means:
            return None
        if all(w == 1.0 for w in self._weights):
            # singleton regime: exactly numpy's linear interpolation
            return _linear_quantile(self._means, q)
        # compressed regime: interpolate between centroid means at their
        # cumulative-weight midpoints, clamped to the observed extremes
        weight = sum(self._weights)
        target = q * weight
        cum = 0.0
        prev_mid = 0.0
        prev_mean = self.min if self.min is not None else self._means[0]
        for m, w in zip(self._means, self._weights):
            mid = cum + w / 2.0
            if target <= mid:
                span = mid - prev_mid
                frac = (target - prev_mid) / span if span > 0 else 0.0
                return prev_mean + (m - prev_mean) * frac
            cum += w
            prev_mid = mid
            prev_mean = m
        return self.max if self.max is not None else self._means[-1]

    def rank(self, x: float) -> float | None:
        """Estimated stream weight at or below ``x`` — the CDF counter
        behind the Prometheus cumulative-histogram export (``obs export``
        renders ``_bucket`` series by evaluating this at each bound).
        Exact while the digest holds singletons (a plain count of values
        <= x); in the compressed regime it inverts ``quantile``'s
        midpoint interpolation, so bucket counts stay monotone in ``x``
        and consistent with the reported quantiles.  None on an empty
        stream."""
        self._flush()
        if not self._means:
            return None
        if self.min is not None and x < self.min:
            return 0.0
        if self.max is not None and x >= self.max:
            return float(sum(self._weights))
        if all(w == 1.0 for w in self._weights):
            import bisect

            return float(bisect.bisect_right(self._means, x))
        weight = sum(self._weights)
        cum = 0.0
        prev_mid = 0.0
        prev_mean = self.min if self.min is not None else self._means[0]
        for m, w in zip(self._means, self._weights):
            mid = cum + w / 2.0
            if x < m:
                span = m - prev_mean
                frac = (x - prev_mean) / span if span > 0 else 1.0
                return prev_mid + max(0.0, min(1.0, frac)) * (mid - prev_mid)
            cum += w
            prev_mid = mid
            prev_mean = m
        return float(weight)

    def summary(self, percentiles=PERCENTILES) -> dict:
        return {
            "count": self.count,
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            **{
                f"p{int(q * 100)}": self.quantile(q) for q in percentiles
            },
        }

    # ------------------------------------------------------------- state

    def state_dict(self) -> dict:
        # the unmerged buffer is serialized VERBATIM, not flushed: a
        # restored digest must hit the same compression boundaries the
        # uninterrupted one would, or a resumed fold's percentiles drift
        # from a cold fold's once past the singleton regime
        return {
            "compression": self.compression,
            "exact_max": self.exact_max,
            "means": self._means,
            "weights": self._weights,
            "buffer": self._buffer,
            "count": self.count,
            "total": self.total,
            "min": self.min,
            "max": self.max,
        }

    @classmethod
    def from_state(cls, state: dict) -> "TDigest":
        if "rng" in state or "values" in state:
            # transparent migration from a QuantileAccumulator (reservoir)
            # sidecar state: the reservoir's values become singletons and
            # the full-stream count/total/min/max carry over, so a
            # pre-digest sidecar keeps its accumulated distribution
            dig = cls(exact_max=max(int(state["capacity"]), 1))
            dig._means = sorted(float(v) for v in state["values"])
            dig._weights = [1.0] * len(dig._means)
            dig.count = int(state["count"])
            dig.total = float(state["total"])
            dig.min = state["min"]
            dig.max = state["max"]
            return dig
        dig = cls(
            compression=int(state["compression"]),
            exact_max=int(state["exact_max"]),
        )
        dig._means = [float(m) for m in state["means"]]
        dig._weights = [float(w) for w in state["weights"]]
        dig._buffer = [float(x) for x in state.get("buffer", [])]
        dig.count = int(state["count"])
        dig.total = float(state["total"])
        dig.min = state["min"]
        dig.max = state["max"]
        return dig


class ServingStats:
    """Aggregate per-request ``decode`` events into the percentile block
    ``obs summarize`` renders and ``obs diff`` gates on.

    Cold requests (``warm`` false — the first request per generator pays
    the XLA compile) are excluded from every distribution and reported
    as a count: a p99 that is really "the compile happened" explains
    nothing.  ``merge`` combines independently-built stats (the fold
    engine keeps one per stream); every piece of state is either a sum,
    a min/max, or a mergeable digest, so merged == fed-as-one-stream."""

    def __init__(self, capacity: int = 4096) -> None:
        self.capacity = int(capacity)
        self.acc = {
            name: TDigest(exact_max=capacity) for _, name in METRICS
        }
        # per-tenant accumulators, keyed by the normalized tenant tag
        # (``tenant_of``): each tenant gets its own mergeable digest per
        # metric plus request/cold/token counts, so obs/slo.py can
        # evaluate p99 budgets per class without a second stream pass.
        # ``class`` is the tenant's priority class (deterministic max —
        # one class per tenant in practice; the max makes a conflicting
        # mixed stream reduce identically in any merge order).
        self.tenants: dict[str, dict] = {}
        self.requests = 0
        self.cold = 0
        self.tokens = 0
        self.prompt_tokens = 0
        # rate stats over ALL decode events (cold included): the
        # all-cold-smoke fallback mean in `obs summarize` needs them
        # without a second pass over the stream
        self.all_rate_sum = 0.0
        self.all_rate_n = 0
        # warm-span aggregate throughput: warm output tokens over the
        # wall-clock span [earliest warm request start, latest warm
        # completion] — the system-level tokens/s number the Gemma-on-TPU
        # serving comparison reports per chip, next to the per-request
        # percentiles (which can look healthy while the batch is empty).
        # Spans are PER ENGINE (the "engine" event field, else the run id
        # of the emitting process): a CI job stream holds a decode smoke
        # AND a serve-bench smoke minutes apart — and can hold TWO decode
        # smokes from different processes — and one shared span would be
        # >99% idle gap, a number that moves with test ordering, not
        # serving performance.
        self.spans: dict[str, list] = {}  # label -> [tokens, start, end]
        self.chips = 0

    @staticmethod
    def _span_label(event: dict) -> str:
        # engine AND run: every ServeEngine stamps engine="serve", so
        # two serve-bench processes appending to one job stream would
        # otherwise merge into a single span whose idle gap between the
        # runs swamps the aggregate (the same failure mode the per-run
        # keying already fixed for engine-less decode smokes)
        engine = event.get("engine")
        run = event.get("run")
        if engine:
            return f"{engine}:{run}" if run else str(engine)
        return f"run:{run}" if run else "decode"

    def _tenant(self, name: str) -> dict:
        tb = self.tenants.get(name)
        if tb is None:
            tb = self.tenants[name] = {
                "acc": {
                    m: TDigest(exact_max=self.capacity)
                    for _, m in METRICS
                },
                "requests": 0, "cold": 0, "tokens": 0, "class": None,
            }
        return tb

    def observe(self, event: dict) -> None:
        self.requests += 1
        self.tokens += int(
            event.get("new_tokens", 0) * event.get("batch", 1)
        )
        self.prompt_tokens += int(
            event.get("prompt_len", 0) * event.get("batch", 1)
        )
        chips = event.get("chips")
        if chips:
            self.chips = max(self.chips, int(chips))
        rate = event.get("tok_per_s")
        if rate is not None:
            self.all_rate_sum += float(rate)
            self.all_rate_n += 1
        tb = self._tenant(tenant_of(event))
        tb["requests"] += 1
        tb["tokens"] += int(
            event.get("new_tokens", 0) * event.get("batch", 1)
        )
        pc = event.get("priority_class")
        if pc and (tb["class"] is None or str(pc) > tb["class"]):
            tb["class"] = str(pc)
        if not event.get("warm"):
            self.cold += 1
            tb["cold"] += 1
            return
        for field, name in METRICS:
            v = event.get(field)
            # 0.0 is a real measurement (inline dispatch has zero queue
            # delay; a clock-granularity TTFT can floor to 0.0) — only
            # absence drops the sample.  Treating falsy as missing is the
            # bug class a regression test pins.
            if v is not None:
                self.acc[name].add(v)
                tb["acc"][name].add(v)
        tok = int(event.get("new_tokens", 0) * event.get("batch", 1))
        ts = event.get("ts")
        if ts is not None:
            start = ts - (event.get("dur") or 0.0)
            label = self._span_label(event)
            span = self.spans.get(label)
            if span is None:
                self.spans[label] = [tok, start, ts]
            else:
                span[0] += tok
                span[1] = min(span[1], start)
                span[2] = max(span[2], ts)

    def merge(self, other: "ServingStats") -> None:
        """Fold another stats object in (per-stream fold accumulators
        merged at render time; see obs/fold.py)."""
        for name, dig in other.acc.items():
            mine = self.acc.get(name)
            if mine is None:
                self.acc[name] = TDigest.from_state(dig.state_dict())
            else:
                mine.merge(dig)
        for t in sorted(other.tenants):
            ob = other.tenants[t]
            tb = self._tenant(t)
            for name, dig in ob["acc"].items():
                mine = tb["acc"].get(name)
                if mine is None:
                    tb["acc"][name] = TDigest.from_state(dig.state_dict())
                else:
                    mine.merge(dig)
            tb["requests"] += ob["requests"]
            tb["cold"] += ob["cold"]
            tb["tokens"] += ob["tokens"]
            if ob["class"] and (
                tb["class"] is None or ob["class"] > tb["class"]
            ):
                tb["class"] = ob["class"]
        self.requests += other.requests
        self.cold += other.cold
        self.tokens += other.tokens
        self.prompt_tokens += other.prompt_tokens
        self.all_rate_sum += other.all_rate_sum
        self.all_rate_n += other.all_rate_n
        self.chips = max(self.chips, other.chips)
        for label, span in other.spans.items():
            mine_span = self.spans.get(label)
            if mine_span is None:
                self.spans[label] = [span[0], span[1], span[2]]
            else:
                mine_span[0] += span[0]
                mine_span[1] = min(mine_span[1], span[1])
                mine_span[2] = max(mine_span[2], span[2])

    def state_dict(self) -> dict:
        return {
            "acc": {name: a.state_dict() for name, a in self.acc.items()},
            "tenants": {
                t: {
                    "acc": {
                        name: a.state_dict()
                        for name, a in tb["acc"].items()
                    },
                    "requests": tb["requests"],
                    "cold": tb["cold"],
                    "tokens": tb["tokens"],
                    "class": tb["class"],
                }
                for t, tb in sorted(self.tenants.items())
            },
            "requests": self.requests,
            "cold": self.cold,
            "tokens": self.tokens,
            "prompt_tokens": self.prompt_tokens,
            "all_rate_sum": self.all_rate_sum,
            "all_rate_n": self.all_rate_n,
            "spans": self.spans,
            "chips": self.chips,
        }

    @classmethod
    def from_state(cls, state: dict) -> "ServingStats":
        stats = cls()
        stats.acc = {
            name: TDigest.from_state(s)
            for name, s in state["acc"].items()
        }
        # pre-tenant sidecars lack the tenants map (the fold's version
        # bump rebuilds them anyway; direct state_dict round-trips in
        # tests may not)
        stats.tenants = {
            t: {
                "acc": {
                    name: TDigest.from_state(s)
                    for name, s in tb["acc"].items()
                },
                "requests": int(tb["requests"]),
                "cold": int(tb["cold"]),
                "tokens": int(tb["tokens"]),
                "class": tb.get("class"),
            }
            for t, tb in state.get("tenants", {}).items()
        }
        stats.requests = int(state["requests"])
        stats.cold = int(state["cold"])
        stats.tokens = int(state["tokens"])
        stats.prompt_tokens = int(state["prompt_tokens"])
        # reservoir-era sidecars predate the all-rate fields
        stats.all_rate_sum = float(state.get("all_rate_sum", 0.0))
        stats.all_rate_n = int(state.get("all_rate_n", 0))
        stats.spans = {
            k: [v[0], v[1], v[2]] for k, v in state["spans"].items()
        }
        stats.chips = int(state["chips"])
        return stats

    @classmethod
    def from_events(cls, events: list[dict], capacity: int = 4096):
        stats = cls(capacity)
        for e in events:
            if e.get("kind") == "decode":
                stats.observe(e)
        return stats

    def summary(self) -> dict | None:
        """The ``decode`` section of a run summary, or None when the run
        had no decode requests at all."""
        if not self.requests:
            return None
        rates = self.acc["tok_per_s"]
        # per-engine spans summed: idle gaps BETWEEN engines' activity
        # windows (decode smoke ... serve-bench smoke) don't count as
        # serving time; gaps within one engine's window still do
        span = sum(max(0.0, s[2] - s[1]) for s in self.spans.values())
        tokens_in_spans = sum(s[0] for s in self.spans.values())
        agg = tokens_in_spans / span if span > 0 else None
        chips = self.chips or 1
        return {
            "requests": self.requests,
            "cold": self.cold,
            "tokens": self.tokens,
            "prompt_tokens": self.prompt_tokens,
            "mean_tok_per_s": rates.mean,
            "agg_tok_per_s": agg,
            "chips": chips,
            "agg_tok_per_s_per_chip": (
                agg / chips if agg is not None else None
            ),
            "percentiles": {
                name: self.acc[name].summary()
                for _field, name in METRICS
                if self.acc[name].count
            },
            # per-tenant block, sorted so warm and cold folds render
            # byte-identically; absent only when no request carried a
            # tag at all AND none were observed (requests == 0 above)
            "tenants": {
                t: {
                    "requests": tb["requests"],
                    "cold": tb["cold"],
                    "tokens": tb["tokens"],
                    "class": tb["class"],
                    "percentiles": {
                        name: tb["acc"][name].summary()
                        for _field, name in METRICS
                        if tb["acc"][name].count
                    },
                }
                for t, tb in sorted(self.tenants.items())
            },
        }


def render_percentiles(p: dict) -> list[str]:
    """The ``-- decode percentiles --`` table lines for a summary's
    ``decode.percentiles`` block (stored-baseline dicts included)."""
    lines = [f"{'metric':<14} {'p50':>9} {'p95':>9} {'p99':>9} {'mean':>9}"]
    for name, s in p.items():
        row = [f"{name:<14}"]
        for key in ("p50", "p95", "p99", "mean"):
            v = s.get(key)
            row.append(f"{v:>9.4g}" if v is not None else f"{'n/a':>9}")
        lines.append(" ".join(row))
    return lines
