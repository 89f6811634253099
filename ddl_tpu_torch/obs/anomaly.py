"""Rolling anomaly detectors over per-period training signals (own copy
of ``ddl_tpu/obs/anomaly.py``).

Three detectors, all trailing-window so a long run's drift doesn't
stale the baseline:

* ``LossSpikeDetector`` — loss above ``mean + sigma * std`` of the
  trailing window (std floored at a fraction of the mean, so a
  converged flat loss doesn't alarm on noise).
* ``ThroughputRegressionDetector`` — steps/sec below ``(1 - drop)`` of
  the trailing mean: a straggler host, a recompile storm, input
  starvation.
* ``HBMGrowthDetector`` — bytes-in-use nondecreasing across the whole
  window and up by more than ``min_growth`` over it: the signature of a
  leak (a cache that never evicts, stale buffer references), not of
  steady-state training, whose footprint is flat after warmup.

``AnomalyMonitor`` bundles them: the trainer feeds each period's
metrics, anomalies are emitted as events the moment they fire and
surfaced again as an end-of-run summary.
"""

from __future__ import annotations

from collections import deque

import numpy as np

__all__ = [
    "AnomalyMonitor",
    "HBMGrowthDetector",
    "LossSpikeDetector",
    "ThroughputRegressionDetector",
]


class LossSpikeDetector:
    kind = "loss_spike"

    def __init__(
        self, window: int = 20, sigma: float = 4.0, min_points: int = 5,
        rel_floor: float = 0.02,
    ) -> None:
        self.values: deque[float] = deque(maxlen=window)
        self.sigma = sigma
        self.min_points = min_points
        self.rel_floor = rel_floor

    def observe(self, loss: float) -> dict | None:
        loss = float(loss)
        if not np.isfinite(loss):
            # never admit a non-finite loss into the baseline window: one
            # NaN period (routine under nan_policy="recover") would make
            # mean/threshold NaN and silently disable spike detection for
            # the next `window` periods — exactly when the run is shaky
            return None
        out = None
        if len(self.values) >= self.min_points:
            mean = float(np.mean(self.values))
            std = max(
                float(np.std(self.values)),
                self.rel_floor * abs(mean),
                1e-12,
            )
            threshold = mean + self.sigma * std
            if loss > threshold:
                out = {
                    "type": self.kind,
                    "value": loss,
                    "baseline": mean,
                    "threshold": threshold,
                }
        self.values.append(loss)
        return out


class ThroughputRegressionDetector:
    kind = "throughput_regression"

    def __init__(
        self, window: int = 20, drop: float = 0.3, min_points: int = 5
    ) -> None:
        self.values: deque[float] = deque(maxlen=window)
        self.drop = drop
        self.min_points = min_points
        self.suppressed = 0

    def observe(
        self, steps_per_sec: float, suppress: bool = False
    ) -> dict | None:
        """``suppress=True`` marks a period with a KNOWN throughput
        excursion (a recompile landed in it), so it neither raises a false
        anomaly nor drags the trailing baseline down and masks the next
        real regression: the period is judged not at all and admitted
        not at all."""
        if suppress:
            self.suppressed += 1
            return None
        sps = float(steps_per_sec)
        out = None
        if len(self.values) >= self.min_points and np.isfinite(sps):
            mean = float(np.mean(self.values))
            threshold = (1.0 - self.drop) * mean
            if sps < threshold:
                out = {
                    "type": self.kind,
                    "value": sps,
                    "baseline": mean,
                    "threshold": threshold,
                }
        self.values.append(sps)
        return out


class HBMGrowthDetector:
    kind = "hbm_growth"

    def __init__(self, window: int = 8, min_growth: float = 0.05) -> None:
        self.values: deque[float] = deque(maxlen=window)
        self.min_growth = min_growth

    def observe(self, bytes_in_use: float | None) -> dict | None:
        if bytes_in_use is None:
            return None
        self.values.append(float(bytes_in_use))
        if len(self.values) < self.values.maxlen:
            return None
        v = list(self.values)
        monotone = all(b >= a for a, b in zip(v, v[1:]))
        if monotone and v[0] > 0 and v[-1] > v[0] * (1.0 + self.min_growth):
            return {
                "type": self.kind,
                "value": v[-1],
                "baseline": v[0],
                "growth_frac": v[-1] / v[0] - 1.0,
            }
        return None


class AnomalyMonitor:
    """Feed per-period signals; anomalies stream as events and pile up
    for the end-of-run summary."""

    def __init__(self, writer=None, capturer=None, **detector_kwargs) -> None:
        self.writer = writer
        # a profile-on-anomaly capturer (or None; the port's is ROADMAP
        # item 13): every anomaly this monitor surfaces arms it
        self.capturer = capturer
        self.loss = LossSpikeDetector(
            **detector_kwargs.get("loss_spike", {})
        )
        self.throughput = ThroughputRegressionDetector(
            **detector_kwargs.get("throughput_regression", {})
        )
        self.hbm = HBMGrowthDetector(**detector_kwargs.get("hbm_growth", {}))
        self.anomalies: list[dict] = []

    def observe_period(
        self,
        idx: int,
        loss: float | None = None,
        steps_per_sec: float | None = None,
        hbm_bytes: float | None = None,
        compiles: int = 0,
    ) -> list[dict]:
        """``compiles`` is the period's compile count (from ``StepTrace``;
        always 0 in the port, which compiles nothing per step): a period
        that recompiled has a known, explained throughput excursion, so
        regression detection is suppressed for it."""
        found = []
        if loss is not None:
            a = self.loss.observe(loss)
            if a:
                found.append(a)
        if steps_per_sec is not None:
            a = self.throughput.observe(
                steps_per_sec, suppress=compiles > 0
            )
            if a:
                found.append(a)
        a = self.hbm.observe(hbm_bytes)
        if a:
            found.append(a)
        for a in found:
            a["idx"] = idx
            self.anomalies.append(a)
            if self.writer is not None:
                self.writer.emit("anomaly", step=idx, **a)
            if self.capturer is not None:
                self.capturer.trigger(a["type"], step=idx)
        return found

    def record(self, idx: int, type: str, **fields) -> dict:
        """Record an externally-detected anomaly (e.g. the training
        loop's non-finite-loss policy) into the same stream and summary
        the rolling detectors feed."""
        a = {"type": type, "idx": idx, **fields}
        self.anomalies.append(a)
        if self.writer is not None:
            self.writer.emit("anomaly", step=idx, **a)
        if self.capturer is not None:
            self.capturer.trigger(type, step=idx)
        return a

    def summary_lines(self) -> list[str]:
        lines = []
        for a in self.anomalies:
            base = (
                f" vs baseline {a['baseline']:.4g}" if "baseline" in a else ""
            )
            lines.append(
                f"[{a['type']}] step {a['idx']}: "
                f"value {a.get('value', float('nan')):.4g}{base}"
            )
        return lines
