"""The period loop shared by the port's trainers (the core of
``ddl_tpu/train/loop.py:462-601``, ``BaseTrainer.train`` /
``_run_periods``).

Per period: ``run_period`` timed with ``perf_counter``, the non-finite
loss halt, then -- when ``log_due(period)`` -- the train line and its CSV
rows under ``log_index(period)`` (the period's metrics, its wall time as
``time_metric``, steps/s, the family's ``rate_metrics``, the device memory
peak), then ``evaluate_period`` with the eval line and its rows.  The
defaults (every period logged under its own index, no extra rates) are
the epoch-based DenseNet trainer's; the LM trainer's step windows
override them (``ddl_tpu/train/loop.py:135, 237, 437``).  Not ported yet (the
next slice of the port): obs events, the hung-step watchdog, the profiler
hook, preemption, the recovery policy, snapshots and the best-metric gate
that saves them.
"""

from __future__ import annotations

from time import perf_counter

import numpy as np
import torch

__all__ = ["BaseTrainer"]


class BaseTrainer:
    """Families supply ``run_period(period) -> (metrics, steps)``,
    ``evaluate_period(period) -> metrics``, the two line formatters,
    ``num_periods``, ``halt_on_nan``, ``logger`` (None: no CSV rows) and
    ``device``; ``periods_run`` is the period cursor."""

    period_label = "Epoch"
    # CSV name of the per-period wall time
    time_metric = "epoch_time"
    periods_run = 0

    def rate_metrics(self, steps: int, elapsed: float) -> dict:
        """Extra per-period throughput metrics (tokens/s, ...)."""
        return {}

    def log_index(self, period: int) -> int:
        """The CSV 'epoch' column of a period's rows."""
        return period

    def log_due(self, period: int) -> bool:
        """Whether a period prints its train line and writes its rows."""
        return True

    def device_peak_bytes(self) -> int | None:
        """The device memory peak so far (the JAX loop's HBM watermark);
        None off a GPU."""
        device = getattr(self, "device", None)
        if device is None or device.type != "cuda":
            return None
        return torch.cuda.max_memory_allocated(device)

    def train(self, max_periods: int | None = None) -> None:
        """Run periods ``periods_run .. max_periods - 1`` (default: the
        configured count)."""
        max_periods = max_periods or self.num_periods
        while self.periods_run < max_periods:
            period = self.periods_run
            start = perf_counter()
            train_metrics, steps = self.run_period(period)
            elapsed = perf_counter() - start
            loss = train_metrics.get("loss")
            if loss is not None and not np.isfinite(loss) and self.halt_on_nan:
                raise RuntimeError(
                    f"Non-finite training loss {loss} at "
                    f"{self.period_label.lower()} {period}; halting."
                )
            idx = self.log_index(period)
            if self.log_due(period):
                print(self.format_train_line(period, elapsed, steps, train_metrics))
                if self.logger is not None:
                    self.logger.log_many(train_metrics, idx)
                    self.logger.log(self.time_metric, elapsed, idx)
                    self.logger.log("steps_per_sec", steps / elapsed, idx)
                    self.logger.log_many(self.rate_metrics(steps, elapsed), idx)
                    peak = self.device_peak_bytes()
                    if peak is not None:
                        self.logger.log("hbm_peak_bytes", peak, idx)
            eval_metrics = self.evaluate_period(period)
            if eval_metrics:
                print(self.format_eval_line(period, eval_metrics))
                if self.logger is not None:
                    self.logger.log_many(eval_metrics, idx)
            self.periods_run = period + 1
