"""The period loop shared by the port's trainers (the core of
``ddl_tpu/train/loop.py:462-601``, ``BaseTrainer.train`` /
``_run_periods``).

Per period: ``run_period`` timed with ``perf_counter``, the non-finite
loss halt, the train line and its CSV rows (the period's metrics, its wall
time, steps/s, the device memory peak), then
``evaluate_period`` with the eval line and its rows.  Not ported yet (the
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
    ``num_periods``, ``halt_on_nan``, ``logger`` and ``device``;
    ``periods_run`` is the period cursor."""

    period_label = "Epoch"
    # CSV name of the per-period wall time
    time_metric = "epoch_time"
    periods_run = 0

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
            print(self.format_train_line(period, elapsed, steps, train_metrics))
            self.logger.log_many(train_metrics, period)
            self.logger.log(self.time_metric, elapsed, period)
            self.logger.log("steps_per_sec", steps / elapsed, period)
            peak = self.device_peak_bytes()
            if peak is not None:
                self.logger.log("hbm_peak_bytes", peak, period)
            eval_metrics = self.evaluate_period(period)
            if eval_metrics:
                print(self.format_eval_line(period, eval_metrics))
                self.logger.log_many(eval_metrics, period)
            self.periods_run = period + 1
