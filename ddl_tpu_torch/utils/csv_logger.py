"""Append-only per-metric CSV logging (own copy of
``ddl_tpu/utils/csv_logger.py``: same files, same columns).

Reproduces the reference's observability layout (``single.py:260-269``):
one CSV per metric at ``<log_dir>/by_job_id/<job_id>/<metric>.csv``, each row

    [timestamp, job_id, global_rank, local_rank, model_start_job_id, epoch, value]

so the JAX package's analysis tooling (``ddl_tpu.bench.analysis``) reads the
port's runs as it reads its own.
Also provides the per-parameter gradient-statistics log (reference
``ddp.py:310-326``).
"""

from __future__ import annotations

import csv
import os
from datetime import datetime
from pathlib import Path
from typing import Mapping

import numpy as np

__all__ = ["MetricLogger"]

_TS_FMT = "%Y-%m-%d %H:%M:%S"


class MetricLogger:
    def __init__(
        self,
        log_dir: str | os.PathLike,
        job_id: str,
        global_rank: int = 0,
        local_rank: int = 0,
        model_start_job_id: str | None = None,
    ) -> None:
        self.log_dir = Path(log_dir)
        self.job_id = job_id
        self.global_rank = global_rank
        self.local_rank = local_rank
        # Lineage column: the job that produced the initial weights — the
        # resume source if any, else this job (reference single.py:268).
        self.model_start_job_id = model_start_job_id or job_id

    @property
    def job_dir(self) -> Path:
        return self.log_dir / "by_job_id" / self.job_id

    def log(self, metric: str, value: float, epoch: int) -> None:
        self.job_dir.mkdir(parents=True, exist_ok=True)
        with open(self.job_dir / f"{metric}.csv", "a", newline="") as f:
            csv.writer(f).writerow(
                [
                    datetime.now().strftime(_TS_FMT),
                    self.job_id,
                    self.global_rank,
                    self.local_rank,
                    self.model_start_job_id,
                    epoch,
                    value,
                ]
            )

    def log_many(self, metrics: Mapping[str, float], epoch: int) -> None:
        for k, v in metrics.items():
            self.log(k, float(v), epoch)

    def log_gradient_stats(self, named_grads: Mapping[str, np.ndarray], step: int) -> None:
        """Per-parameter |grad| statistics (min/mean/max/quartiles/std).

        Row schema follows reference ``ddp.py:325``:
        [timestamp, job_id, global_rank, local_rank, step, index, name,
         min, mean, max, p25, median, p75, std].

        Accepts either raw gradient arrays (stats computed here, as the
        reference does on host) or precomputed 7-vectors
        [min, mean, max, p25, median, p75, std] computed on the device
        (only 7 scalars per parameter cross to the host).
        """
        self.log_dir.mkdir(parents=True, exist_ok=True)
        now = datetime.now().strftime(_TS_FMT)
        with open(self.log_dir / "gradient.csv", "a", newline="") as f:
            writer = csv.writer(f)
            for i, (name, g) in enumerate(named_grads.items()):
                g = np.asarray(g, dtype=np.float64)
                if g.size == 0:
                    continue
                if g.shape == (7,):
                    stats = list(g)
                else:
                    a = np.abs(g).ravel()
                    stats = [
                        a.min(),
                        a.mean(),
                        a.max(),
                        np.quantile(a, 0.25),
                        np.median(a),
                        np.quantile(a, 0.75),
                        a.std(),
                    ]
                writer.writerow(
                    [now, self.job_id, self.global_rank, self.local_rank, step, i, name]
                    + stats
                )


def read_metric_csv(path: str | os.PathLike):
    """Parse one metric CSV into a list of dict rows (analysis helper)."""
    rows = []
    with open(path, newline="") as f:
        for rec in csv.reader(f):
            if len(rec) != 7:
                continue
            rows.append(
                {
                    "timestamp": rec[0],
                    "job_id": rec[1],
                    "global_rank": int(rec[2]),
                    "local_rank": int(rec[3]),
                    "model_start_job_id": rec[4],
                    "epoch": int(rec[5]),
                    "value": float(rec[6]),
                }
            )
    return rows
