"""Runtime telemetry for the port's trainers and its serving engine
(counterpart of ``ddl_tpu/obs/``): the JSONL event stream (``events.py``,
the JAX package's schema), per-step phase spans (``steptrace.py``), the
liveness watchdog (``watchdog.py``), the rolling anomaly detectors
(``anomaly.py``), the serving percentiles over per-request ``decode``
events (``serving.py``) and the HBM ledger's events (``hbm.py``, its emit
half).  The readers of the streams (the JAX package's ``obs/report.py``
and the rest of its CLI, with ``fold.py`` and the ledger's read half) are
ROADMAP item 13, its ``obs/slo.py`` and ``obs/trace.py`` item 12b.
"""

from ddl_tpu_torch.obs.anomaly import (
    AnomalyMonitor,
    HBMGrowthDetector,
    LossSpikeDetector,
    ThroughputRegressionDetector,
)
from ddl_tpu_torch.obs.events import EventWriter, events_path, read_events
from ddl_tpu_torch.obs.steptrace import PHASES, StepTrace
from ddl_tpu_torch.obs.watchdog import Watchdog

__all__ = [
    "AnomalyMonitor",
    "EventWriter",
    "HBMGrowthDetector",
    "LossSpikeDetector",
    "PHASES",
    "StepTrace",
    "ThroughputRegressionDetector",
    "Watchdog",
    "events_path",
    "read_events",
]
