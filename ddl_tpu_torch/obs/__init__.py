"""Runtime telemetry for the port's trainers (counterpart of
``ddl_tpu/obs/``): the JSONL event stream (``events.py``, the JAX
package's schema), per-step phase spans (``steptrace.py``), the liveness
watchdog (``watchdog.py``) and the rolling anomaly detectors
(``anomaly.py``).  The readers of the streams (the JAX package's
``obs/report.py`` and the rest of its CLI) are ROADMAP item 13.
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
