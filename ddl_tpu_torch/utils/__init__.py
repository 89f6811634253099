from ddl_tpu_torch.utils.csv_logger import MetricLogger
from ddl_tpu_torch.utils.metrics import masked_classification_eval

__all__ = ["MetricLogger", "masked_classification_eval"]
