from ddl_tpu_torch.train.steps import make_eval_step
from ddl_tpu_torch.train.trainer import Trainer, resolve_device

__all__ = ["Trainer", "make_eval_step", "resolve_device"]
