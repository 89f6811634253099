from ddl_tpu_torch.train.lm_steps import LMStepFns, LMTrainState, make_lm_step_fns
from ddl_tpu_torch.train.lm_trainer import LMRunConfig, LMTrainer
from ddl_tpu_torch.train.state import Optimizer, make_optimizer
from ddl_tpu_torch.train.steps import make_eval_step, make_train_step
from ddl_tpu_torch.train.trainer import Trainer, resolve_device

__all__ = [
    "LMRunConfig",
    "LMStepFns",
    "LMTrainState",
    "LMTrainer",
    "Optimizer",
    "Trainer",
    "make_eval_step",
    "make_lm_step_fns",
    "make_optimizer",
    "make_train_step",
    "resolve_device",
]
