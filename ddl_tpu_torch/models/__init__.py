from ddl_tpu_torch.models.convert import from_jax_params, to_jax_params
from ddl_tpu_torch.models.densenet import (
    DenseNet,
    StageSpec,
    build_stage_specs,
    init_weights,
)

__all__ = [
    "DenseNet",
    "StageSpec",
    "build_stage_specs",
    "from_jax_params",
    "init_weights",
    "to_jax_params",
]
