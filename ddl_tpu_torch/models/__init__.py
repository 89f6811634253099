from ddl_tpu_torch.models.convert import (
    from_jax_params,
    lm_params_from_jax,
    lm_params_to_jax,
    to_jax_params,
)
from ddl_tpu_torch.models.densenet import (
    DenseNet,
    StageSpec,
    build_stage_specs,
    init_weights,
)
from ddl_tpu_torch.models.transformer import LMConfig, TransformerLM, init_lm_weights

__all__ = [
    "DenseNet",
    "LMConfig",
    "StageSpec",
    "build_stage_specs",
    "from_jax_params",
    "init_lm_weights",
    "init_weights",
    "lm_params_from_jax",
    "lm_params_to_jax",
    "to_jax_params",
    "TransformerLM",
]
