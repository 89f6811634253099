from ddl_tpu_torch.utils.metrics import masked_classification_eval

__all__ = ["masked_classification_eval"]
