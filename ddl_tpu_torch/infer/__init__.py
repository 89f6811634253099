from ddl_tpu_torch.infer.decode import LMDecode, init_kv_cache, make_lm_generator

__all__ = ["LMDecode", "init_kv_cache", "make_lm_generator"]
