from ddl_tpu_torch.parallel.sharding import LMMeshSpec, normalize_flash, resolve_auto_flash

__all__ = ["LMMeshSpec", "normalize_flash", "resolve_auto_flash"]
