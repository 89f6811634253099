from ddl_tpu_torch.parallel.mesh import DATA_AXIS, PIPE_AXIS, Mesh, MeshSpec, build_mesh
from ddl_tpu_torch.parallel.sharding import LMMeshSpec, normalize_flash, resolve_auto_flash

__all__ = ["DATA_AXIS", "LMMeshSpec", "Mesh", "MeshSpec", "PIPE_AXIS", "build_mesh",
           "normalize_flash", "resolve_auto_flash"]
