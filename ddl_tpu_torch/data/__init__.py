from ddl_tpu_torch.data.dataset import (
    AptosImageDataset,
    SyntheticAptosDataset,
    build_datasets,
)
from ddl_tpu_torch.data.loader import DataLoader, to_device
from ddl_tpu_torch.data.sampler import ShardedEpochSampler

__all__ = [
    "AptosImageDataset",
    "DataLoader",
    "ShardedEpochSampler",
    "SyntheticAptosDataset",
    "build_datasets",
    "to_device",
]
