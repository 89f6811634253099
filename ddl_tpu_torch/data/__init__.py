from ddl_tpu_torch.data.dataset import (
    AptosImageDataset,
    SyntheticAptosDataset,
    build_datasets,
)
from ddl_tpu_torch.data.lm_corpus import TokenBatches, TokenCorpus, encode_text_file
from ddl_tpu_torch.data.loader import DataLoader, to_device
from ddl_tpu_torch.data.sampler import ShardedEpochSampler
from ddl_tpu_torch.data.synthetic_lm import MarkovChain

__all__ = [
    "AptosImageDataset",
    "DataLoader",
    "MarkovChain",
    "ShardedEpochSampler",
    "SyntheticAptosDataset",
    "TokenBatches",
    "TokenCorpus",
    "build_datasets",
    "encode_text_file",
    "to_device",
]
