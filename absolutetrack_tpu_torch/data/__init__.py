"""Data layer: packed TorchIdx files, dataset discovery, sharding, prefetch."""

from .idxbin import TorchIdx, write_torch_idx
from .dataset import PackedDataset, ShardSampler, find_dataset_folders
from .prefetch import PrefetchIterator

__all__ = [
    "PackedDataset",
    "PrefetchIterator",
    "ShardSampler",
    "TorchIdx",
    "find_dataset_folders",
    "write_torch_idx",
]
