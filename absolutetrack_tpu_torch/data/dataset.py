"""Dataset discovery and sharding for packed TorchIdx folders (port of
``absolutetrack_tpu/data/dataset.py``).

Datasets are folders of ``{split}/{field}.torch.{idx,bin}`` files;
discovery walks the tree; ``ShardSampler`` follows the reference sampler's
(rank, world size) contract with pad-to-equal, so that every rank sees the
same number of batches, then strides over the rank's io workers; its
shuffle draws from numpy's ``default_rng(seed + epoch)``, so its indices
equal the JAX package's exactly. Items are numpy arrays and label dicts.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

from .idxbin import TorchIdx

SPLIT_TRAIN = "training"
SPLIT_TEST = "testing"


def find_dataset_folders(
    root: str,
    fields: Sequence[str],
    split: str = SPLIT_TEST,
) -> List[str]:
    """Folders that hold ``{split}/{field}.torch.idx`` for every field."""
    out = []
    for cur, _dirs, files in sorted(os.walk(root)):
        if os.path.basename(cur) != split:
            continue
        if all(f"{f}.torch.idx" in files for f in fields):
            out.append(cur)
    return out


class PackedDataset:
    """Dict-of-fields random access over one or more packed folders,
    concatenated in order; memory maps give zero-copy reads."""

    def __init__(
        self,
        folders: Sequence[str],
        fields: Sequence[str],
        preload: bool = False,
    ):
        """``preload=True`` loads every .bin payload into RAM up front."""
        self.fields = list(fields)
        self._readers: List[Dict[str, TorchIdx]] = []
        self._cum: List[int] = [0]
        for folder in folders:
            readers = {
                f: TorchIdx(os.path.join(folder, f + ".torch.idx")) for f in fields
            }
            if preload:
                for r in readers.values():
                    r.preload()
            lens = {len(r) for r in readers.values()}
            if len(lens) != 1:
                raise ValueError(f"field length mismatch in {folder}")
            self._readers.append(readers)
            self._cum.append(self._cum[-1] + lens.pop())

    def __len__(self) -> int:
        return self._cum[-1]

    def __getitem__(self, i: int) -> Dict[str, object]:
        if i < 0:
            i += len(self)
        fi = int(np.searchsorted(self._cum, i, side="right")) - 1
        local = i - self._cum[fi]
        return {f: r[local] for f, r in self._readers[fi].items()}


class ShardSampler:
    """Deterministic (rank, world_size) sharding with pad-to-equal (or
    drop) and io-worker sub-sharding: indices are padded or dropped to a
    multiple of world_size, strided across ranks, then strided across this
    rank's io workers. The shuffle is keyed by ``seed + epoch``; call
    ``set_epoch`` between passes."""

    def __init__(
        self,
        n: int,
        rank: int = 0,
        world_size: int = 1,
        shuffle: bool = False,
        seed: int = 0,
        drop_remainder: bool = False,
        worker: int = 0,
        num_workers: int = 1,
    ):
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside world size {world_size}")
        if not 0 <= worker < num_workers:
            raise ValueError(f"worker {worker} outside {num_workers} workers")
        self.n = n
        self.rank = rank
        self.world_size = world_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.worker = worker
        self.num_workers = num_workers
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    @property
    def indices(self) -> np.ndarray:
        idx = np.arange(self.n)
        if self.shuffle:
            idx = np.random.default_rng(self.seed + self.epoch).permutation(self.n)
        r = len(idx) % self.world_size
        if r:
            if self.drop_remainder:
                idx = idx[: len(idx) - r]
            else:
                idx = np.concatenate([idx, idx[: self.world_size - r]])
        shard = idx[self.rank :: self.world_size]
        return shard[self.worker :: self.num_workers]

    def __iter__(self):
        return iter(self.indices.tolist())

    def __len__(self):
        per_rank = (
            self.n // self.world_size
            if self.drop_remainder
            else -(-self.n // self.world_size)
        )
        return len(range(self.worker, per_rank, self.num_workers))


def subsample_indices(n: int, fraction: float, seed: int = 0) -> np.ndarray:
    """Deterministic subsample of ``fraction`` of n indices, sorted: the
    same n, fraction and seed give the same subset."""
    k = max(1, int(round(n * fraction)))
    rng = np.random.default_rng(seed)
    return np.sort(rng.permutation(n)[:k])


class MappedDataset:
    """Lazy item-wise map that keeps len and indexing."""

    def __init__(self, base, fn):
        self.base = base
        self.fn = fn

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        return self.fn(self.base[i])


def map_dataset(base, fn) -> MappedDataset:
    return MappedDataset(base, fn)


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack a list of field dicts into batched arrays (other values into lists)."""
    out: Dict[str, np.ndarray] = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        out[k] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
    return out
