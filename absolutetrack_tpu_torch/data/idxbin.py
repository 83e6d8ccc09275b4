"""Reader and writer of the packed ``.torch.idx`` / ``.torch.bin`` format
(port of ``absolutetrack_tpu/data/idxbin.py``).

The ``.idx`` file is an int64 array:

  [0] magic 0x584449544E54  ("TNTIDX" little-endian bytes; 0 for legacy v0)
  [1] version = 1 (or 0 for the legacy vintage)
  [2] dtype code (see _DTYPE_CODES; 8 = msgpack object)
  [3] itemsize
  [4] N  (number of elements)
  [5] S  (total number of dims entries)
  [6 : 6+N+1]          dim offsets (into the sizes section)
  [6+N+1 : 6+2N+2]     data offsets (into .bin, in units of itemsize)
  [6+2N+2 : 6+2N+2+S]  sizes

The ``.bin`` holds raw array bytes, or msgpack blobs for dtype code 8.
Elements may have non-uniform shapes; a uniform file is also one
zero-copy memory map. The reader returns numpy arrays, as the JAX
package's does. Object fields go through the port's own msgpack codec
(``utils/flax_msgpack.py``), whose bytes equal ``msgpack.packb(obj,
use_bin_type=True)`` for the plain objects written here, so both packages
write the same files.
"""

from __future__ import annotations

import math
import os
from typing import Any, List, Sequence, Tuple

import numpy as np

from ..utils import flax_msgpack

MAGIC = 0x584449544E54
OBJECT_CODE = 8

_DTYPE_CODES = {
    1: "uint8",
    2: "int8",
    3: "int16",
    4: "int32",
    5: "int64",
    6: "float32",
    7: "float64",
}
_CODE_FOR_DTYPE = {np.dtype(v): k for k, v in _DTYPE_CODES.items()}


def _bin_path_for_idx(path: str) -> str:
    if not path.endswith(".idx"):
        raise ValueError(f"an index file ends in .idx: {path}")
    return path[:-4] + ".bin"


class TorchIdx:
    """Random-access reader for one field of a packed dataset.

    Uniform-shape files are exposed as a single zero-copy memory map;
    non-uniform files are read per element. Object (msgpack) files return
    decoded Python objects.
    """

    def __init__(self, idx_path: str, bin_path: str | None = None):
        self.source = idx_path
        self.bin_path = bin_path or _bin_path_for_idx(idx_path)
        header = np.fromfile(idx_path, dtype=np.int64)
        # version 0 requires magic 0, version 1 the TNTIDX magic
        version = int(header[1])
        if version == 0:
            if header[0] != 0:
                raise ValueError(f"bad magic in v0 file {idx_path}")
        elif version == 1:
            if header[0] != MAGIC:
                raise ValueError(f"bad magic in {idx_path}")
        else:
            raise ValueError(f"unsupported version {version} in {idx_path}")
        code = int(header[2])
        self.itemsize = int(header[3])
        n = int(header[4])
        s = int(header[5])
        ofs = 6
        dim_offsets = header[ofs : ofs + n + 1]
        ofs += n + 1
        self._data_offsets = header[ofs : ofs + n + 1]
        ofs += n + 1
        sizes = header[ofs : ofs + s]
        self._dims: List[Tuple[int, ...]] = [
            tuple(int(x) for x in sizes[dim_offsets[i] : dim_offsets[i + 1]])
            for i in range(n)
        ]
        self._n = n

        self.is_object = code == OBJECT_CODE
        if self.is_object:
            self.dtype = np.dtype("object")
        else:
            if code not in _DTYPE_CODES:
                raise ValueError(f"unrecognized dtype code {code} in {idx_path}")
            self.dtype = np.dtype(_DTYPE_CODES[code])
            if self.dtype.itemsize != self.itemsize:
                raise ValueError("itemsize mismatch")

        # a uniform file may start at a nonzero stored offset (a shared
        # .bin): the zero-copy view begins at that byte offset
        per_elem = math.prod(self._dims[0]) if n > 0 else 0
        self.is_uniform = (
            not self.is_object
            and n > 0
            and all(d == self._dims[0] for d in self._dims)
            and bool(np.all(np.diff(self._data_offsets) == per_elem))
        )
        self.shape = (n, *self._dims[0]) if self.is_uniform else None
        self._base_offset = int(self._data_offsets[0]) * self.itemsize if n else 0
        self._mmap: np.ndarray | None = None
        self._shm = None

    def __len__(self) -> int:
        return self._n

    def element_shape(self, i: int) -> Tuple[int, ...]:
        return self._dims[i]

    def _ensure_mmap(self) -> np.ndarray:
        if self._mmap is None:
            self._mmap = np.memmap(self.bin_path, dtype=np.uint8, mode="r")
        return self._mmap

    def preload(self, shared: bool = False) -> "TorchIdx":
        """Load the whole .bin payload into RAM and serve views from it.
        ``shared=True`` places it in POSIX shared memory, so that forked io
        workers map one copy; ``close`` releases that segment. Returns self."""
        if shared:
            from multiprocessing import shared_memory

            data = np.fromfile(self.bin_path, dtype=np.uint8)
            self._shm = shared_memory.SharedMemory(create=True, size=data.nbytes)
            buf = np.ndarray(data.shape, dtype=np.uint8, buffer=self._shm.buf)
            buf[:] = data
            self._mmap = buf
        else:
            self._mmap = np.fromfile(self.bin_path, dtype=np.uint8)
        return self

    def close(self) -> None:
        """Release a ``preload(shared=True)`` segment (no-op otherwise)."""
        if self._shm is not None:
            self._mmap = None
            self._shm.close()
            self._shm.unlink()
            self._shm = None

    def __getitem__(self, i: int):
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        start = int(self._data_offsets[i]) * self.itemsize
        end = int(self._data_offsets[i + 1]) * self.itemsize
        raw = self._ensure_mmap()[start:end]
        if self.is_object:
            return flax_msgpack.unpackb(raw.tobytes())
        return np.frombuffer(raw, dtype=self.dtype).reshape(self._dims[i])

    def as_array(self) -> np.ndarray:
        """Zero-copy view of a uniform file as one big array."""
        if not self.is_uniform:
            raise ValueError("file is not uniform-shape")
        raw = self._ensure_mmap()
        count = math.prod(self.shape)
        start = self._base_offset
        return np.frombuffer(
            raw[start : start + count * self.itemsize], dtype=self.dtype
        ).reshape(self.shape)


def write_torch_idx(
    idx_path: str,
    elements: Sequence[Any],
    dtype: np.dtype | str | None = None,
) -> None:
    """Write elements (ndarrays of one dtype, or msgpack-able objects)."""
    bin_path = _bin_path_for_idx(idx_path)
    is_object = dtype is None and not isinstance(elements[0], np.ndarray)

    blobs: List[bytes] = []
    dims: List[Tuple[int, ...]] = []
    if is_object:
        code, itemsize = OBJECT_CODE, 1
        for e in elements:
            blobs.append(flax_msgpack.packb(e))
            dims.append((len(blobs[-1]),))
    else:
        arrs = [np.asarray(e, dtype=dtype) for e in elements]
        dt = arrs[0].dtype
        code, itemsize = _CODE_FOR_DTYPE[dt], dt.itemsize
        for a in arrs:
            if a.dtype != dt:
                raise ValueError(f"elements mix dtypes {dt} and {a.dtype}")
            blobs.append(a.tobytes())
            dims.append(a.shape)

    n = len(blobs)
    dim_offsets = np.zeros(n + 1, np.int64)
    data_offsets = np.zeros(n + 1, np.int64)
    sizes: List[int] = []
    for i, (b, d) in enumerate(zip(blobs, dims)):
        dim_offsets[i + 1] = dim_offsets[i] + len(d)
        data_offsets[i + 1] = data_offsets[i] + len(b) // itemsize
        sizes.extend(d)

    header = np.concatenate(
        [
            np.asarray([MAGIC, 1, code, itemsize, n, len(sizes)], np.int64),
            dim_offsets,
            data_offsets,
            np.asarray(sizes, np.int64),
        ]
    )
    os.makedirs(os.path.dirname(idx_path) or ".", exist_ok=True)
    header.tofile(idx_path)
    with open(bin_path, "wb") as f:
        for b in blobs:
            f.write(b)
