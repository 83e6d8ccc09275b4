"""K1: the bilinear crop sampler, a CUDA kernel for Hopper, and its plain version.

Port of ``absolutetrack_tpu/ops/pallas_warp.py``. The Pallas module tiles
the source into VMEM windows (pass A, the overflow pass B and its
per-tile merge, narrow, banded and covering kernels, with placement
planners and slot slabbing) because Mosaic has no vector gather; those
are TPU mechanics, not behaviour. On Hopper one gathering kernel,
``csrc/bilinear_sample.cu``, computes the same function for every
coordinate pattern and every slot count in one launch. Its source note
says what bounds it.

``bilinear_sample`` dispatches on the device of its tensors: a CUDA tensor
launches K1 (or raises), a CPU tensor takes ``bilinear_sample_plain``. The
kernel is built with nvcc into a shared library with a C interface at
first use, under ``_build/`` beside this package, and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from collections import Counter
from pathlib import Path
from typing import Optional, Tuple

import torch

_PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = _PKG_DIR / "csrc" / "bilinear_sample.cu"
BUILD_DIR = _PKG_DIR / "_build"

_DTYPE_CODES = {torch.uint8: 0, torch.float32: 1, torch.bfloat16: 2}


def split_coord_planes(coords) -> Tuple[torch.Tensor, torch.Tensor]:
    """Accept (N, P, 2) interleaved coords or an (x, y) tuple of planes."""
    if isinstance(coords, tuple):
        return coords
    return coords[..., 0], coords[..., 1]


def view_index(image_idx: torch.Tensor, n_views: int) -> torch.Tensor:
    """JAX's gather rule for a view index: a negative index counts from the
    end once, then any index outside [0, V) clamps to the nearest view."""
    idx = image_idx.long()
    return torch.where(idx < 0, idx + n_views, idx).clamp(0, n_views - 1)


def bilinear_sample_plain(
    images: torch.Tensor,  # (V, H, W)
    image_idx: torch.Tensor,  # (N,) int
    coords,  # (N, P, 2) (x, y) or an (x, y) plane tuple
    src_valid_hw: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Bilinear sampling, 0 where any tap is outside the source -> (N, P) f32.

    ``absolutetrack_tpu/ops/resample.py:36-76`` line for line.
    ``src_valid_hw`` is the true source extent of pre-padded ``images``.
    """
    H, W = src_valid_hw or (images.shape[-2], images.shape[-1])
    x, y = split_coord_planes(coords)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    x0i = x0.to(torch.int32)
    y0i = y0.to(torch.int32)

    valid = (x >= 0) & (x0i + 1 <= W - 1) & (y >= 0) & (y0i + 1 <= H - 1)
    x0c = torch.clamp(x0i, 0, W - 2).long()
    y0c = torch.clamp(y0i, 0, H - 2).long()

    idx = view_index(image_idx, images.shape[0])[:, None]
    f00 = images[idx, y0c, x0c]
    f01 = images[idx, y0c, x0c + 1]
    f10 = images[idx, y0c + 1, x0c]
    f11 = images[idx, y0c + 1, x0c + 1]

    out = (
        f00 * (1 - wx) * (1 - wy)
        + f01 * wx * (1 - wy)
        + f10 * (1 - wx) * wy
        + f11 * wx * wy
    )
    return torch.where(valid, out, torch.zeros((), dtype=out.dtype, device=out.device))


def nvcc_command(source: Path, output: Path) -> list:
    """The K1 build: sm_90a, -O3, no fast-math (it would flush subnormals)."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = shutil.which("nvcc") or os.path.join(CUDA_HOME or "", "bin", "nvcc")
    return [
        nvcc,
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC",
        "-o", str(output), str(source),
    ]


class K1Kernel:
    """The built library, loaded once, the count of launches and the
    count of launches by (N, P) shape."""

    def __init__(self):
        self.launches = 0
        self.shapes = Counter()
        self._fn = None

    def reset_counts(self) -> None:
        self.launches = 0
        self.shapes.clear()

    @staticmethod
    def library_path() -> Path:
        digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
        return BUILD_DIR / f"libk1_{digest}.so"

    def build(self) -> Path:
        """Compile the source unless a library of this exact source exists."""
        lib = self.library_path()
        if not lib.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run(
                    nvcc_command(SOURCE, Path(tmp)),
                    check=True, capture_output=True, text=True,
                )
                os.replace(tmp, lib)
            except subprocess.CalledProcessError as e:
                raise RuntimeError(f"nvcc failed for {SOURCE}:\n{e.stderr}") from e
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        return lib

    def function(self):
        if self._fn is None:
            fn = ctypes.CDLL(str(self.build())).k1_bilinear_sample
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int,  # src, dtype code
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # idx, x, y
                ctypes.c_void_p,  # out
                ctypes.c_int, ctypes.c_int64, ctypes.c_int,  # views, view/row stride
                ctypes.c_int, ctypes.c_int,  # valid h, w
                ctypes.c_int64, ctypes.c_int64,  # n, p
                ctypes.c_void_p,  # stream
            ]
            self._fn = fn
        return self._fn

    def __call__(self, images, image_idx, x, y, src_valid_hw=None) -> torch.Tensor:
        if images.device.type != "cuda":
            # the kernel would dereference host pointers
            raise ValueError(f"K1 needs CUDA tensors, images are on {images.device}")
        _check_cuda_inputs(images, image_idx, x, y, src_valid_hw)
        v, hp, wp = images.shape
        h, w = src_valid_hw or (hp, wp)
        n, p = x.shape
        out = torch.empty((n, p), dtype=torch.float32, device=images.device)
        stream = torch.cuda.current_stream(images.device).cuda_stream
        err = self.function()(
            images.data_ptr(), _DTYPE_CODES[images.dtype],
            image_idx.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr(),
            v, hp * wp, wp, h, w, n, p, stream,
        )
        if err != 0:
            raise RuntimeError(f"K1 bilinear_sample launch failed: cudaError {err}")
        self.launches += 1
        self.shapes[(n, p)] += 1
        return out


def _check_cuda_inputs(images, image_idx, x, y, src_valid_hw):
    device = images.device
    for name, t in (("image_idx", image_idx), ("x", x), ("y", y)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, images on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if images.dim() != 3 or not images.is_contiguous():
        raise ValueError(f"images must be a contiguous (V, H, W) tensor, got {tuple(images.shape)}")
    if images.dtype not in _DTYPE_CODES:
        raise ValueError(f"images dtype {images.dtype} not in {list(_DTYPE_CODES)}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError("coordinate planes must be float32")
    if x.dim() != 2 or x.shape != y.shape:
        raise ValueError(f"x and y must be (N, P) planes, got {tuple(x.shape)}, {tuple(y.shape)}")
    if image_idx.dtype != torch.int64 or image_idx.shape != (x.shape[0],):
        raise ValueError("image_idx must be an int64 (N,) tensor")
    if src_valid_hw is not None:
        h, w = src_valid_hw
        if not (2 <= h <= images.shape[1] and 2 <= w <= images.shape[2]):
            raise ValueError(f"src_valid_hw {src_valid_hw} outside images {tuple(images.shape)}")
    elif images.shape[1] < 2 or images.shape[2] < 2:
        raise ValueError("images must be at least 2x2")


K1 = K1Kernel()


def bilinear_sample(
    images: torch.Tensor,
    image_idx: torch.Tensor,
    coords,
    src_valid_hw: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Bilinear sampling -> (N, P) f32: K1 on a CUDA tensor, the plain
    version on a CPU tensor."""
    if images.device.type == "cpu":
        return bilinear_sample_plain(images, image_idx, coords, src_valid_hw)
    if images.device.type != "cuda":
        raise ValueError(f"no bilinear_sample for device {images.device}")
    x, y = split_coord_planes(coords)
    return K1(images, image_idx, x, y, src_valid_hw)
