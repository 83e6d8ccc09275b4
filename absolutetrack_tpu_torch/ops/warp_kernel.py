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

Three row-weight modes (``ROWS_F32``, ``ROWS_INT8``, ``ROWS_BF16``), the
number formats of the Pallas body ``_tile_contrib``:

* f32 (the default here): JAX's gather, ``resample.py:36-76``, exact f32.
* int8 (``set_int8_window``, uint8 sources only; ``pallas_warp.py:166-173``):
  the two row weights quantize to ``round(127 w)`` and the row mix is an
  exact integer sum.
* bf16 (``set_bf16_rows``, or ``bf16_rows=True`` a call, which the
  trackers pass for a bf16 model; ``pallas_warp.py:174-186``): how every
  Pallas kernel samples by default. The row weights round to bf16, the
  source too (uint8 exactly, f32 to nearest even, ``:614-615``), the two
  row products (exact in f32) sum with one f32 rounding, and the column
  mix stays f32 (``:188-192``).

When both switches hold and the source is uint8, int8 wins, as in
``_tile_contrib``. The JAX switches reach only the Pallas kernels, so
JAX's CPU gather (``resample.py:101-106``) ignores them; the port's apply
on both devices, K1 and the plain version alike, so that the CPU tests
hold each mode against the Pallas kernels in interpret mode.
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
_INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()  # f32(1/127), as K1's

ROWS_F32, ROWS_INT8, ROWS_BF16 = 0, 1, 2  # row-weight modes, K1's codes
ROW_MODE_NAMES = {ROWS_F32: "f32", ROWS_INT8: "int8", ROWS_BF16: "bf16"}

_INT8_WINDOW = False  # module switch: the int8 row mix for uint8 sources
_BF16_ROWS = False  # module switch: bf16 row weights, the Pallas default


def set_int8_window(enabled: bool) -> bool:
    """Switch the int8 row-weight mode (uint8 sources only) for the calls
    that follow, on either device; returns the previous value. Mirrors
    ``absolutetrack_tpu/ops/pallas_warp.py::set_int8_window``."""
    global _INT8_WINDOW
    prev = _INT8_WINDOW
    _INT8_WINDOW = bool(enabled)
    return prev


def set_bf16_rows(enabled: bool) -> bool:
    """Switch the bf16 row-weight mode (any source) for the calls that
    follow, on either device; returns the previous value. The int8 mode
    takes precedence on uint8 sources while both hold."""
    global _BF16_ROWS
    prev = _BF16_ROWS
    _BF16_ROWS = bool(enabled)
    return prev


def row_mode_for(images: torch.Tensor, bf16_rows: bool = False) -> int:
    """The row-weight mode that the switches give a source of this type;
    ``bf16_rows`` asks for bf16 rows whatever ``set_bf16_rows`` holds."""
    if _INT8_WINDOW and images.dtype == torch.uint8:
        return ROWS_INT8
    return ROWS_BF16 if bf16_rows or _BF16_ROWS else ROWS_F32


def _check_row_mode(row_mode, dtype) -> None:
    if row_mode not in ROW_MODE_NAMES:
        raise ValueError(f"unknown row-weight mode {row_mode!r}")
    if row_mode == ROWS_INT8 and dtype != torch.uint8:
        raise ValueError(f"int8 rows need uint8 images, got {dtype}")


def _to_bf16(t: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to bf16 (nearest even), back in f32."""
    return t.to(torch.bfloat16).float()


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
    coords,  # (N, P, 2) (x, y), or an (x, y) tuple of (N, P) or (N, H, W) planes
    src_valid_hw: Optional[Tuple[int, int]] = None,
    row_mode: int = ROWS_F32,
) -> torch.Tensor:
    """Bilinear sampling, 0 where any tap is outside the source -> f32 of
    the planes' shape.

    ``absolutetrack_tpu/ops/resample.py:36-76`` line for line.
    ``src_valid_hw`` is the true source extent of pre-padded ``images``.
    ``row_mode`` ``ROWS_INT8`` (uint8 ``images`` only) takes the int8 row
    mix of ``pallas_warp.py:166-173`` reduced to the two rows it weights:
    ``q = round(127 w)`` half to even, the row sums exact in int32, times
    f32(1/127), then the column mix in f32. ``ROWS_BF16`` takes the bf16
    row mix of ``:174-186``: the hat weights ``1 - wy`` and ``1 - |1 - wy|``
    and the four taps rounded to bf16, each row's two products summed in
    f32, then the column mix in f32 with weights ``1 - wx`` and ``1 - |1 - wx|``.
    """
    _check_row_mode(row_mode, images.dtype)
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

    idx = view_index(image_idx, images.shape[0]).view((-1,) + (1,) * (x.dim() - 1))
    f00 = images[idx, y0c, x0c]
    f01 = images[idx, y0c, x0c + 1]
    f10 = images[idx, y0c + 1, x0c]
    f11 = images[idx, y0c + 1, x0c + 1]

    if row_mode == ROWS_INT8:
        # an invalid pixel is masked below; a 0 weight keeps its int32 sums in range
        wyv = torch.where(valid, wy, torch.zeros((), dtype=wy.dtype, device=wy.device))
        q0 = torch.round((1 - wyv) * 127).to(torch.int32)
        q1 = torch.round(wyv * 127).to(torch.int32)
        t0 = (q0 * f00.int() + q1 * f10.int()).float() * _INV127
        t1 = (q0 * f01.int() + q1 * f11.int()).float() * _INV127
        out = t0 * (1 - wx) + t1 * wx
    elif row_mode == ROWS_BF16:
        # the Pallas hat weights of the two taps: 1 - w and 1 - |1 - w|,
        # which differs from w where 1 - w rounds (coordinates in [0, 1));
        # bf16 x bf16 products are exact in f32, so each row sum rounds once;
        # uint8 and bf16 taps are exact in bf16, f32 taps round
        ay, ax = 1 - wy, 1 - wx
        r0, r1 = _to_bf16(ay), _to_bf16(1 - ay)
        tap = _to_bf16 if images.dtype == torch.float32 else torch.Tensor.float
        g00, g01, g10, g11 = (tap(f) for f in (f00, f01, f10, f11))
        t0 = r0 * g00 + r1 * g10
        t1 = r0 * g01 + r1 * g11
        out = t0 * ax + t1 * (1 - ax)
    else:
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
    """The built library, loaded once, the count of launches, and the
    counts of launches by (N, P) shape and by row-weight mode name."""

    def __init__(self):
        self.launches = 0
        self.shapes = Counter()
        self.modes = Counter()
        self._fn = None

    def reset_counts(self) -> None:
        self.launches = 0
        self.shapes.clear()
        self.modes.clear()

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
            fn.argtypes = ARGTYPES
            self._fn = fn
        return self._fn

    def __call__(self, images, image_idx, x, y, src_valid_hw=None, row_mode=ROWS_F32) -> torch.Tensor:
        if images.device.type != "cuda":
            # the kernel would dereference host pointers
            raise ValueError(f"K1 needs CUDA tensors, images are on {images.device}")
        _check_cuda_inputs(images, image_idx, x, y, src_valid_hw, row_mode)
        n, p = x.shape[0], x.shape[1:].numel()
        out = torch.empty(x.shape, dtype=torch.float32, device=images.device)
        stream = torch.cuda.current_stream(images.device).cuda_stream
        err = self.function()(*k1_arguments(images, image_idx, x, y, out, src_valid_hw, row_mode, stream))
        if err != 0:
            raise RuntimeError(f"K1 bilinear_sample launch failed: error {err}")
        self.launches += 1
        self.shapes[(n, p)] += 1
        self.modes[ROW_MODE_NAMES[int(row_mode)]] += 1
        return out


# the C signature of k1_bilinear_sample, in order
ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int,  # src, dtype code
    ctypes.c_int, ctypes.c_int,  # row-weight mode, pixels a crop row
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # idx, x, y
    ctypes.c_void_p,  # out
    ctypes.c_int, ctypes.c_int64, ctypes.c_int,  # views, view/row stride
    ctypes.c_int, ctypes.c_int,  # valid h, w
    ctypes.c_int64, ctypes.c_int64,  # n, p
    ctypes.c_void_p,  # stream
]


FLAT_ROW_PX = 8  # flat (N, P) planes: a gather's 8 x 4 lanes on 32 consecutive pixels


def row_px(x: torch.Tensor) -> int:
    """The crop row width that K1 lays its warps' 8 x 4 pixel patches on:
    W of (N, H, W) planes. It sets the order of K1's gathers, never a
    result; flat (N, P) planes take ``FLAT_ROW_PX``."""
    return x.shape[-1] if x.dim() == 3 else FLAT_ROW_PX


def k1_arguments(images, image_idx, x, y, out, src_valid_hw, row_mode, stream) -> tuple:
    """The arguments of one ``k1_bilinear_sample`` call, in ``ARGTYPES`` order."""
    v, hp, wp = images.shape
    h, w = src_valid_hw or (hp, wp)
    n, p = x.shape[0], x.shape[1:].numel()
    return (
        images.data_ptr(), _DTYPE_CODES[images.dtype],
        int(row_mode), row_px(x),
        image_idx.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr(),
        v, hp * wp, wp, h, w, n, p, stream,
    )


def _check_cuda_inputs(images, image_idx, x, y, src_valid_hw, row_mode=ROWS_F32):
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
    _check_row_mode(row_mode, images.dtype)
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError("coordinate planes must be float32")
    if x.dim() not in (2, 3) or x.shape != y.shape:
        raise ValueError(f"x and y must be (N, P) or (N, H, W) planes, got {tuple(x.shape)}, {tuple(y.shape)}")
    if image_idx.dtype != torch.int64 or image_idx.shape != (x.shape[0],):
        raise ValueError("image_idx must be an int64 (N,) tensor")
    # K1 indexes inside a slot (and a little past it) and inside a view with 32-bit integers
    if x.shape[1:].numel() + 256 * row_px(x) >= 2**31 or images.shape[1] * images.shape[2] >= 2**31:
        raise ValueError(f"planes {tuple(x.shape)} or views {tuple(images.shape)} are too large for K1")
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
    bf16_rows: bool = False,
) -> torch.Tensor:
    """Bilinear sampling -> f32 of the planes' shape: K1 on a CUDA tensor,
    the plain version on a CPU tensor, in the row-weight mode that
    ``set_int8_window``, ``set_bf16_rows`` and ``bf16_rows`` give
    (``row_mode_for``). Give K1 (N, H, W) planes of crops: it lays its
    gathers on the crop's rows."""
    row_mode = row_mode_for(images, bf16_rows)
    if images.device.type == "cpu":
        return bilinear_sample_plain(images, image_idx, coords, src_valid_hw, row_mode)
    if images.device.type != "cuda":
        raise ValueError(f"no bilinear_sample for device {images.device}")
    x, y = split_coord_planes(coords)
    return K1(images, image_idx, x, y, src_valid_hw, row_mode)
