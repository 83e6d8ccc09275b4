"""ctypes bindings for the native host runtime (port of
``absolutetrack_tpu/utils/native.py``).

The native library provides the host-side hot ops the reference outsourced
to cv2/shared_memory (warp, gray conversion, SPSC frame ring). The port
builds it at first use from ``native/abstrack_host.cpp`` with ``g++`` into
``absolutetrack_tpu_torch/_build/`` (one library per source hash, renamed
into place atomically, so concurrent builds never see a partial file). The
committed ``native/libabstrack_host.so`` is not loaded: it was built with
``-march=native`` on another machine and may hold instructions that this
machine's CPU lacks. Without a compiler everything degrades to NumPy --
``native_available()`` says which; ``FrameRing`` needs the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "abstrack_host.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]


class HostLibrary:
    """The built library, built and loaded once; ``None`` without a
    compiler or the source."""

    def __init__(self):
        self._lib: Optional[ctypes.CDLL] = None

    @staticmethod
    def library_path() -> Path:
        digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
        return BUILD_DIR / f"libabstrack_host_{digest}.so"

    def build(self) -> Path:
        """Compile the source unless a library of this exact source exists."""
        lib = self.library_path()
        if not lib.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run(
                    [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                    check=True, capture_output=True, text=True,
                )
                os.replace(tmp, lib)
            except subprocess.CalledProcessError as e:
                raise RuntimeError(f"g++ failed for {SOURCE}:\n{e.stderr}") from e
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        return lib

    def load(self) -> Optional[ctypes.CDLL]:
        if self._lib is not None:
            return self._lib
        if not SOURCE.exists():
            return None
        try:
            lib = ctypes.CDLL(str(self.build()))
        except FileNotFoundError:  # no compiler
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.at_remap_bilinear.argtypes = [f32p, ctypes.c_int, ctypes.c_int, f32p, f32p, f32p, ctypes.c_int, ctypes.c_int]
        lib.at_remap_bilinear.restype = None
        lib.at_warp_homography.argtypes = [f32p, ctypes.c_int, ctypes.c_int, f32p, f32p, ctypes.c_int, ctypes.c_int]
        lib.at_warp_homography.restype = None
        lib.at_bgr_to_gray.argtypes = [u8p, u8p, ctypes.c_int]
        lib.at_bgr_to_gray.restype = None
        lib.at_ring_header_bytes.argtypes = []
        lib.at_ring_header_bytes.restype = ctypes.c_size_t
        lib.at_ring_init.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64]
        lib.at_ring_init.restype = None
        lib.at_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
        lib.at_ring_push.restype = ctypes.c_uint64
        lib.at_ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
        lib.at_ring_pop.restype = ctypes.c_int
        lib.at_ring_size.argtypes = [ctypes.c_void_p]
        lib.at_ring_size.restype = ctypes.c_uint64
        self._lib = lib
        return lib


HOST = HostLibrary()


def _load() -> Optional[ctypes.CDLL]:
    return HOST.load()


def native_available() -> bool:
    return _load() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeHost:
    """Thin wrapper over the native ops with NumPy fallbacks."""

    def __init__(self):
        self.lib = _load()

    def remap_bilinear(self, src: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
        src = np.ascontiguousarray(src, np.float32)
        map_x = np.ascontiguousarray(map_x, np.float32)
        map_y = np.ascontiguousarray(map_y, np.float32)
        if map_x.shape != map_y.shape or src.ndim != 2:
            raise ValueError(f"remap of a {src.shape} source with maps {map_x.shape} and {map_y.shape}")
        out = np.empty(map_x.shape, np.float32)
        if self.lib is not None:
            self.lib.at_remap_bilinear(
                _f32p(src), src.shape[0], src.shape[1],
                _f32p(map_x), _f32p(map_y), _f32p(out),
                out.shape[0], out.shape[1],
            )
            return out
        # numpy fallback
        x0 = np.floor(map_x).astype(np.int32)
        y0 = np.floor(map_y).astype(np.int32)
        wx, wy = map_x - x0, map_y - y0
        h, w = src.shape
        valid = (map_x >= 0) & (x0 + 1 <= w - 1) & (map_y >= 0) & (y0 + 1 <= h - 1)
        x0c = np.clip(x0, 0, w - 2)
        y0c = np.clip(y0, 0, h - 2)
        out = (
            src[y0c, x0c] * (1 - wx) * (1 - wy)
            + src[y0c, x0c + 1] * wx * (1 - wy)
            + src[y0c + 1, x0c] * (1 - wx) * wy
            + src[y0c + 1, x0c + 1] * wx * wy
        )
        return np.where(valid, out, 0.0).astype(np.float32)

    def warp_homography(self, src: np.ndarray, m4x4: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
        src = np.ascontiguousarray(src, np.float32)
        m = np.ascontiguousarray(m4x4, np.float32)
        if m.shape != (4, 4) or src.ndim != 2:
            raise ValueError(f"homography warp of a {src.shape} source by a {m.shape} matrix")
        if self.lib is not None:
            out = np.empty(out_hw, np.float32)
            self.lib.at_warp_homography(
                _f32p(src), src.shape[0], src.shape[1], _f32p(m), _f32p(out), out.shape[0], out.shape[1],
            )
            return out
        oh, ow = out_hw
        us, vs = np.meshgrid(np.arange(ow), np.arange(oh))
        x = m[0, 0] * us + m[0, 1] * vs + m[0, 2] + m[0, 3]
        y = m[1, 0] * us + m[1, 1] * vs + m[1, 2] + m[1, 3]
        z = m[2, 0] * us + m[2, 1] * vs + m[2, 2] + m[2, 3]
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = np.where(z != 0, 1.0 / z, 0.0)
        return self.remap_bilinear(src, (x * inv).astype(np.float32), (y * inv).astype(np.float32))

    def bgr_to_gray(self, bgr: np.ndarray) -> np.ndarray:
        bgr = np.ascontiguousarray(bgr, np.uint8)
        if bgr.ndim != 3 or bgr.shape[2] != 3:
            raise ValueError(f"BGR frames are (H, W, 3), not {bgr.shape}")
        n = bgr.shape[0] * bgr.shape[1]
        if self.lib is not None:
            out = np.empty(bgr.shape[:2], np.uint8)
            self.lib.at_bgr_to_gray(
                bgr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                n,
            )
            return out
        w = np.asarray([114, 587, 299])
        return ((bgr.astype(np.uint32) @ w + 500) // 1000).astype(np.uint8)


class FrameRing:
    """SPSC frame ring over a shared-memory buffer (native-backed).

    Drop-oldest semantics matching the reference's live-capture slot ring
    (demo/main.py:144-171). Requires the native library.
    """

    def __init__(self, buffer, n_slots: int, slot_bytes: int, init: bool):
        self.lib = _load()
        if self.lib is None:
            raise RuntimeError("native library required for FrameRing (a C++ compiler builds it)")
        self._buf = np.frombuffer(buffer, dtype=np.uint8)
        self._addr = self._buf.ctypes.data_as(ctypes.c_void_p)
        self.slot_bytes = slot_bytes
        need = self.lib.at_ring_header_bytes() + n_slots * slot_bytes
        if len(self._buf) < need:
            raise ValueError(f"a ring of {n_slots} x {slot_bytes} bytes needs {need} bytes, the buffer has {len(self._buf)}")
        if init:
            self.lib.at_ring_init(self._addr, n_slots, slot_bytes)

    def push(self, frame: np.ndarray) -> int:
        frame = np.ascontiguousarray(frame)
        if frame.nbytes > self.slot_bytes:
            raise ValueError(f"a frame of {frame.nbytes} bytes does not fit a slot of {self.slot_bytes}")
        return int(self.lib.at_ring_push(self._addr, frame.ctypes.data_as(ctypes.c_void_p), frame.nbytes))

    def pop(self, out: np.ndarray) -> bool:
        if not (out.flags.c_contiguous and out.flags.writeable):
            raise ValueError("pop copies into a contiguous, writeable buffer")
        return bool(self.lib.at_ring_pop(self._addr, out.ctypes.data_as(ctypes.c_void_p), out.nbytes))

    def __len__(self) -> int:
        return int(self.lib.at_ring_size(self._addr))

    def detach(self) -> None:
        """Drop the buffer view so the underlying shared memory can close
        (numpy keeps an exported pointer otherwise)."""
        self._addr = None
        self._buf = None
