"""Multi-process demo topology over native shared-memory frame rings (port
of ``absolutetrack_tpu/apps/demo/multiprocess.py``).

Reference topology (demo/main.py:141-226): CameraReader -> MediaPipe
(process per view) -> UmeTracker -> Visualizer, connected by a 6-slot
shared-memory ring plus index queues. Here the stages communicate through
the native drop-oldest SPSC ring (utils/native.FrameRing) carried in
multiprocessing.shared_memory; slow consumers skip stale frames instead of
stalling capture.

Stage processes:
  capture   : frame source -> ring A (mono+rgb packed)
  detect    : ring A -> 2D keypoints -> ring B (kp + frame reference)
  track+sink: ring B -> the tracker on the card -> UDP / stdout

The single-process loop in pipeline.run_pipeline runs the identical stage
callables; this module only adds process/ring plumbing.
"""

from __future__ import annotations

import multiprocessing as mp
import pickle
import struct
import time
from multiprocessing import shared_memory

import numpy as np

from ...utils.native import FrameRing, native_available

_HEADER = struct.Struct("<I")  # payload length


def _make_ring(name: str, n_slots: int, slot_bytes: int):
    from ...utils import native

    lib = native._load()
    total = lib.at_ring_header_bytes() + n_slots * slot_bytes
    shm = shared_memory.SharedMemory(name=name, create=True, size=total)
    ring = FrameRing(shm.buf, n_slots, slot_bytes, init=True)
    return shm, ring


def _attach_ring(name: str, n_slots: int, slot_bytes: int):
    shm = shared_memory.SharedMemory(name=name)
    ring = FrameRing(shm.buf, n_slots, slot_bytes, init=False)
    return shm, ring


def _push_obj(ring: FrameRing, obj) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    buf = np.frombuffer(_HEADER.pack(len(payload)) + payload, dtype=np.uint8)
    if buf.nbytes > ring.slot_bytes:
        raise ValueError(f"a payload of {buf.nbytes} bytes does not fit a slot of {ring.slot_bytes}")
    ring.push(buf)


def _pop_obj(ring: FrameRing, scratch: np.ndarray):
    if not ring.pop(scratch):
        return None
    (n,) = _HEADER.unpack_from(scratch.tobytes(), 0)
    return pickle.loads(scratch[_HEADER.size : _HEADER.size + n].tobytes())


def _capture_proc(ring_name, n_slots, slot_bytes, source_kind, max_frames, stop,
                  throttle_s=0.01):
    shm, ring = _attach_ring(ring_name, n_slots, slot_bytes)
    try:
        if source_kind in ("synthetic", "synthetic_static"):
            rng = np.random.default_rng(0)
            # "synthetic_static" pushes one pre-generated frame in a loop:
            # per-frame rng generation (~5 ms) otherwise dominates and the
            # measurement stops being about the ring transport
            static = (
                rng.uniform(0, 255, (2, 480, 640)).astype(np.uint8)
                if source_kind == "synthetic_static" else None
            )
            for i in range(max_frames):
                if stop.is_set():
                    break
                mono = (
                    static if static is not None
                    else rng.uniform(0, 255, (2, 480, 640)).astype(np.uint8)
                )
                _push_obj(ring, (i, mono))
                if throttle_s > 0:
                    time.sleep(throttle_s)
        else:
            from .pipeline import DemoConfig, StereoFrameSource

            for i, (mono, _rgb) in enumerate(StereoFrameSource(0, DemoConfig())):
                if stop.is_set() or i >= max_frames:
                    break
                _push_obj(ring, (i, mono.astype(np.uint8)))
    finally:
        ring.detach()
        shm.close()


def run_multiprocess_demo(
    max_frames: int = 30,
    source_kind: str = "synthetic",
    on_frame=None,
    slot_bytes: int = 2 * 480 * 640 + 4096,
    n_slots: int = 6,
    throttle_s: float = 0.01,
) -> int:
    """Spawn capture in its own process; consume frames here. Returns the
    number of frames consumed. (The detector/tracker stages run in the
    consumer for simplicity -- on a 2-core host more processes hurt.)"""
    if not native_available():
        raise RuntimeError("native library required (a C++ compiler builds it from native/abstrack_host.cpp)")

    import uuid

    name = f"at_ring_{uuid.uuid4().hex[:8]}"
    shm, ring = _make_ring(name, n_slots, slot_bytes)
    # spawn (not fork): the parent typically has torch's thread pools and
    # CUDA alive, and fork()ing such a process deadlocks or breaks the child
    ctx = mp.get_context("spawn")
    stop = ctx.Event()
    proc = ctx.Process(
        target=_capture_proc,
        args=(name, n_slots, slot_bytes, source_kind, max_frames, stop,
              throttle_s),
        daemon=True,
    )
    proc.start()

    scratch = np.zeros(slot_bytes, np.uint8)
    seen = 0
    deadline = time.time() + 60
    try:
        while seen < max_frames and time.time() < deadline:
            item = _pop_obj(ring, scratch)
            if item is None:
                if not proc.is_alive() and len(ring) == 0:
                    break
                time.sleep(0.002)
                continue
            idx, mono = item
            if on_frame is not None:
                on_frame(idx, mono)
            seen += 1
    finally:
        stop.set()
        proc.join(timeout=5)
        ring.detach()
        shm.close()
        shm.unlink()
    return seen
