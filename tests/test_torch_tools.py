"""Port parity: the demo's tools (``absolutetrack_tpu_torch/utils/profiling.py``,
``utils/native.py``, ``apps/demo/{multiprocess,visualizer,bridges}.py``,
``apps/run_replay_visualize.py`` and ``DemoConfig.visualize``) against the
JAX package's on the CPU.

Inputs: seeded numpy arrays; a label JSON of ``chip_smoke.build_scene``
with its box-mesh hand (4 views, 3 frames) and a reference-named tiny
``.pt``; fake ``leap`` and ``pyrealsense2`` modules (no vendor SDK is
installed). Tolerances: the FPS EMA, the numpy fallbacks, the
drawings and the bridges' outputs exact; the native ops bit-equal to the
JAX binding's on the same inputs where that binding loads (the same source,
``native/abstrack_host.cpp``, built here by the port); the replay's tracked
keypoints within the protocol's 0.5 mm of JAX's (``tests/test_torch_protocol.py``,
each package rendering its own mesh frames) with validity equal; its dumped
frames pixel-equal; its crop panels at most one level apart and >= 95% equal
(the crops are the warp's f32 samples truncated to uint8, and the warp rule
of ``tests/test_torch_warp.py`` holds >= 95% of samples within 0.05 of JAX's,
so a few % may cross a level; measured >= 98.9%, none 2 apart).
"""

import io
import json
import sys
import threading
import types
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from absolutetrack_tpu.apps import run_replay_visualize as jreplay
from absolutetrack_tpu.apps.demo import bridges as jbridges
from absolutetrack_tpu.apps.demo import visualizer as jvis
from absolutetrack_tpu.utils import native as jnative
from absolutetrack_tpu.utils import profiling as jprof
from absolutetrack_tpu_torch.apps import run_replay_visualize as replay
from absolutetrack_tpu_torch.apps.demo import bridges, visualizer
from absolutetrack_tpu_torch.apps.demo import main as demo_main
from absolutetrack_tpu_torch.apps.demo import pipeline as pipe
from absolutetrack_tpu_torch.apps.demo.multiprocess import run_multiprocess_demo
from absolutetrack_tpu_torch.models.config import ModelConfig
from absolutetrack_tpu_torch.utils import native, profiling

jax.config.update("jax_platforms", "cpu")

LANDMARK_TOL_MM = 0.5
CROPS_EQUAL = 0.95
REPLAY_FRAMES = 3


class _Clock:
    """A perf_counter that steps by a fixed sequence of seconds."""

    def __init__(self, steps):
        self.t, self.steps = 100.0, list(steps)

    def __call__(self):
        self.t += self.steps.pop(0) if self.steps else 0.004
        return self.t


def _patch_clocks(monkeypatch, steps):
    monkeypatch.setattr(profiling.time, "perf_counter", _Clock(steps))


# --------------------------------------------------------------------------
# profiling
# --------------------------------------------------------------------------


def test_stage_timers_and_fps_match_jax(monkeypatch):
    """The FPS EMA as JAX's. The port has no ``StageTimers``: its stage
    timing is the spans of ``tests/test_torch_spans.py``."""
    steps = [0.0, 0.033, 0.041, 0.016]

    def drive(mod):
        monkeypatch.setattr(mod.time, "perf_counter", _Clock(steps))
        fps = mod.FpsCounter(alpha=0.2)
        return [fps.tick() for _ in range(4)]

    want, got = drive(jprof), drive(profiling)
    assert got == want
    assert want[0] == 0.0 and want[-1] > 0
    assert not hasattr(profiling, "StageTimers")


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    with profiling.device_trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)


# --------------------------------------------------------------------------
# the native host library
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nh():
    assert native.native_available(), "g++ builds the library from native/abstrack_host.cpp"
    assert native.HOST.library_path().parent == native.BUILD_DIR
    return native.NativeHost()


def _native_inputs():
    rng = np.random.default_rng(0)
    src = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    mx = rng.uniform(-5, 165, (48, 48)).astype(np.float32)
    my = rng.uniform(-5, 125, (48, 48)).astype(np.float32)
    m = np.eye(4, dtype=np.float32)
    m[0, 3], m[1, 3], m[0, 1] = 2.25, -1.5, 0.1
    bgr = rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)
    return src, mx, my, m, bgr


def _native_outputs(host):
    src, mx, my, m, bgr = _native_inputs()
    return host.remap_bilinear(src, mx, my), host.warp_homography(src, m, (32, 40)), host.bgr_to_gray(bgr)


@pytest.mark.parametrize("which", ["native", "numpy"])
def test_native_host_ops_match_the_jax_binding(nh, which):
    """The port's build of the source against the JAX binding's library,
    and the numpy fallbacks against JAX's (bit-equal). The homography warp
    and the gray conversion are bit-equal; the remap within two f32 ulps
    (2**-22 relative; measured 1.96e-7): the committed library was built
    with ``-march=native`` and fuses the bilinear sum's products into FMAs
    (the source built with ``-mfma -ffp-contract=fast`` reproduces it bit
    for bit), the port's portable build does not."""
    jhost = jnative.NativeHost()
    if which == "native" and jhost.lib is None:
        pytest.skip("the JAX binding's library does not load here")
    port = native.NativeHost()
    if which == "numpy":
        jhost.lib, port.lib = None, None
    for i, (got, want) in enumerate(zip(_native_outputs(port), _native_outputs(jhost))):
        assert got.dtype == want.dtype and got.shape == want.shape
        if which == "native" and i == 0:
            np.testing.assert_allclose(got, want, rtol=2.0**-22, atol=0)
        else:
            np.testing.assert_array_equal(got, want)
    if which == "native":  # the library and its fallback compute the same function
        for a, b in zip(_native_outputs(nh), _native_outputs(port)):
            np.testing.assert_allclose(a, b, atol=1e-3)


def _ring(nh, slots=4, size=64):
    buf = bytearray(nh.lib.at_ring_header_bytes() + slots * size)
    return native.FrameRing(memoryview(buf), slots, size, init=True), size


def _drain(ring, size):
    out, got = np.zeros(size, np.uint8), []
    while ring.pop(out):
        got.append(int(out[0]))
    return got


@pytest.mark.parametrize("pushes,want", [(3, [0, 1, 2]), (7, [3, 4, 5, 6])])
def test_frame_ring_fifo_and_drop_oldest(nh, pushes, want):
    ring, size = _ring(nh)
    for i in range(pushes):
        ring.push(np.full(size, i, np.uint8))
    assert len(ring) == len(want)
    assert _drain(ring, size) == want
    assert len(ring) == 0


def test_frame_ring_checks_sizes(nh):
    ring, size = _ring(nh)
    with pytest.raises(ValueError, match="does not fit a slot"):
        ring.push(np.zeros(size + 1, np.uint8))
    with pytest.raises(ValueError, match="needs"):
        native.FrameRing(memoryview(bytearray(16)), 4, size, init=True)


def test_frame_ring_threaded_stress(nh):
    """SPSC stress: concurrent producer and consumer threads; the consumer
    only ever sees frames in order (drop-oldest may skip, never reorder,
    repeat or tear: every word of a popped slot holds the frame's index)."""
    slots, size = 4, 1024
    buf = bytearray(nh.lib.at_ring_header_bytes() + slots * size)
    ring = native.FrameRing(memoryview(buf), slots, size, init=True)
    n_frames, seen, torn = 2000, [], []
    stop = threading.Event()

    def producer():
        for i in range(n_frames):
            ring.push(np.full(size // 4, i, np.uint32))
        stop.set()

    def consumer():
        out = np.zeros(size // 4, np.uint32)
        while not stop.is_set() or len(ring):
            if ring.pop(out):
                torn.append(not (out == out[0]).all())
                seen.append(int(out[0]))

    threads = [threading.Thread(target=producer), threading.Thread(target=consumer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads) and seen and not any(torn)
    assert (np.diff(np.asarray(seen)) > 0).all() and seen[-1] == n_frames - 1


def test_run_multiprocess_demo_delivers_frames():
    seen = []
    n = run_multiprocess_demo(max_frames=10, source_kind="synthetic",
                              on_frame=lambda i, mono: seen.append((i, mono.shape, mono.dtype)))
    assert n == len(seen) > 0
    assert all(s[1:] == ((2, 480, 640), np.uint8) for s in seen)
    idx = [i for i, _, _ in seen]
    assert idx == sorted(set(idx))  # drop-oldest: strictly increasing


# --------------------------------------------------------------------------
# the visualizer and the replay CLI
# --------------------------------------------------------------------------


def _points(seed, n=21):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-10, 200, (n, 2)).astype(np.float32)
    pts[3] = np.nan  # a landmark off the view
    return pts


def test_draw_skeleton_is_pixel_equal_to_jax():
    for edges in ("UME_EDGES", "MP_EDGES"):
        want = jvis.draw_skeleton(np.zeros((180, 200, 3), np.uint8), _points(1), getattr(jvis, edges), (0, 255, 0))
        got = visualizer.draw_skeleton(np.zeros((180, 200, 3), np.uint8), _points(1), getattr(visualizer, edges),
                                       (0, 255, 0))
        np.testing.assert_array_equal(got, want)
        assert want.any()
    assert visualizer.UME_EDGES == jvis.UME_EDGES and visualizer.HAND_COLORS == jvis.HAND_COLORS


def test_image_visualizer_render_is_pixel_equal_to_jax(monkeypatch):
    """Three frames through each package's visualizer on the same clock
    (its FPS is drawn): every view pixel-equal."""
    rng = np.random.default_rng(2)
    views = rng.integers(0, 255, (2, 120, 160, 3), dtype=np.uint8)
    dets = [{0: _points(3)}, {1: _points(4)}]
    reproj = {0: {0: _points(5), 1: _points(6)}, 1: {1: _points(7)}}
    outs = []
    for mod in (jvis, visualizer):
        _patch_clocks(monkeypatch, [0.0, 0.05, 0.04])  # time.perf_counter, shared by both packages
        viz = mod.ImageVisualizer(show=False)
        outs.append(([viz.render(views, dets, reproj) for _ in range(3)], viz.fps.fps))
    (want, want_fps), (got, got_fps) = outs
    for a, b in zip(want, got):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
    assert got_fps == want_fps > 0


def test_run_pipeline_visualizes_when_asked(tmp_path, monkeypatch):
    """``DemoConfig(visualize=True)``: each frame's views go to the
    visualizer with that frame's detections and the tracked hands
    reprojected into each view."""
    scene = chip_smoke.build_scene(0, REPLAY_FRAMES, mesh=True)
    path = tmp_path / "recording_00.json"
    path.write_text(json.dumps(chip_smoke.labels_json(scene)))
    labels, frames, detector = demo_main.build_replay(str(path), 2)
    stereo = labels.cameras_at(0).map(lambda x: x[list(demo_main.STEREO_VIEWS)])
    model = pipe.UmeTrackModel(ModelConfig.tiny(), device="cpu")
    live = pipe.LiveTracker(model, labels.hand_model, cameras=stereo, opts=pipe.TrackerConfig(crop_size=(32, 32)))
    calls = []

    class Recorder:
        def render(self, rgb, dets, reproj):
            calls.append((rgb.shape, [sorted(d) for d in dets], {v: sorted(h) for v, h in reproj.items()}))

    monkeypatch.setattr(pipe, "ImageVisualizer", Recorder)
    results = []
    pipe.run_pipeline(demo_main.stereo_pair(frames), detector, live,
                      pipe.DemoConfig(num_views=2, send_udp=False, visualize=True),
                      on_result=lambda i, kp, fps: results.append(sorted(kp)), max_frames=2)
    assert len(calls) == len(results) == 2
    for (shape, dets, reproj), hands in zip(calls, results):
        assert shape[0] == 2 and shape[-1] == 3 and len(dets) == 2
        assert reproj == {0: hands, 1: hands}
    assert pipe.DemoConfig().visualize is False


@pytest.fixture(scope="module")
def replay_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("replay")
    scene = chip_smoke.build_scene(4, REPLAY_FRAMES, mesh=True)
    labels = root / "recording_00.json"
    labels.write_text(json.dumps(chip_smoke.labels_json(scene)))
    pt = root / "tiny.pt"
    torch.save(chip_smoke.reference_state_dict(ModelConfig.tiny(), 4), pt)
    return dict(root=root, labels=str(labels), pt=str(pt))


def _replay_argv(inputs, dump):
    return ["--labels", inputs["labels"], "--checkpoint", inputs["pt"], "--max-frames", str(REPLAY_FRAMES),
            "--dump-dir", dump, "--crops", "--no-udp"]


def test_run_replay_visualize_matches_jax(replay_inputs, monkeypatch):
    """Both mains at tiny width (JAX's through its ModelConfig patched to
    ``tiny()``): tracked keypoints, the printed line, and the dumped
    frames and crop panels."""
    import absolutetrack_tpu.models as jmodels
    import cv2

    root = replay_inputs["root"]
    captured = []
    real = jreplay.eval_lib.track_recording

    def capture(*a, **k):
        captured.append(real(*a, **k))
        return captured[-1]

    monkeypatch.setattr(jmodels, "ModelConfig", _TinyJConfig(jmodels.ModelConfig))
    monkeypatch.setattr(jreplay.eval_lib, "track_recording", capture)
    jbuf, pbuf = io.StringIO(), io.StringIO()
    with redirect_stdout(jbuf):
        jreplay.main(_replay_argv(replay_inputs, str(root / "jax")))
    with redirect_stdout(pbuf):
        got = replay.main(_replay_argv(replay_inputs, str(root / "port")) + ["--tiny-arch", "--torch-device", "cpu"])
    (want,) = captured
    np.testing.assert_array_equal(got.valid_tracking, want.valid_tracking)
    v = want.valid_tracking
    assert v.any()
    d = np.linalg.norm(got.tracked_keypoints - want.tracked_keypoints, axis=-1)[v]
    assert d.max() <= LANDMARK_TOL_MM, d.max()
    assert jbuf.getvalue().startswith("mean keypoint error over replay") and pbuf.getvalue()[:40] == jbuf.getvalue()[:40]
    names = sorted(p.name for p in (root / "jax").iterdir())
    assert names == sorted(p.name for p in (root / "port").iterdir()) and len(names) == 2 * REPLAY_FRAMES
    for name in names:
        a, b = (cv2.imread(str(root / k / name)).astype(np.int16) for k in ("jax", "port"))
        assert a.shape == b.shape
        if name.startswith("frame_"):
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            assert np.abs(a - b).max() <= 1 and (a == b).all(-1).mean() >= CROPS_EQUAL, name


class _TinyJConfig:
    """JAX's ModelConfig with its default constructor giving ``tiny()``."""

    def __init__(self, real):
        self.real = real

    def __call__(self, **kw):
        return self.real.tiny(**kw)

    def __getattr__(self, name):
        return getattr(self.real, name)


def test_replay_needs_cv2_only_to_draw(replay_inputs, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises ImportError
    argv = ["--labels", replay_inputs["labels"], "--checkpoint", replay_inputs["pt"], "--max-frames", "2",
            "--no-udp", "--tiny-arch", "--torch-device", "cpu"]
    with redirect_stdout(io.StringIO()):
        res = replay.main(argv)
    assert res.tracked_keypoints.shape == (2, 2, 21, 3)
    with pytest.raises(ImportError):
        replay.main(argv + ["--dump-dir", str(replay_inputs["root"] / "never")])


# --------------------------------------------------------------------------
# the bridges, with fake vendor SDKs
# --------------------------------------------------------------------------


def _fake_leap():
    leap = types.ModuleType("leap")
    enums = types.ModuleType("leap.enums")
    enums.HandType = types.SimpleNamespace(Left="L", Right="R")
    leap.enums = enums

    class Listener:
        def __init__(self):
            pass

    class Connection:
        def __init__(self):
            self.listeners, self.opened = [], 0

        def add_listener(self, listener):
            self.listeners.append(listener)

        def open(self):
            conn = self

            class _Open:
                def __enter__(self):
                    conn.opened += 1

                def __exit__(self, *exc):
                    conn.opened -= 1

            return _Open()

    leap.Listener, leap.Connection = Listener, Connection
    return leap, enums


def _joint(x, y, z):
    return types.SimpleNamespace(x=x, y=y, z=z)


def _leap_event(seed):
    rng = np.random.default_rng(seed)

    def hand(kind):
        p = rng.uniform(-100, 100, (22, 3))
        return types.SimpleNamespace(
            type=kind,
            arm=types.SimpleNamespace(next_joint=_joint(*p[0])),
            palm=types.SimpleNamespace(position=_joint(*p[1])),
            digits=[types.SimpleNamespace(bones=[types.SimpleNamespace(next_joint=_joint(*p[2 + 4 * d + b]))
                                                  for b in range(4)]) for d in range(5)],
        )

    return types.SimpleNamespace(hands=[hand("L"), hand("R")])


def test_leap_bridge_matches_jax_with_a_fake_sdk(monkeypatch):
    leap, enums = _fake_leap()
    monkeypatch.setitem(sys.modules, "leap", leap)
    monkeypatch.setitem(sys.modules, "leap.enums", enums)
    outs = []
    for mod in (jbridges, bridges):
        bridge = mod.LeapBridge()
        assert bridge.poll() == {0: None, 1: None}
        with bridge:
            assert bridge._connection.opened == 1
            bridge._listener.on_tracking_event(_leap_event(5))
            outs.append(bridge.poll())
        assert bridge._connection.opened == 0
    for h in (0, 1):
        assert outs[1][h].shape == (21, 3)
        np.testing.assert_array_equal(outs[1][h], outs[0][h])
    pts = np.random.default_rng(0).standard_normal((21, 3))
    np.testing.assert_array_equal(bridges.leap_to_ume(pts), jbridges.leap_to_ume(pts))


def _fake_realsense(n_frames):
    rs = types.ModuleType("pyrealsense2")
    rs.stream = types.SimpleNamespace(color="color", depth="depth")
    rs.format = types.SimpleNamespace(rgb8="rgb8", z16="z16")
    rng = np.random.default_rng(7)
    frames = [(rng.integers(0, 255, (4, 6, 3), dtype=np.uint8), rng.integers(0, 4000, (4, 6)).astype(np.uint16))
              for _ in range(n_frames)]

    class _Frame:
        def __init__(self, data):
            self.data = data

        def get_data(self):
            return self.data

        def __bool__(self):
            return self.data is not None

    class _Frames:
        def __init__(self, color, depth):
            self.color, self.depth = color, depth

        def get_color_frame(self):
            return _Frame(self.color)

        def get_depth_frame(self):
            return _Frame(self.depth)

    class config:
        def __init__(self):
            self.streams = []

        def enable_stream(self, *args):
            self.streams.append(args)

    class pipeline:
        def __init__(self):
            self.i, self.running = 0, False

        def start(self, cfg):
            self.running, self.streams = True, cfg.streams

        def stop(self):
            self.running = False

        def wait_for_frames(self):
            self.i += 1
            if self.i == 2:  # a frame set without depth is skipped
                return _Frames(frames[0][0], None)
            return _Frames(*frames[(self.i - 1) % n_frames])

    rs.config, rs.pipeline = config, pipeline
    return rs


def test_realsense_reader_matches_jax_with_a_fake_sdk(monkeypatch):
    outs = []
    for mod in (jbridges, bridges):
        monkeypatch.setitem(sys.modules, "pyrealsense2", _fake_realsense(3))
        reader = mod.RealSenseReader(width=6, height=4, fps=15)
        assert reader.pipeline.running
        assert reader.pipeline.streams == [("color", 6, 4, "rgb8", 15), ("depth", 6, 4, "z16", 15)]
        it = iter(reader)
        outs.append([next(it) for _ in range(3)])
        reader.close()
        assert not reader.pipeline.running
    for (jc, jd), (c, d) in zip(*outs):
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(d, jd)


def test_bridges_say_which_sdk_is_missing(monkeypatch):
    monkeypatch.setitem(sys.modules, "leap", None)
    monkeypatch.setitem(sys.modules, "pyrealsense2", None)
    with pytest.raises(ImportError, match="Leap Motion SDK not installed"):
        bridges.LeapBridge()
    with pytest.raises(ImportError, match="pyrealsense2 not installed"):
        bridges.RealSenseReader()
