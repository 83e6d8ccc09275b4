"""The program's spans (``absolutetrack_tpu_torch/utils/profiling.py``).

A span is recorded only while a ``torch.profiler`` session is active; it
nests under the span open around it, carries its counts, leaves one start
and one end marker on the profiler's host timeline, and the recorder holds
one profiled stretch, bounded. The eval driver's chunk and the train step
carry the spans the benchmark's per-layer metrics read, at the same points
as the eval driver's ``stage_hook``. On the CPU no span has device events;
the ``cuda`` test reads device ms on a card.

This file imports no JAX, so its ``cuda`` test also runs on a machine with
a card and no JAX (``--noconftest``).
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from absolutetrack_tpu_torch.apps import eval_lib
from absolutetrack_tpu_torch.models.config import ModelConfig
from absolutetrack_tpu_torch.models.umetrack import UmeTrackModel
from absolutetrack_tpu_torch.training import synthetic, train
from absolutetrack_tpu_torch.utils import profiling

CFG = ModelConfig.tiny()
EVAL_STAGES = ["assemble", "upload", "crop_slots", "warp_and_inputs", "trunk", "scan_tail", "fk"]
TRAIN_CHILDREN = ["train.forward", "train.backward", "train.optimizer"]
PROTOCOL_CHILDREN = ["eval.calib_pass", "eval.calibrate", "eval.track_pass"]


def cpu_profile():
    """A CPU profiler session after a span without one, which ends the
    recorder's stretch as the program's untraced work does."""
    with profiling.span("untraced"):
        pass
    return profile(activities=[ProfilerActivity.CPU])


def names(spans, parent):
    return [s["name"] for s in spans if s["parent"] == parent]


@pytest.fixture(scope="module")
def lockstep():
    """Two recordings of 16 frames of the smoke script's scene and a damped
    tiny model on the CPU."""
    recs = chip_smoke.scene_recordings(chip_smoke.build_scene(1, n_frames=17), range(2), 16)
    model = chip_smoke.damped(UmeTrackModel(CFG, device="cpu", generator=torch.Generator().manual_seed(0)))
    return model, recs


@pytest.fixture(scope="module")
def train_case():
    cfg = ModelConfig.tiny(input_size=(32, 32))
    model = UmeTrackModel(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    opt = train.make_optimizer()
    step = train.make_train_step(cfg, opt, branch="both")
    batch = synthetic.synthetic_sequence_batch(2, t=2, cfg=cfg, seed=3)
    return step, train.init_train_state(model, opt), batch, synthetic.synthetic_hand_model_m(2, seed=3)


def test_no_span_is_recorded_without_a_profiler():
    with cpu_profile():
        with profiling.span("before"):
            pass
    assert not profiling.autograd_profiler._is_profiler_enabled
    with profiling.span("outside") as sp:
        sp.count("bytes", 8)
    assert sp is profiling.OFF
    assert [s["name"] for s in profiling.spans()] == ["before"]


def test_spans_nest_count_and_each_session_starts_empty(monkeypatch):
    with cpu_profile():
        assert profiling.autograd_profiler._is_profiler_enabled
        with profiling.span("outer") as outer:
            with profiling.span("first") as first:
                first.count("bytes", 3)
                first.count("bytes", 4)
            with profiling.span("second"):
                with profiling.span("inner"):
                    torch.ones(4) + 1
        with profiling.span("root"):
            pass
    assert outer is not profiling.OFF
    got = profiling.spans()
    assert [(s["name"], s["parent"]) for s in got] == [
        ("outer", None), ("first", 0), ("second", 0), ("inner", 2), ("root", None)]
    assert got[1]["counts"] == {"bytes": 7} and got[0]["counts"] == {}
    assert all(s["device_ms"] is None for s in got)
    for s in got:
        assert s["host_start_ns"] <= s["host_end_ns"]
    assert got[0]["host_start_ns"] <= got[1]["host_start_ns"] and got[2]["host_end_ns"] <= got[0]["host_end_ns"]

    monkeypatch.setattr(profiling.RECORDER, "limit", 3)
    with cpu_profile():
        for i in range(5):
            with profiling.span(f"s{i}"):
                pass
    assert [s["name"] for s in profiling.spans()] == ["s0", "s1", "s2"]
    assert profiling.RECORDER.dropped == 2


def test_device_trace_starts_a_new_stretch(tmp_path):
    with profiling.device_trace(str(tmp_path / "a")):
        with profiling.span("first"):
            pass
    with profiling.device_trace(str(tmp_path / "b")):
        with profiling.span("second"):
            pass
    assert [s["name"] for s in profiling.spans()] == ["second"]
    trace = next((tmp_path / "b").glob("*.pt.trace.json")).read_text()
    assert '"second>"' in trace and '"second<"' in trace


def test_each_span_leaves_one_marker_pair_that_encloses_no_op():
    with cpu_profile() as prof:
        with profiling.span("outer"):
            a = torch.ones(64, 64)
            with profiling.span("inner"):
                a @ a
            a + 1
    events = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()]
    for name in ("outer", "inner"):
        for mark in (name + ">", name + "<"):
            assert [e[2] for e in events].count(mark) == 1, mark
    marks = [e for e in events if e[2][-1] in "<>"]
    ops = [e for e in events if e[2][-1] not in "<>"]
    assert any(op[2] == "aten::mm" for op in ops)
    for s, e, name in marks:
        assert not [op for op in ops if s <= op[0] and op[1] <= e], name
    at = {name: s for s, _, name in marks}
    mm = next(op for op in ops if op[2] == "aten::mm")
    assert at["outer>"] < at["inner>"] < mm[0] and mm[1] < at["inner<"] < at["outer<"]


def test_eval_pass_spans_follow_the_stage_hook(lockstep):
    model, recs = lockstep
    stages = []
    with cpu_profile():
        res = eval_lib.track_recordings_batched(model, recs, chunk_size=8, stage_hook=stages.append)
    assert stages == EVAL_STAGES * 2
    got = profiling.spans()
    chunks = [i for i, s in enumerate(got) if s["name"] == "eval.chunk"]
    assert len(chunks) == 2 and all(got[i]["parent"] is None for i in chunks)
    for i in chunks:
        assert names(got, i) == ["eval." + s for s in EVAL_STAGES]
    assert names(got, None) == ["eval.chunk", "eval.chunk", "eval.readback"]
    frames = 2 * 8 * 4 * 512 * 640  # recordings x chunk x views x the padded frame, uint8
    labels = 8 * 2 * (4 * 16 + 2 * 22 + 2 * 16 + 2) * 4  # camera_to_world, angles, wrists, confidences; f32
    uploads = [s["counts"] for s in got if s["name"] == "eval.upload"]
    assert uploads == [{"bytes": frames + labels, "pinned_bytes": 0}] * 2  # no page-locked staging on the CPU
    assert [s["counts"] for s in got if s["name"] == "eval.assemble"] == [{"staging_wait_us": 0}] * 2
    assert len(res) == 2 and all(x.valid_tracking.all() for x in res)


def test_train_step_spans(train_case):
    step, state, batch, hand = train_case
    with cpu_profile():
        state, _ = step(state, batch, hand)
    got = profiling.spans()
    assert names(got, None) == ["train.step"]
    assert names(got, 0) == TRAIN_CHILDREN


def test_no_profiler_no_span_event_or_marker(monkeypatch, lockstep, train_case):
    """Without a profiler the eval pass and the train step make no span,
    no CUDA event, and call no ``record_function``."""

    def refuse(*a, **kw):
        raise AssertionError("called without a profiler")

    monkeypatch.setattr(profiling, "Span", refuse)
    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    model, recs = lockstep
    eval_lib.track_recordings_batched(model, recs, chunk_size=8)
    step, state, batch, hand = train_case
    step(state, batch, hand)


def test_unknown_skeleton_protocol_spans(lockstep):
    """The protocol is one ``eval.protocol`` span around its two passes and
    the calibration; each pass's chunks nest in it, the solve in the
    calibration, and the counters count pass 1's frames and the solve's
    windows, valid frames and iterations."""
    model, recs = lockstep
    with cpu_profile():
        run = eval_lib.track_recordings_unknown_skeleton(model, lambda: recs, recs[0][0].hand_model, "gn")
    got = profiling.spans()
    assert names(got, None) == ["eval.protocol"]
    assert names(got, 0) == PROTOCOL_CHILDREN
    at = {s["name"]: i for i, s in enumerate(got) if s["parent"] == 0}
    chunks = ["eval.chunk", "eval.chunk", "eval.readback"]  # 16 frames (under the 30 of a calibration), chunks of 8
    assert names(got, at["eval.calib_pass"]) == chunks and names(got, at["eval.track_pass"]) == chunks
    assert names(got, at["eval.calibrate"]) == ["eval.gn_solve"]
    assert got[at["eval.calib_pass"]]["counts"] == {"frames": 2 * 16}
    valid = sum(int(c.valid_tracking.sum()) for c in run.calibration)
    assert valid >= 2 * 2 * 2
    assert got[at["eval.calibrate"]]["counts"] == {"windows": 4, "valid_frames": valid, "iters": 6}
    assert [len(r.valid_tracking[0]) for r in run.results] == [16, 16] and len(run.scales) == 2


def test_unknown_skeleton_protocol_without_a_profiler(monkeypatch, lockstep):
    """Without a profiler the protocol makes no span, no CUDA event and no marker."""

    def refuse(*a, **kw):
        raise AssertionError("called without a profiler")

    monkeypatch.setattr(profiling, "Span", refuse)
    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    model, recs = lockstep
    eval_lib.track_recordings_unknown_skeleton(model, lambda: recs, recs[0][0].hand_model, "gn")


@pytest.mark.cuda
def test_device_spans_time_the_stream_on_a_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda")
    a = torch.randn(2048, 2048, device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with profiling.span("outer", dev):
            with profiling.span("work", dev):
                for _ in range(20):
                    a = a @ a / 2048
            with profiling.span("host"):
                pass
    got = profiling.spans()
    assert got[2]["device_ms"] is None
    assert 0 < got[1]["device_ms"] <= got[0]["device_ms"]
    assert np.isfinite(got[0]["device_ms"])
