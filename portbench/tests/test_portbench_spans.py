"""The readers of the program's spans (``metrics/*`` over ``metrics/_spans.py``)
on hand-built records: a ``Trace`` with known device intervals and span
markers, and the program's span record replaced by a known list."""

import pytest

from absolutetrack_tpu_torch.utils import profiling
from portbench.harness import core
from portbench.harness.trace import Trace
from portbench.metrics import _spans


def marks(name, *intervals):
    """Host events of the markers of spans over ``intervals`` (us): each
    marker lasts 1 us, the span lies between them."""
    out = []
    for s, e in intervals:
        out += [(s - 1, s, name + ">"), (e, e + 1, name + "<")]
    return out


def span(name, device_ms=None, **counts):
    return dict(name=name, parent=None, host_start_ns=0, host_end_ns=1, counts=counts, device_ms=device_ms)


@pytest.fixture
def program(monkeypatch):
    """Sets the program's span record to the given list."""
    def put(spans):
        monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    return put


def test_assemble_and_idle_read_the_markers(program):
    # device busy 0-100, 400-500, 900-1000 us: gaps 100-400 and 500-900 (700 us)
    device = [(0, 100, "k"), (400, 500, "k"), (900, 1000, "k")]
    host = marks("eval.assemble", (50, 350), (600, 900)) + [(60, 70, "aten::add")]
    rec = dict(trace=Trace(1e-3, device, host))
    program([span("eval.assemble")] * 2)
    assert core.metric_reader("assemble_host_ms.eval")(rec) == pytest.approx((300 + 300) / 2 * 1e-3)
    # inside the gaps: 100-350 (250) and 600-900 (300) of 700
    assert core.metric_reader("idle_under_assemble.eval")(rec) == pytest.approx(100 * 550 / 700)


def test_device_readers_take_the_program_record(program):
    host = (marks("eval.upload", (0, 10), (20, 30)) + marks("eval.scan_tail", (40, 50), (60, 70))
            + marks("train.forward", (0, 1), (2, 3)) + marks("train.backward", (4, 5), (6, 7))
            + marks("train.optimizer", (8, 9), (10, 11)))
    rec = dict(trace=Trace(1e-3, [(0, 100, "k")], host))
    program([span("eval.upload", 30.0, bytes=250_000_000), span("eval.upload", 20.0, bytes=250_000_000),
             span("eval.scan_tail", 60.0), span("eval.scan_tail", 80.0),
             span("train.forward", 200.0), span("train.forward", 210.0),
             span("train.backward", 400.0), span("train.backward", 380.0),
             span("train.optimizer", 20.0), span("train.optimizer", 30.0)])
    assert core.metric_reader("upload_gb_per_s.eval")(rec) == pytest.approx(5e8 / 0.05 / 1e9)
    assert core.metric_reader("scan_tail_device_ms.eval")(rec) == pytest.approx(70.0)
    assert core.metric_reader("forward_device_ms.train")(rec) == pytest.approx(205.0)
    assert core.metric_reader("backward_device_ms.train")(rec) == pytest.approx(390.0)
    assert core.metric_reader("optimizer_device_ms.train")(rec) == pytest.approx(25.0)


@pytest.mark.parametrize("metric", ["upload_gb_per_s.eval", "scan_tail_device_ms.eval", "forward_device_ms.train"])
def test_device_readers_find_nothing_without_a_matching_record(program, metric):
    """No device ms (a CPU run), a record of another stretch (counts
    differ), or a program without spans: no value."""
    name = {"upload_gb_per_s.eval": "eval.upload", "scan_tail_device_ms.eval": "eval.scan_tail",
            "forward_device_ms.train": "train.forward"}[metric]
    rec = dict(trace=Trace(1e-3, [(0, 100, "k")], marks(name, (0, 10), (20, 30))))
    read = core.metric_reader(metric)
    program([span(name, None, bytes=1)] * 2)
    assert read(rec) is None
    program([span(name, 5.0, bytes=1)] * 3)
    assert read(rec) is None
    program([span(name, 5.0, bytes=1)] * 2)
    assert read(rec) is not None
    assert read(dict(trace=Trace(1e-3, [(0, 100, "k")], []))) is None


def test_a_cpu_pass_gives_the_host_readings_and_no_device_one():
    """A tiny pass of the program's train step under the harness's own
    trace on the CPU: the markers are there, no device ms."""
    import torch

    from absolutetrack_tpu_torch.models.config import ModelConfig
    from absolutetrack_tpu_torch.models.umetrack import UmeTrackModel
    from absolutetrack_tpu_torch.training import synthetic, train
    from portbench.harness.trace import traced

    cfg = ModelConfig.tiny(input_size=(32, 32))
    model = UmeTrackModel(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    opt = train.make_optimizer()
    step, state = train.make_train_step(cfg, opt, branch="both"), train.init_train_state(model, opt)
    batch, hand = synthetic.synthetic_sequence_batch(2, t=2, cfg=cfg), synthetic.synthetic_hand_model_m(2)
    state, _ = step(state, batch, hand)  # untraced, as the cell's set-up and window run
    with traced("cpu") as box:
        for _ in range(2):
            state, _ = step(state, batch, hand)
    rec = dict(trace=box[0], traced_steps=2)
    assert len(profiling.spans()) == 8
    for part in ("forward", "backward", "optimizer"):
        assert len(_spans.recorded(rec, f"train.{part}")) == 2
        assert core.metric_reader(f"{part}_device_ms.train")(rec) is None
