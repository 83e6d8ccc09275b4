"""The yardstick's arithmetic: the trunk's FLOPs written out by hand from
the configuration's layers, and the crop sampler's touched source bytes
on a case counted by hand."""

import pytest
import torch

from portbench.harness import core, counts, scene


def cfg(name="umetrack-f32"):
    return core.load_json(core.BENCH_DIR / "configs" / f"{name}.json")["model"]


def conv(cin, cout, k, px):
    return 2 * cin * cout * k * k * px


def test_backbone_is_0_97_gflop_a_crop():
    # resnet_layers_2352-f32 at 96x96: stem at 96^2, max-pool, stages at 48^2 / 24^2 / 12^2 / 6^2
    stem = conv(1, 32, 3, 96 * 96)
    stage0 = 4 * conv(32, 32, 3, 48 * 48)
    stage1 = conv(32, 64, 3, 576) + conv(64, 64, 3, 576) + conv(32, 64, 1, 576) + 4 * conv(64, 64, 3, 576)
    stage2 = conv(64, 128, 3, 144) + conv(128, 128, 3, 144) + conv(64, 128, 1, 144) + 8 * conv(128, 128, 3, 144)
    stage3 = conv(128, 256, 3, 36) + conv(256, 256, 3, 36) + conv(128, 256, 1, 36) + 2 * conv(256, 256, 3, 36)
    proj = conv(256, 72, 1, 36)
    by_hand = stem + stage0 + stage1 + stage2 + stage3 + proj
    assert by_hand == 969_228_288
    assert counts.backbone_flops(cfg()) == by_hand
    assert counts.backbone_flops(cfg("umetrack-bf16")) == by_hand


def test_step_counts_are_mostly_the_trunk():
    c = cfg()
    sample = counts.sample_flops(c, known=True, unknown=True)
    assert 2 * counts.backbone_flops(c) < sample < 2.05 * counts.backbone_flops(c)
    assert counts.train_step_flops(c, 512, 2) == pytest.approx(3 * (1024 * sample + 512 * counts.skeleton_flops(c)))
    assert counts.eval_frame_flops(c) == 2 * counts.sample_flops(c, known=True)


def test_touched_source_bytes_by_hand():
    images = torch.zeros(2, 4, 6, dtype=torch.float32)
    # slot 0 (view 0): two pixels whose taps share a column, one outside the view
    # slot 1 (view -1, the last): one pixel
    xs = torch.tensor([[0.5, 1.5, 5.2], [2.0, -1.0, -1.0]])
    ys = torch.tensor([[0.5, 0.5, 1.0], [2.5, -1.0, -1.0]])
    idx = torch.tensor([0, -1])
    # view 0: (0,0) (1,0) (0,1) (1,1) and (2,0) (2,1): 6 texels; view 1: 4 texels; 4 bytes each
    assert scene.touched_source_bytes(images, idx, xs, ys, (4, 6)) == (6 + 4) * 4
    assert scene.touched_source_bytes(images.to(torch.uint8), idx, xs, ys, (4, 6)) == 10


def test_k1_bound_is_bytes_at_the_lockstep_chunk():
    n, p = 768, 96 * 96
    assert counts.k1_bytes(n, p, 0) == n * p * 12 + n * 8
    assert counts.k1_bytes(n, p, 0) / counts.HBM_BYTES_PER_S > counts.k1_flops(n, p) / counts.F32_FLOPS_PER_S
