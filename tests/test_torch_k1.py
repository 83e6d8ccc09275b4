"""Kernel K1 (``absolutetrack_tpu_torch/csrc/bilinear_sample.cu``) and its wrapper.

This file imports no JAX, so its ``cuda`` test also runs on a machine with
the card but without JAX (skip the JAX conftest there):

    python -m pytest tests/test_torch_k1.py --noconftest -q

On the CPU the ``cuda`` test skips; the rest checks the build command, the
dispatch on the tensors' device and the wrapper's input checks. K1 must
match the plain version within ``chip_smoke.K1_TOL`` (1e-3 on the 0..255
scale): both round the same f32 operations in the same order.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from absolutetrack_tpu_torch.ops import warp_kernel


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    return torch.device("cuda")


def test_build_command_targets_sm90a_without_fast_math():
    cmd = warp_kernel.nvcc_command(warp_kernel.SOURCE, Path("/nonexistent/lib.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd and "-O3" in cmd
    assert not any("fast-math" in a or "fast_math" in a or "ftz" in a for a in cmd)
    assert "-shared" in cmd and Path(cmd[-1]) == warp_kernel.SOURCE


def test_source_names_the_replaced_tpu_kernels():
    text = warp_kernel.SOURCE.read_text()
    assert 'extern "C" int k1_bilinear_sample(' in text
    for replaced in (
        "_fused_warp_kernel", "_narrow_warp_kernel", "_overflow_warp_kernel",
        "_banded_warp_kernel", "_covering_warp_kernel",
    ):
        assert replaced in text


def test_cpu_tensors_take_the_plain_version():
    before = warp_kernel.K1.launches
    imgs = torch.arange(16, dtype=torch.uint8).reshape(1, 4, 4)
    x = torch.tensor([[0.5, -1.0, 2.5]])
    y = torch.tensor([[0.0, -1.0, 2.5]])
    out = warp_kernel.bilinear_sample(imgs, torch.zeros(1, dtype=torch.int64), (x, y))
    assert out.tolist() == [[0.5, 0.0, 12.5]]
    assert warp_kernel.K1.launches == before


def test_k1_refuses_cpu_tensors():
    before = warp_kernel.K1.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        warp_kernel.K1(
            torch.zeros((1, 4, 4), dtype=torch.uint8), torch.zeros(1, dtype=torch.int64),
            torch.ones(1, 3), torch.ones(1, 3),
        )
    assert warp_kernel.K1.launches == before


def test_reset_counts_clears_launches_and_shapes():
    k = warp_kernel.K1Kernel()
    k.launches = 2
    k.shapes[(768, 9216)] = 2
    k.reset_counts()
    assert k.launches == 0 and not k.shapes


def test_other_devices_raise():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no bilinear_sample for device"):
        warp_kernel.bilinear_sample(
            torch.zeros((1, 4, 4), dtype=torch.uint8, **meta),
            torch.zeros(1, dtype=torch.int64, **meta),
            (torch.ones(1, 3, **meta), torch.ones(1, 3, **meta)),
        )


@pytest.mark.parametrize(
    "change, match",
    [
        (dict(images=torch.zeros((1, 8, 8), dtype=torch.int32)), "dtype"),
        (dict(images=torch.zeros((8, 8), dtype=torch.uint8)), r"\(V, H, W\)"),
        (dict(images=torch.zeros((1, 8, 16), dtype=torch.uint8)[:, :, ::2]), r"\(V, H, W\)"),
        (dict(x=torch.zeros((2, 6), dtype=torch.float64), y=torch.zeros((2, 6), dtype=torch.float64)), "float32"),
        (dict(x=torch.zeros((2, 12))[:, ::2]), "contiguous"),
        (dict(y=torch.zeros((2, 5))), "planes"),
        (dict(image_idx=torch.zeros(2, dtype=torch.int32)), "int64"),
        (dict(image_idx=torch.zeros(3, dtype=torch.int64)), "int64"),
        (dict(src_valid_hw=(9, 8)), "outside"),
    ],
)
def test_inputs_are_checked(change, match):
    args = dict(
        images=torch.zeros((1, 8, 8), dtype=torch.uint8),
        image_idx=torch.zeros(2, dtype=torch.int64),
        x=torch.zeros((2, 6)), y=torch.zeros((2, 6)), src_valid_hw=None,
    )
    args.update(change)
    with pytest.raises(ValueError, match=match):
        warp_kernel._check_cuda_inputs(**args)


def test_bound_counts_each_touched_source_byte_once():
    """``chip_smoke``'s byte bound reads, of the views, only the bytes that
    the taps of in-bounds pixels touch: shared taps once, padding never."""
    imgs = torch.zeros((2, 8, 10), dtype=torch.float32)  # valid extent 6x9 inside
    x = torch.tensor([1.5, 1.7, 2.5, -1.0, 8.5]).repeat(2, 1)
    y = torch.tensor([1.5, 1.2, 1.5, -1.0, 1.0]).repeat(2, 1)
    # per view: corners (1, 1) twice and (1, 2): 6 distinct taps; -1 and x=8.5 are outside
    idx = torch.tensor([0, -1])
    assert chip_smoke.touched_source_bytes(imgs, idx, x, y, (6, 9)) == 2 * 6 * 4
    assert chip_smoke.touched_source_bytes(imgs.to(torch.uint8), torch.tensor([1, -1]), x, y, (6, 9)) == 6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("padded", [False, True])
def test_k1_matches_plain_on_the_card(cuda_device, dtype, padded):
    rng = np.random.default_rng(7)
    hw = chip_smoke.PAD_HW if padded else chip_smoke.SRC_HW
    imgs = torch.from_numpy(rng.integers(0, 256, (4,) + hw, dtype=np.uint8)).to(dtype)
    valid_hw = chip_smoke.SRC_HW if padded else None
    x = rng.uniform(-3, hw[1] + 2, (4, 9216)).astype(np.float32)
    y = rng.uniform(-3, hw[0] + 2, (4, 9216)).astype(np.float32)
    cases = chip_smoke.border_coords(chip_smoke.SRC_HW)
    x[0, : len(cases)], y[0, : len(cases)] = cases[:, 0], cases[:, 1]
    coords = (torch.from_numpy(x), torch.from_numpy(y))
    # in range, then out of range (a negative index counts from the end once, then clamps)
    for idx in (torch.tensor([2, 0, 3, 1]), torch.tensor([-1, 4, -6, 9])):
        want = warp_kernel.bilinear_sample(imgs, idx, coords, valid_hw)
        before, before_shape = warp_kernel.K1.launches, warp_kernel.K1.shapes[(4, 9216)]
        got = warp_kernel.bilinear_sample(
            imgs.to(cuda_device), idx.to(cuda_device), tuple(c.to(cuda_device) for c in coords), valid_hw
        )
        torch.cuda.synchronize()
        assert warp_kernel.K1.launches == before + 1
        assert warp_kernel.K1.shapes[(4, 9216)] == before_shape + 1
        assert float((got.cpu() - want).abs().max()) <= chip_smoke.K1_TOL
