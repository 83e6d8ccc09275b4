"""Kernel K1 (``absolutetrack_tpu_torch/csrc/bilinear_sample.cu``) and its wrapper.

This file imports no JAX, so its ``cuda`` test also runs on a machine with
the card but without JAX (skip the JAX conftest there):

    python -m pytest tests/test_torch_k1.py --noconftest -q

On the CPU the ``cuda`` tests skip; the rest checks the build command,
the C signature, the arguments the wrapper passes (row-weight mode, the
crop row width that sets K1's layout), the dispatch on the tensors' device
and the wrapper's input checks. K1 must match the plain version within
``chip_smoke.K1_TOL`` (1e-3 on the 0..255 scale) in every row-weight mode
(f32, int8, bf16): both round the same operations in the same order.
"""

import ctypes
import re
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
        "_banded_warp_kernel", "_covering_warp_kernel", "_tile_contrib's int8 row mix",
        "_tile_contrib's bf16 row mix",
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


def test_argtypes_follow_the_c_signature():
    """``ARGTYPES`` has one entry per parameter of ``k1_bilinear_sample``, of
    the matching width: a pointer or the stream as c_void_p, int as c_int,
    int64_t as c_int64."""
    decl = re.search(r'extern "C" int k1_bilinear_sample\((.*?)\)\s*\{', warp_kernel.SOURCE.read_text(), re.S)
    params = [" ".join(p.split()) for p in decl.group(1).split(",")]
    kinds = [
        ctypes.c_void_p if "*" in p else ctypes.c_int64 if p.startswith("int64_t") else ctypes.c_int
        for p in params
    ]
    assert [p.split()[-1].lstrip("*") for p in params][:4] == ["src", "src_dtype", "row_mode", "row_px"]
    assert kinds == warp_kernel.ARGTYPES


@pytest.mark.parametrize("shape, row_px", [((3, 96, 96), 96), ((3, 95, 97), 97), ((3, 9216), 8), ((3, 97), 8)])
@pytest.mark.parametrize(
    "dtype, row_mode",
    [
        (torch.uint8, warp_kernel.ROWS_F32), (torch.uint8, warp_kernel.ROWS_INT8),
        (torch.bfloat16, warp_kernel.ROWS_F32), (torch.uint8, warp_kernel.ROWS_BF16),
        (torch.float32, warp_kernel.ROWS_BF16), (torch.bfloat16, warp_kernel.ROWS_BF16),
    ],
)
def test_k1_arguments(shape, row_px, dtype, row_mode):
    """The call the wrapper makes: dtype code, row-weight mode code (0 f32,
    1 int8, 2 bf16), the crop row width (W of (N, H, W) planes, 8 for flat
    planes), strides and the (N, P) of the planes; planes off a 16-byte
    boundary are taken as they are."""
    images = torch.zeros((5, 12, 20), dtype=dtype)
    x = chip_smoke.at_offset(torch.zeros(shape), 4)
    y, out = torch.zeros(shape), torch.empty(shape)
    idx = torch.zeros(3, dtype=torch.int64)
    warp_kernel._check_cuda_inputs(images, idx, x, y, (10, 18), row_mode)
    args = warp_kernel.k1_arguments(images, idx, x, y, out, (10, 18), row_mode, 1234)
    assert len(args) == len(warp_kernel.ARGTYPES)
    codes = {torch.uint8: 0, torch.float32: 1, torch.bfloat16: 2}
    assert args[:4] == (images.data_ptr(), codes[dtype], row_mode, row_px)
    assert args[4:8] == (idx.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr())
    assert args[8:] == (5, 12 * 20, 20, 10, 18, 3, x[0].numel(), 1234)
    assert warp_kernel.row_px(x) == row_px


def test_int8_rows_need_uint8_images():
    args = dict(image_idx=torch.zeros(2, dtype=torch.int64), x=torch.zeros((2, 6)), y=torch.zeros((2, 6)), src_valid_hw=None)
    warp_kernel._check_cuda_inputs(torch.zeros((1, 8, 8), dtype=torch.uint8), row_mode=warp_kernel.ROWS_INT8, **args)
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="int8 rows need uint8"):
            warp_kernel._check_cuda_inputs(torch.zeros((1, 8, 8), dtype=dtype), row_mode=warp_kernel.ROWS_INT8, **args)
        warp_kernel._check_cuda_inputs(torch.zeros((1, 8, 8), dtype=dtype), row_mode=warp_kernel.ROWS_BF16, **args)
    with pytest.raises(ValueError, match="row-weight mode"):
        warp_kernel._check_cuda_inputs(torch.zeros((1, 8, 8), dtype=torch.uint8), row_mode=3, **args)


def test_source_rejects_unknown_row_modes():
    """The C function validates the row-weight mode before it launches:
    an unknown code returns 1003, int8 rows on a source not uint8 1001."""
    text = warp_kernel.SOURCE.read_text()
    assert "if (row_mode < kRowsF32 || row_mode > kRowsBf16) return 1003;" in text
    assert "if (row_mode == kRowsInt8 && src_dtype != 0) return 1001;" in text
    assert (warp_kernel.ROWS_F32, warp_kernel.ROWS_INT8, warp_kernel.ROWS_BF16) == (0, 1, 2)
    assert "constexpr int kRowsF32 = 0, kRowsInt8 = 1, kRowsBf16 = 2;" in text


def test_reset_counts_clears_launches_and_shapes():
    k = warp_kernel.K1Kernel()
    k.launches = 2
    k.shapes[(768, 9216)] = 2
    k.modes["bf16"] = 2
    k.reset_counts()
    assert k.launches == 0 and not k.shapes and not k.modes


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
        (dict(x=torch.zeros((2, 1, 2, 3)), y=torch.zeros((2, 1, 2, 3))), "planes"),
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


def _card_modes(dtype):
    """The row-weight modes of a source type: int8 rows for uint8 only."""
    modes = (warp_kernel.ROWS_F32, warp_kernel.ROWS_BF16)
    return modes + (warp_kernel.ROWS_INT8,) if dtype == torch.uint8 else modes


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("padded", [False, True])
def test_k1_matches_plain_on_the_card(cuda_device, dtype, padded):
    """Through ``bilinear_sample``, flat and crop-shaped planes, in every
    row-weight mode of the source type (the int8 switch leaves f32 and bf16
    alone; with both switches on, int8 wins on uint8)."""
    rng = np.random.default_rng(7)
    hw = chip_smoke.PAD_HW if padded else chip_smoke.SRC_HW
    imgs = torch.from_numpy(rng.integers(0, 256, (4,) + hw, dtype=np.uint8)).to(dtype)
    valid_hw = chip_smoke.SRC_HW if padded else None
    x = rng.uniform(-3, hw[1] + 2, (4, 9216)).astype(np.float32)
    y = rng.uniform(-3, hw[0] + 2, (4, 9216)).astype(np.float32)
    cases = chip_smoke.border_coords(chip_smoke.SRC_HW)
    x[0, : len(cases)], y[0, : len(cases)] = cases[:, 0], cases[:, 1]
    for shape in ((4, 9216), (4, 96, 96)):
        coords = (torch.from_numpy(x).view(shape), torch.from_numpy(y).view(shape))
        # in range, then out of range (a negative index counts from the end once, then clamps)
        for idx in (torch.tensor([2, 0, 3, 1]), torch.tensor([-1, 4, -6, 9])):
            for int8, bf16 in ((False, False), (True, False), (False, True), (True, True)):
                prev = warp_kernel.set_int8_window(int8), warp_kernel.set_bf16_rows(bf16)
                try:
                    mode = warp_kernel.ROW_MODE_NAMES[warp_kernel.row_mode_for(imgs)]
                    want = warp_kernel.bilinear_sample(imgs, idx, coords, valid_hw)
                    before, before_shape = warp_kernel.K1.launches, warp_kernel.K1.shapes[(4, 9216)]
                    before_mode = warp_kernel.K1.modes[mode]
                    got = warp_kernel.bilinear_sample(
                        imgs.to(cuda_device), idx.to(cuda_device), tuple(c.to(cuda_device) for c in coords), valid_hw
                    )
                finally:
                    warp_kernel.set_int8_window(prev[0])
                    warp_kernel.set_bf16_rows(prev[1])
                torch.cuda.synchronize()
                assert warp_kernel.K1.launches == before + 1
                assert warp_kernel.K1.shapes[(4, 9216)] == before_shape + 1
                assert warp_kernel.K1.modes[mode] == before_mode + 1
                assert got.shape == shape
                assert float((got.cpu() - want).abs().max()) <= chip_smoke.K1_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["flat_p9215", "flat_p97", "rows_95x97", "planes_offset", "n1", "n70000_p8"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32, torch.bfloat16])
def test_k1_edge_cases_on_the_card(cuda_device, case, dtype):
    """P not a multiple of 4 or 8, crop rows not a multiple of the 8-pixel
    patch, planes 4 bytes past a 16-byte boundary, one slot, and 70,000
    slots (past the grid's 65,535 in y), against the plain version on the card."""
    rng = np.random.default_rng(11)
    imgs = torch.from_numpy(rng.integers(0, 256, (4,) + chip_smoke.PAD_HW, dtype=np.uint8)).to(cuda_device, dtype)
    x = torch.from_numpy(rng.uniform(-3, 642, (96, 96, 96)).astype(np.float32)).to(cuda_device)
    y = torch.from_numpy(rng.uniform(-3, 514, (96, 96, 96)).astype(np.float32)).to(cuda_device)
    idx = torch.from_numpy(rng.integers(-5, 9, 96)).to(cuda_device)
    xs, ys, ii = chip_smoke.k1_edge_cases(x, y, idx)[case]
    for mode in _card_modes(dtype):
        assert chip_smoke.k1_error(imgs, ii, xs, ys, chip_smoke.SRC_HW, mode) <= chip_smoke.K1_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32, torch.bfloat16])
def test_k1_bf16_rows_match_plain_on_the_card(cuda_device, dtype):
    """K1's bf16 rows against the plain bf16 rows on the card, f32 sources
    with fractional values (rounded to bf16 in both), coordinates in the
    first row and column (the ``1 - |1 - w|`` weights) and the border probes."""
    rng = np.random.default_rng(13)
    imgs = rng.integers(0, 256, (4,) + chip_smoke.PAD_HW, dtype=np.uint8) + rng.uniform(0, 1, (4,) + chip_smoke.PAD_HW)
    imgs = torch.from_numpy(imgs.astype(np.float32)).to(cuda_device, dtype)
    gy, gx = np.mgrid[0:96, 0:96]
    x = np.stack([gx * 0.0101, 300 + gx * 2.4, rng.uniform(-3, 642, (96, 96)), 100 + gy * 2.0])
    y = np.stack([gy * 0.0101, 120 + gy * 2.2, rng.uniform(-3, 514, (96, 96)), 50 + gx * 2.0])
    x = torch.from_numpy((x + rng.uniform(0, 1e-4, x.shape)).astype(np.float32)).to(cuda_device)
    y = torch.from_numpy((y + rng.uniform(0, 1e-4, y.shape)).astype(np.float32)).to(cuda_device)
    xs, ys = chip_smoke._probed(x, y, chip_smoke.SRC_HW)
    idx = torch.tensor([0, 1, 2, 3], device=cuda_device)
    before = warp_kernel.K1.modes["bf16"]
    assert chip_smoke.k1_error(imgs, idx, xs, ys, chip_smoke.SRC_HW, warp_kernel.ROWS_BF16) <= chip_smoke.K1_TOL
    assert warp_kernel.K1.modes["bf16"] == before + 1


@pytest.mark.cuda
def test_k1_matches_plain_at_the_rendered_training_shape(cuda_device):
    """The rendered training chunk (``training/rendered.py``): N = 128 crops
    of 96x96 from unpadded uint8 frames of 480x636 (16 windows x 2 frames x
    4 views), in every row-weight mode of uint8 views, one launch each."""
    rng = np.random.default_rng(17)
    h, w = chip_smoke.SRC_HW
    imgs = torch.from_numpy(rng.integers(0, 256, (128, h, w), dtype=np.uint8)).to(cuda_device)
    x = torch.from_numpy(rng.uniform(-3, w + 2, (128, 96, 96)).astype(np.float32)).to(cuda_device)
    y = torch.from_numpy(rng.uniform(-3, h + 2, (128, 96, 96)).astype(np.float32)).to(cuda_device)
    idx = torch.from_numpy(rng.integers(0, 128, 128)).to(cuda_device)
    for mode in _card_modes(torch.uint8):
        before = warp_kernel.K1.shapes[(128, 96 * 96)]
        assert chip_smoke.k1_error(imgs, idx, x, y, None, mode) <= chip_smoke.K1_TOL
        assert warp_kernel.K1.shapes[(128, 96 * 96)] == before + 1
