"""Port parity: the crop warp (coordinate planes, plain sampler, K1 wrapper).

The JAX CPU gather (``absolutetrack_tpu/ops/resample.py:36-76``, exact f32)
is the reference sampler. Tolerances:

* coordinate planes: 1e-3 px (f32 chains of ~600 px values);
* plain sampler vs the JAX gather on the same coordinates: 1e-4 on the
  0..255 scale (the same f32 operations in the same order);
* plain sampler vs the Pallas kernels in interpret mode: 1.1 in the f32
  row mode, because those round the row weights to bf16 (as
  ``tests/test_pallas_warp.py`` holds them); the int8 and bf16 row modes
  are held to far less (see their sections below);
* whole ``warp_perspective_crop``: 0.05, since coordinates that differ by
  an f32 ulp (~6e-5 px at 600 px) move a sample by at most 2 * 255 * 6e-5.

K1 itself and its wrapper are tested in ``tests/test_torch_k1.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from absolutetrack_tpu.geometry import camera as jcam
from absolutetrack_tpu.geometry import crop as jcrop
from absolutetrack_tpu.kinematics.hand_model import hand_model_from_dict as jhand
from absolutetrack_tpu.ops import resample as jrs
from absolutetrack_tpu.ops import pallas_warp
from absolutetrack_tpu.ops.pallas_warp import _plan_blocked, _plan_lines, bilinear_sample_mxu
from absolutetrack_tpu.tracker.crop_gen import gen_crop_slots as jgen
from absolutetrack_tpu_torch.geometry import camera as cam
from absolutetrack_tpu_torch.ops import resample as rs
from absolutetrack_tpu_torch.ops import warp_kernel
from absolutetrack_tpu_torch.tracker.crop_gen import gen_crop_slots

jax.config.update("jax_platforms", "cpu")

CROP = (96, 96)


@pytest.fixture(scope="module")
def scene():
    return chip_smoke.build_scene(seed=5, n_frames=1)


@pytest.fixture(scope="module")
def slot_cameras(scene):
    """Source and crop cameras of frame 0's four slots, for both packages."""
    c = scene["cameras"]
    f32 = {k: np.asarray(c[k], np.float32) for k in ("fx", "fy", "cx", "cy", "coeffs", "width", "height")}
    c2w = scene["camera_to_world"][0]
    jc = jcam.Camera(**{k: jnp.asarray(v) for k, v in f32.items()}, T_world_from_eye=jnp.asarray(c2w))
    tc = cam.Camera(**{k: torch.from_numpy(v) for k, v in f32.items()}, T_world_from_eye=torch.from_numpy(c2w))
    pose = [scene[k][0] for k in ("joint_angles", "wrist_transforms", "hand_confidences")]
    angles = scene["camera_angles"]
    js = jgen(jc, jnp.asarray(angles), jhand(scene["hand_model"]), *map(jnp.asarray, pose), CROP)
    from absolutetrack_tpu_torch.kinematics.hand_model import hand_model_from_dict

    ts = gen_crop_slots(tc, torch.from_numpy(angles), hand_model_from_dict(scene["hand_model"]), *map(torch.from_numpy, pose), CROP)
    # one set of slot cameras (the JAX ones) feeds both coordinate chains
    j_crop = jcrop.crop_camera_to_camera(jax.tree.map(lambda x: x.reshape((4,) + x.shape[2:]), js.cameras), CROP)
    idx = np.array(js.view_idx).reshape(-1)
    j_src = jax.tree.map(lambda x: x[idx], jc)
    t_crop = cam.Camera(*(torch.from_numpy(np.array(x)) for x in j_crop))
    t_src = cam.Camera(*(torch.from_numpy(np.array(x)) for x in j_src))
    assert np.array_equal(ts.view_idx.reshape(-1).numpy(), idx)
    return dict(j_src=j_src, j_crop=j_crop, t_src=t_src, t_crop=t_crop, idx=idx)


class TestCoordinatePlanes:
    @pytest.mark.parametrize("kind", [cam.FISHEYE62, cam.PINHOLE])
    def test_planes_match(self, slot_cameras, kind):
        s = slot_cameras
        jx, jy = jrs._crop_source_coords_planar(s["j_src"], s["j_crop"], CROP, kind, True)
        tx, ty = rs._crop_source_coords_planar(s["t_src"], s["t_crop"], CROP, kind, True)
        assert tx.shape == (4, CROP[0] * CROP[1]) and tx.is_contiguous()
        np.testing.assert_allclose(np.asarray(jx), tx.numpy(), atol=1e-3)
        np.testing.assert_allclose(np.asarray(jy), ty.numpy(), atol=1e-3)

    def test_on_axis_pixel_maps_to_principal_point(self, slot_cameras):
        """Crop and source share a pose and the crop's centre pixel lies on
        the source's optical axis (r == 0): the divide by the subnormal
        2**-128 must not be flushed to zero."""
        s = slot_cameras
        eye = torch.eye(4).expand(4, 4, 4)
        src = s["t_src"]._replace(T_world_from_eye=eye)
        crop = s["t_crop"]._replace(
            T_world_from_eye=eye, cx=torch.full((4,), 48.0), cy=torch.full((4,), 48.0)
        )
        x, y = rs._crop_source_coords_planar(src, crop, CROP, cam.FISHEYE62, True)
        assert torch.isfinite(x).all() and torch.isfinite(y).all()
        axis = 48 * CROP[0] + 48
        assert x[:, axis].tolist() == src.cx.tolist()
        assert y[:, axis].tolist() == src.cy.tolist()

    def test_points_behind_the_source_are_minus_one(self, slot_cameras):
        s = slot_cameras
        flip = torch.diag(torch.tensor([1.0, -1.0, -1.0, 1.0]))
        src = s["t_src"]._replace(T_world_from_eye=s["t_crop"].T_world_from_eye @ flip)
        x, y = rs._crop_source_coords_planar(src, s["t_crop"], CROP, cam.FISHEYE62, True)
        assert (x == -1).all() and (y == -1).all()


def _frames(seed, dtype):
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, (4,) + chip_smoke.SRC_HW, dtype=np.uint8)
    return u8, chip_smoke.pad_frames(u8)


class TestPlainSampler:
    @pytest.mark.parametrize("dtype", ["uint8", "float32", "bfloat16"])
    @pytest.mark.parametrize("padded", [False, True])
    def test_matches_jax_gather(self, slot_cameras, dtype, padded):
        s = slot_cameras
        u8, pad = _frames(1, dtype)
        imgs = pad if padded else u8
        valid_hw = chip_smoke.SRC_HW if padded else None
        jx, jy = jrs._crop_source_coords_planar(s["j_src"], s["j_crop"], CROP, cam.FISHEYE62, True)
        x, y = np.array(jx), np.array(jy)
        cases = chip_smoke.border_coords(chip_smoke.SRC_HW)
        x[0, : len(cases)], y[0, : len(cases)] = cases[:, 0], cases[:, 1]
        j_imgs = jnp.asarray(imgs).astype(getattr(jnp, dtype))
        t_imgs = torch.from_numpy(imgs).to(getattr(torch, dtype))
        want = np.asarray(jrs.bilinear_sample(j_imgs, jnp.asarray(s["idx"]), (jnp.asarray(x), jnp.asarray(y)), src_valid_hw=valid_hw))
        got = warp_kernel.bilinear_sample(t_imgs, torch.from_numpy(s["idx"]), (torch.from_numpy(x), torch.from_numpy(y)), valid_hw)
        assert got.dtype == torch.float32 and got.shape == (4, CROP[0] * CROP[1])
        np.testing.assert_allclose(want, got.numpy(), atol=1e-4)
        assert (got[0, [0, 2, 4, 5, 7, 9, 10, 13, 14, 15]] == 0).all()  # outside or marked
        assert (got[0, [1, 3, 6, 8, 11, 12]] != 0).any()  # inside

    def test_padded_equals_unpadded(self, slot_cameras):
        s = slot_cameras
        u8, pad = _frames(2, "uint8")
        jx, jy = jrs._crop_source_coords_planar(s["j_src"], s["j_crop"], CROP, cam.FISHEYE62, True)
        coords = (torch.from_numpy(np.array(jx)), torch.from_numpy(np.array(jy)))
        idx = torch.from_numpy(s["idx"])
        a = warp_kernel.bilinear_sample(torch.from_numpy(u8), idx, coords)
        b = warp_kernel.bilinear_sample(torch.from_numpy(pad), idx, coords, chip_smoke.SRC_HW)
        assert torch.equal(a, b)

    def test_interleaved_coords(self):
        rng = np.random.default_rng(3)
        imgs = torch.from_numpy(rng.uniform(0, 255, (2, 20, 30)).astype(np.float32))
        xy = torch.from_numpy(rng.uniform(-2, 31, (3, 50, 2)).astype(np.float32))
        idx = torch.tensor([1, 0, 1])
        a = warp_kernel.bilinear_sample(imgs, idx, xy)
        b = warp_kernel.bilinear_sample(imgs, idx, (xy[..., 0], xy[..., 1]))
        assert torch.equal(a, b)

    @pytest.mark.parametrize("idx", [[-1, 4, -6, 9], [-4, 3, 0, -2]])
    def test_view_index_out_of_range_follows_jax(self, idx):
        """A negative view index counts from the end once and any index
        outside [0, V) clamps, as JAX's gather does (K1 follows the same rule)."""
        rng = np.random.default_rng(5)
        imgs = rng.uniform(0, 255, (4, 20, 30)).astype(np.float32)
        x = rng.uniform(-2, 31, (4, 50)).astype(np.float32)
        y = rng.uniform(-2, 21, (4, 50)).astype(np.float32)
        want = jrs.bilinear_sample(jnp.asarray(imgs), jnp.asarray(idx, jnp.int32), (jnp.asarray(x), jnp.asarray(y)))
        got = warp_kernel.bilinear_sample(torch.from_numpy(imgs), torch.tensor(idx), (torch.from_numpy(x), torch.from_numpy(y)))
        np.testing.assert_allclose(np.asarray(want), got.numpy(), atol=1e-4)
        assert warp_kernel.view_index(torch.tensor(idx), 4).tolist() == [
            min(max(i + 4 if i < 0 else i, 0), 3) for i in idx
        ]

    def test_matches_pallas_interpret(self, slot_cameras):
        """The main path's call: 4 slots x 96x96 from uint8 views padded to
        512x640 with the true extent 480x636, routed with ``crop_hw``."""
        s = slot_cameras
        _, pad = _frames(4, "uint8")
        jx, jy = jrs._crop_source_coords_planar(s["j_src"], s["j_crop"], CROP, cam.FISHEYE62, True)
        want = np.asarray(
            bilinear_sample_mxu(
                jnp.asarray(pad), jnp.asarray(s["idx"]), (jx, jy), interpret=True,
                crop_hw=(CROP[1], CROP[0]), src_valid_hw=chip_smoke.SRC_HW,
            )
        )
        got = warp_kernel.bilinear_sample(
            torch.from_numpy(pad), torch.from_numpy(s["idx"]),
            (torch.from_numpy(np.array(jx)), torch.from_numpy(np.array(jy))), chip_smoke.SRC_HW,
        )
        np.testing.assert_allclose(want, got.numpy(), atol=1.1)


def _route_coords(route, rng):
    """(x, y) of two 96x96 slots that the Pallas dispatch sends down one
    route (the cases of ``tests/test_pallas_warp.py`` that reach it)."""
    gy, gx = np.mgrid[0:96, 0:96]
    if route == "a_fused":  # one upright, one rotated slot; every pair fits
        x = np.concatenate([300 + gx[None] * 2.4, 80 + gy[None] * 3.0])
        y = np.concatenate([120 + gy[None] * 2.2, 60 + gx[None] * 2.1])
    elif route == "b_narrow":  # row bands alternate: pairs overflow, tiles fit
        x = np.broadcast_to(120 + gx[None] * 2.0, (2, 96, 96))
        y = np.broadcast_to(20.0 + ((gx[None] // 16) % 2) * 440.0, (2, 96, 96))
    elif route == "c_overflow":  # tests/test_pallas_warp.py:183-218: one pass-A pair of
        # slot 0 straddles rows 20 and 460, so its tiles fit only the overflow window
        x = np.broadcast_to(120 + gx[None] * 2.0, (2, 96, 96))
        y = np.broadcast_to(200 + gy[None] * 0.5, (2, 96, 96)).copy()
        y[0, :16, :32] = 20.0
        y[0, :16, 32:64] = 460.0
    elif route == "d_banded":  # narrow row bands, sawtooth columns
        x = np.broadcast_to((gx[None] * 37.3) % 620.0, (2, 96, 96))
        y = np.broadcast_to(100 + gy[None] * 0.4, (2, 96, 96))
    else:  # "e_covering": both axes span the whole view within a tile
        x = rng.uniform(0, 634, (2, 96, 96))
        y = rng.uniform(0, 478, (2, 96, 96))
    x = x + rng.uniform(0, 1, (2, 96, 96))
    y = y + rng.uniform(0, 1, (2, 96, 96))
    return x.reshape(2, -1).astype(np.float32), y.reshape(2, -1).astype(np.float32)


@pytest.mark.parametrize("route", ["a_fused", "b_narrow", "c_overflow", "d_banded", "e_covering"])
def test_plain_sampler_matches_each_pallas_route(route, monkeypatch):
    """The function K1 replaces, on each route of the Pallas dispatch.

    ``c_overflow``: the dispatch sends a call to pass A plus the overflow
    pass only from ``_TWOPASS_MIN_TILES`` (2048) tiles up, the 768-slot
    lockstep chunk; the threshold is lowered here as
    ``tests/test_pallas_warp.py`` lowers it, and the plan must take
    ``twopass``: a few tiles miss pass A's window, within the overflow
    budget, and all fit the overflow window."""
    rng = np.random.default_rng(12)
    imgs = rng.integers(0, 256, (2,) + chip_smoke.SRC_HW, dtype=np.uint8)
    x, y = _route_coords(route, rng)
    idx = np.array([1, 0])
    crop_hw = None if route == "e_covering" else (96, 96)
    h, w = chip_smoke.SRC_HW
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    lines = _plan_lines(xj, yj, h, w, 2, x.shape[1], x.shape[1], crop_hw)
    if crop_hw is not None:
        blocked = _plan_blocked(xj, yj, h, w, 2, x.shape[1], crop_hw)
        assert bool(blocked.fit_a.all()) == (route == "a_fused")
        assert bool(blocked.all_fit) == (route in ("a_fused", "b_narrow", "c_overflow"))
    if route == "c_overflow":
        monkeypatch.setattr(pallas_warp, "_TWOPASS_MIN_TILES", 0)
        n_over = int(np.sum(~np.asarray(blocked.fit_a)))
        budget = min(pallas_warp._OVERFLOW_BUDGET, max(blocked.fit_a.size // 16, 8))
        assert 0 < n_over <= budget
        assert bool(jnp.all(blocked.fit_a | blocked.fit))
    else:
        assert bool(lines.all_fit) == (route != "e_covering")
    want = np.asarray(
        bilinear_sample_mxu(jnp.asarray(imgs), jnp.asarray(idx), (jnp.asarray(x), jnp.asarray(y)), interpret=True, crop_hw=crop_hw)
    )
    got = warp_kernel.bilinear_sample(torch.from_numpy(imgs), torch.from_numpy(idx), (torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(want, got.numpy(), atol=1.1)


class TestWarpPerspectiveCrop:
    def test_matches_jax(self, slot_cameras):
        s = slot_cameras
        _, pad = _frames(6, "uint8")
        want = jrs.warp_perspective_crop(
            jnp.asarray(pad), s["j_src"], jnp.asarray(s["idx"]), s["j_crop"], CROP,
            method="gather", src_valid_hw=chip_smoke.SRC_HW,
        )
        got = rs.warp_perspective_crop(
            torch.from_numpy(pad), s["t_src"], torch.from_numpy(s["idx"]), s["t_crop"], CROP,
            src_valid_hw=chip_smoke.SRC_HW,
        )
        assert got.shape == (4, CROP[1], CROP[0])
        assert float(got.amax()) > 0  # the crops land on the views
        np.testing.assert_allclose(np.asarray(want), got.numpy(), atol=0.05)


# -- the int8 row-weight mode (pallas_warp.py:127-173) ----------------------
#
# Tolerance of the port's int8 rows against the Pallas kernels' in interpret
# mode: <= 1e-3 on >= 99.9% of pixels and <= 2.01 everywhere. Both quantize
# the same row weights to round(127 w) and sum exactly, but Pallas forms a
# weight as 1 - |r - (y - base)| in window coordinates, which can differ
# from the port's wy by one ulp; at a near-tie of 127 w that flips q by one
# step, one row weight off by 1/127 against values <= 255.


def _assert_int8_close(want, got):
    err = np.abs(np.asarray(want) - np.asarray(got))
    assert err.max() <= 2.01
    assert np.mean(err <= 1e-3) >= 0.999


def _pallas_int8(monkeypatch, *args, **kwargs):
    monkeypatch.setattr(pallas_warp, "_INT8_WINDOW", True)
    try:
        return np.asarray(bilinear_sample_mxu(*args, interpret=True, **kwargs))
    finally:
        monkeypatch.setattr(pallas_warp, "_INT8_WINDOW", False)


def _port_int8(imgs, idx, x, y, valid_hw=None):
    prev = warp_kernel.set_int8_window(True)
    try:
        return warp_kernel.bilinear_sample(torch.from_numpy(imgs), torch.from_numpy(idx), (torch.from_numpy(x), torch.from_numpy(y)), valid_hw).numpy()
    finally:
        warp_kernel.set_int8_window(prev)


def test_int8_rows_match_the_pallas_int8_case(monkeypatch):
    """``tests/test_pallas_warp.py::test_int8_window_variant``'s case, with
    ``crop_hw`` (pass A) and without it (covering)."""
    rng = np.random.default_rng(33)
    imgs = rng.integers(0, 256, (2, 480, 636), dtype=np.uint8)
    idx = np.array([1, 0], np.int32)
    gy, gx = np.mgrid[0:96, 0:96]
    y = (120 + gy[None] * 2.2 + rng.uniform(0, 1, (2, 96, 96))).reshape(2, -1).astype(np.float32)
    x = (300 + gx[None] * 2.4 + rng.uniform(0, 1, (2, 96, 96))).reshape(2, -1).astype(np.float32)
    got = _port_int8(imgs, idx.astype(np.int64), x, y)
    f32 = warp_kernel.bilinear_sample(torch.from_numpy(imgs), torch.from_numpy(idx.astype(np.int64)), (torch.from_numpy(x), torch.from_numpy(y))).numpy()
    for crop_hw in ((96, 96), None):
        want = _pallas_int8(monkeypatch, jnp.asarray(imgs), jnp.asarray(idx), (jnp.asarray(x), jnp.asarray(y)), crop_hw=crop_hw)
        _assert_int8_close(want, got)
    # the int8 rows were taken: they differ from the f32 rows, within the quantization
    assert np.abs(got - f32).max() > 0.1
    np.testing.assert_allclose(got, f32, atol=2.01)


@pytest.mark.parametrize("route", ["a_fused", "b_narrow", "c_overflow", "d_banded", "e_covering"])
def test_int8_rows_match_each_pallas_route(route, monkeypatch):
    """The int8 rows on each route of the Pallas dispatch (the coordinates
    of ``test_plain_sampler_matches_each_pallas_route``, which asserts the
    routes)."""
    rng = np.random.default_rng(12)
    imgs = rng.integers(0, 256, (2,) + chip_smoke.SRC_HW, dtype=np.uint8)
    x, y = _route_coords(route, rng)
    idx = np.array([1, 0])
    if route == "c_overflow":
        monkeypatch.setattr(pallas_warp, "_TWOPASS_MIN_TILES", 0)
    crop_hw = None if route == "e_covering" else (96, 96)
    want = _pallas_int8(monkeypatch, jnp.asarray(imgs), jnp.asarray(idx), (jnp.asarray(x), jnp.asarray(y)), crop_hw=crop_hw)
    _assert_int8_close(want, _port_int8(imgs, idx, x, y))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_switch_leaves_f32_and_bf16_sources_alone(dtype):
    """Only uint8 sources take the int8 rows (``tests/test_pallas_warp.py:142-153``);
    ``set_int8_window`` returns the value it replaces."""
    rng = np.random.default_rng(4)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 40, 50), dtype=np.uint8))
    x = torch.from_numpy(rng.uniform(-2, 51, (2, 300)).astype(np.float32))
    y = torch.from_numpy(rng.uniform(-2, 41, (2, 300)).astype(np.float32))
    idx = torch.tensor([1, 0])
    off = warp_kernel.bilinear_sample(imgs.to(dtype), idx, (x, y))
    u8_off = warp_kernel.bilinear_sample(imgs, idx, (x, y))
    assert warp_kernel.set_int8_window(True) is False
    try:
        assert warp_kernel.set_int8_window(True) is True
        on = warp_kernel.bilinear_sample(imgs.to(dtype), idx, (x, y))
        u8_on = warp_kernel.bilinear_sample(imgs, idx, (x, y))
    finally:
        assert warp_kernel.set_int8_window(False) is True
    assert warp_kernel.set_int8_window(False) is False
    assert torch.equal(on, off)
    assert not torch.equal(u8_on, u8_off)
    with pytest.raises(ValueError, match="uint8"):
        warp_kernel.bilinear_sample_plain(imgs.to(dtype), idx, (x, y), row_mode=warp_kernel.ROWS_INT8)


# -- the bf16 row-weight mode (pallas_warp.py:174-186) ----------------------
#
# Tolerance of the port's bf16 rows against the Pallas kernels in interpret
# mode: <= 1e-3 on >= 99.9% of pixels and <= 1e-2 everywhere (0..255 scale).
# Both round the same hat weights and taps to bf16 and sum each row's two
# exact products in f32; the banded and covering kernels add a pixel's two
# rows or columns in another order, one f32 rounding apart. Measured: 0.0 on
# routes a-c and on the first-row case, 1.53e-5 on d and e.


def _assert_bf16_close(want, got):
    err = np.abs(np.asarray(want) - np.asarray(got))
    assert err.max() <= 1e-2, err.max()
    assert np.mean(err <= 1e-3) >= 0.999


def _port_bf16(imgs, idx, x, y, valid_hw=None):
    prev = warp_kernel.set_bf16_rows(True)
    try:
        return warp_kernel.bilinear_sample(
            torch.from_numpy(imgs), torch.from_numpy(idx), (torch.from_numpy(x), torch.from_numpy(y)), valid_hw
        ).numpy()
    finally:
        warp_kernel.set_bf16_rows(prev)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("route", ["a_fused", "b_narrow", "c_overflow", "d_banded", "e_covering"])
def test_bf16_rows_match_each_pallas_route(route, dtype, monkeypatch):
    """The Pallas kernels' default numerics on each route of the dispatch
    (the coordinates of ``test_plain_sampler_matches_each_pallas_route``,
    which asserts the routes): uint8 views, and f32 views that Pallas rounds
    to bf16 (``pallas_warp.py:614-615``)."""
    rng = np.random.default_rng(12)
    imgs = rng.integers(0, 256, (2,) + chip_smoke.SRC_HW, dtype=np.uint8)
    x, y = _route_coords(route, rng)
    if dtype == "float32":
        imgs = (imgs + rng.uniform(0, 1, imgs.shape)).astype(np.float32)
    idx = np.array([1, 0])
    if route == "c_overflow":
        monkeypatch.setattr(pallas_warp, "_TWOPASS_MIN_TILES", 0)
    crop_hw = None if route == "e_covering" else (96, 96)
    want = np.asarray(
        bilinear_sample_mxu(jnp.asarray(imgs), jnp.asarray(idx), (jnp.asarray(x), jnp.asarray(y)), interpret=True, crop_hw=crop_hw)
    )
    got = _port_bf16(imgs, idx, x, y)
    _assert_bf16_close(want, got)
    # the bf16 rows were taken: the f32 rows differ by the weights' rounding
    f32 = warp_kernel.bilinear_sample(torch.from_numpy(imgs), torch.from_numpy(idx), (torch.from_numpy(x), torch.from_numpy(y))).numpy()
    assert np.abs(f32 - want).max() > 0.1


def test_bf16_rows_match_pallas_on_the_first_row_and_column():
    """Coordinates in [0, 1), where ``1 - w`` rounds: Pallas weights the
    second tap by ``1 - |1 - w|`` (not ``w``), and so does the port; with
    ``w`` the error here would reach 0.097. Also the main path's call
    (uint8 views padded to 512x640, the true extent passed)."""
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (2,) + chip_smoke.SRC_HW, dtype=np.uint8)
    gy, gx = np.mgrid[0:96, 0:96]
    x = np.concatenate([gx[None] * 0.0101 + rng.uniform(0, 1e-4, (1, 96, 96)), 300 + gx[None] * 2.4])
    y = np.concatenate([gy[None] * 0.0101 + rng.uniform(0, 1e-4, (1, 96, 96)), 120 + gy[None] * 2.2])
    x, y = x.reshape(2, -1).astype(np.float32), y.reshape(2, -1).astype(np.float32)
    idx = np.array([1, 0])
    for crop_hw in ((96, 96), None):
        want = bilinear_sample_mxu(jnp.asarray(imgs), jnp.asarray(idx), (jnp.asarray(x), jnp.asarray(y)), interpret=True, crop_hw=crop_hw)
        np.testing.assert_array_equal(np.asarray(want), _port_bf16(imgs, idx, x, y))
    pad = chip_smoke.pad_frames(imgs)
    want = bilinear_sample_mxu(
        jnp.asarray(pad), jnp.asarray(idx), (jnp.asarray(x), jnp.asarray(y)), interpret=True,
        crop_hw=(96, 96), src_valid_hw=chip_smoke.SRC_HW,
    )
    _assert_bf16_close(want, _port_bf16(pad, idx, x, y, chip_smoke.SRC_HW))


def test_bf16_switch_returns_the_previous_value_and_int8_wins_on_uint8():
    """``set_bf16_rows`` returns the value it replaces; with both switches
    on, uint8 sources take the int8 rows and f32 and bf16 sources the bf16
    rows, as ``_tile_contrib`` picks its format."""
    rng = np.random.default_rng(6)
    u8 = torch.from_numpy(rng.integers(0, 256, (2, 40, 50), dtype=np.uint8))
    x = torch.from_numpy(rng.uniform(-2, 51, (2, 300)).astype(np.float32))
    y = torch.from_numpy(rng.uniform(-2, 41, (2, 300)).astype(np.float32))
    idx = torch.tensor([1, 0])
    plain = warp_kernel.bilinear_sample_plain
    assert warp_kernel.set_bf16_rows(True) is False
    try:
        assert warp_kernel.set_bf16_rows(True) is True
        assert warp_kernel.row_mode_for(u8) == warp_kernel.ROWS_BF16
        bf16_u8 = warp_kernel.bilinear_sample(u8, idx, (x, y))
        assert torch.equal(bf16_u8, plain(u8, idx, (x, y), row_mode=warp_kernel.ROWS_BF16))
        prev = warp_kernel.set_int8_window(True)
        try:
            for src in (u8, u8.float(), u8.to(torch.bfloat16)):
                mode = warp_kernel.ROWS_INT8 if src.dtype == torch.uint8 else warp_kernel.ROWS_BF16
                assert warp_kernel.row_mode_for(src) == mode
                assert torch.equal(warp_kernel.bilinear_sample(src, idx, (x, y)), plain(src, idx, (x, y), row_mode=mode))
        finally:
            warp_kernel.set_int8_window(prev)
    finally:
        assert warp_kernel.set_bf16_rows(False) is True
    assert warp_kernel.set_bf16_rows(False) is False
    assert warp_kernel.row_mode_for(u8) == warp_kernel.ROWS_F32
    assert not torch.equal(bf16_u8, warp_kernel.bilinear_sample(u8, idx, (x, y)))
    with pytest.raises(ValueError, match="row-weight mode"):
        plain(u8, idx, (x, y), row_mode=3)
