"""Port parity: the Gauss-Newton solvers (``ops/gauss_newton.py``) and the
unknown-skeleton CLI's windowed Gauss-Newton calibration (``--calib-mode gn``).

The hand model is the hermetic ``chip_smoke.synthetic_hand_model()``.
Poses, targets and initial values are drawn from seeded numpy generators
and go to both packages as the same float32 arrays. The four properties of
``tests/test_gauss_newton.py`` (which reads a hand model from outside the
repository) are held here on the synthetic hand, in the port.

Tolerances against JAX: log-scale 1e-5, mean residual 1e-5 mm, joint
angles 1e-4 rad, wrist matrices 1e-4 (rotation entries and mm); the CLI's
calibrated scales 1e-5 relative and its pickles as
``tests/test_torch_protocol.py``.
"""

from collections import Counter
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from absolutetrack_tpu.apps import run_eval_unknown_skeleton as junknown
from absolutetrack_tpu.kinematics import hand_model as jhm
from absolutetrack_tpu.ops import gauss_newton as jgn
from absolutetrack_tpu_torch.apps import calibration
from absolutetrack_tpu_torch.apps import run_eval_unknown_skeleton as unknown
from absolutetrack_tpu_torch.kinematics import hand_model as hm
from absolutetrack_tpu_torch.kinematics.skinning import skin_landmarks
from absolutetrack_tpu_torch.ops import gauss_newton as gn
from test_torch_protocol import assert_same_lines, assert_same_results, make_tree, run_both

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(scope="module")
def hands():
    d = chip_smoke.synthetic_hand_model()
    return jhm.hand_model_from_dict(d), hm.hand_model_from_dict(d)


def _poses(rng, t):
    angles = rng.uniform(-0.4, 0.6, (t, 22)).astype(np.float32)
    wr = np.broadcast_to(np.eye(4, dtype=np.float32), (t, 4, 4)).copy()
    wr[:, :3, 3] = rng.uniform(-30, 30, (t, 3))
    return angles, wr


def _batched(hand, b):
    return hand.map(lambda x: x.expand((b,) + x.shape))


def _targets(hand, angles, wr, scale=1.0):
    t = angles.shape[0]
    h = _batched(hm.scaled_hand_model(hand, scale), t)
    return skin_landmarks(h, torch.from_numpy(angles), torch.from_numpy(wr)).numpy()


def _assert_fit_close(j, t):
    np.testing.assert_allclose(t.joint_angles.numpy(), np.asarray(j.joint_angles), atol=1e-4)
    np.testing.assert_allclose(t.wrist.numpy(), np.asarray(j.wrist), atol=1e-4)
    np.testing.assert_allclose(t.residual.numpy(), np.asarray(j.residual), atol=1e-5)


def test_apply_delta_matches_jax():
    rng = np.random.default_rng(0)
    angles, wr = _poses(rng, 5)
    delta = rng.normal(0, 0.3, (5, gn.N_POSE)).astype(np.float32)
    delta[0, 20:23] = 0.0  # the small-angle branch
    ja, jw = jgn._apply_delta(jnp.asarray(angles), jnp.asarray(wr), jnp.asarray(delta))
    ta, tw = gn._apply_delta(torch.from_numpy(angles), torch.from_numpy(wr), torch.from_numpy(delta))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_fit_pose_matches_jax(hands, weighted):
    jh, th = hands
    rng = np.random.default_rng(1)
    b = 3
    angles, wr = _poses(rng, b)
    target = _targets(th, angles, wr)
    init_a = (angles + rng.uniform(-0.15, 0.15, (b, 22))).astype(np.float32)
    init_w = wr.copy()
    init_w[:, :3, 3] += rng.uniform(-8, 8, (b, 3))
    w = rng.uniform(0.5, 2.0, (b, 21)).astype(np.float32) if weighted else None
    j = jgn.fit_pose(
        jax.tree.map(lambda x: jnp.broadcast_to(x, (b,) + x.shape), jh), jnp.asarray(target), jnp.asarray(init_a),
        jnp.asarray(init_w), iters=6, weights=None if w is None else jnp.asarray(w),
    )
    t = gn.fit_pose(
        _batched(th, b), torch.from_numpy(target), torch.from_numpy(init_a), torch.from_numpy(init_w), iters=6,
        weights=None if w is None else torch.from_numpy(w),
    )
    _assert_fit_close(j, t)
    assert t.log_scale is None and float(t.residual.max()) < 0.5


@pytest.mark.parametrize("masked", [False, True])
def test_calibrate_scale_window_matches_jax(hands, masked):
    jh, th = hands
    rng = np.random.default_rng(2)
    t_len = 6
    angles, wr = _poses(rng, t_len)
    target = _targets(th, angles, wr, 1.13)
    init_a = (angles + rng.uniform(-0.1, 0.1, (t_len, 22))).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0, 1], np.float32) if masked else None
    if masked:
        target[mask == 0] += 50.0  # what the mask hides must not count
    j = jgn.calibrate_scale_window(
        jh, jnp.asarray(target), jnp.asarray(init_a), jnp.asarray(wr),
        frame_mask=None if mask is None else jnp.asarray(mask), iters=6,
    )
    t = gn.calibrate_scale_window(
        th, torch.from_numpy(target), torch.from_numpy(init_a), torch.from_numpy(wr),
        frame_mask=None if mask is None else torch.from_numpy(mask), iters=6,
    )
    np.testing.assert_allclose(float(t.log_scale), float(j.log_scale), atol=1e-5)
    _assert_fit_close(j, t)
    np.testing.assert_allclose(float(np.exp(t.log_scale.numpy())), 1.13, rtol=5e-3)


def _windows(th, rng, n_w, t_len):
    angles = rng.uniform(-0.4, 0.6, (n_w, t_len, 22)).astype(np.float32)
    wr = np.broadcast_to(np.eye(4, dtype=np.float32), (n_w, t_len, 4, 4)).copy()
    wr[..., :3, 3] = rng.uniform(-30, 30, (n_w, t_len, 3))
    scale = rng.uniform(0.85, 1.15, (n_w, 1)).repeat(t_len, 1).astype(np.float32)
    h = hm.scaled_hand_model(th.map(lambda x: x.expand((n_w, t_len) + x.shape)), torch.from_numpy(scale))
    target = skin_landmarks(h, torch.from_numpy(angles), torch.from_numpy(wr))
    init = torch.from_numpy(angles + rng.uniform(-0.1, 0.1, angles.shape).astype(np.float32))
    return target, init, torch.from_numpy(wr), scale[:, 0]


def test_calibrate_scale_windows_equals_one_window_at_a_time(hands):
    """W = 5 windows in one solve as five ``calibrate_scale_window`` calls
    (held against JAX above): a full window, one with a single valid frame,
    one fully masked, two partly masked."""
    _, th = hands
    target, init, wr, scale = _windows(th, np.random.default_rng(5), 5, 6)
    mask = torch.ones(5, 6)
    mask[1, 1:] = 0.0
    mask[2] = 0.0
    mask[3, ::2] = 0.0
    mask[4, -2:] = 0.0
    target[mask == 0] += 50.0  # what the mask hides must not count
    both = gn.calibrate_scale_windows(th, target, init, wr, frame_mask=mask, iters=6)
    assert both.log_scale.shape == (5,) and both.residual.shape == (5,)
    for w in range(5):
        one = gn.calibrate_scale_window(th, target[w], init[w], wr[w], frame_mask=mask[w], iters=6)
        for field in ("log_scale", "residual", "joint_angles", "wrist"):
            torch.testing.assert_close(getattr(both, field)[w], getattr(one, field), rtol=0, atol=1e-6)
    assert float(both.log_scale[2]) == 0.0 and float(both.residual[2]) == 0.0  # nothing to fit
    np.testing.assert_allclose(np.exp(both.log_scale.numpy())[[0, 1, 3, 4]], scale[[0, 1, 3, 4]], rtol=5e-3)


def test_calibrate_scale_windows_has_no_per_window_loop(hands):
    """The same aten ops, as many times each, at W = 2 and at W = 16 (the
    ops the solver issues; LAPACK's batched solve on the CPU loops over its
    matrices inside one ``linalg_solve_ex``, so ops within ops are not
    counted)."""
    _, th = hands

    def ops(n_w):
        target, init, wr, _ = _windows(th, np.random.default_rng(6), n_w, 4)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            gn.calibrate_scale_windows(th, target, init, wr, frame_mask=torch.ones(n_w, 4), iters=2)
        return Counter(e.name for e in prof.events() if e.name.startswith("aten::")
                       and not (e.cpu_parent is not None and e.cpu_parent.name.startswith("aten::")))

    small, large = ops(2), ops(16)
    assert sum(small.values()) > 100 and small["aten::linalg_solve_ex"] == 2 * 3
    assert small == large


def _calib(rng, th, t_len, valid):
    """A pass-1 result of ``t_len`` frames (world wrists in mm, the right
    hand mirrored) with the given (2, T) validity and per-frame scales."""
    angles = rng.uniform(-0.2, 0.5, (2, t_len, 22)).astype(np.float32)
    wr = np.broadcast_to(np.eye(4, dtype=np.float32), (2, t_len, 4, 4)).copy()
    wr[..., :3, 3] = rng.uniform(-80, 80, (2, t_len, 3)) + [0, 0, 350]
    wr[1, ..., :, 0] *= -1
    return SimpleNamespace(
        valid_tracking=np.asarray(valid, bool), joint_angles=angles, wrist_xfs=wr,
        predicted_scales=rng.uniform(0.9, 1.1, (2, t_len)).astype(np.float32),
    )


def test_calibrated_scales_of_a_group_match_jax(hands):
    """One batched solve over a group of recordings of different lengths
    gives each recording the scale of JAX's per-recording GN calibration: a
    hand under 2 valid frames is left out, a recording where neither hand
    has 2 gets 1.0."""
    jh, th = hands
    rng = np.random.default_rng(7)
    calibs = [
        _calib(rng, th, 5, [[1, 1, 1, 0, 1], [1, 1, 1, 1, 1]]),
        _calib(rng, th, 3, [[0, 1, 0], [1, 1, 1]]),
        _calib(rng, th, 4, [[1, 0, 0, 0], [0, 0, 0, 1]]),
    ]
    got = calibration.calibrated_scales(calibs, th, "gn", "cpu")
    want = [junknown.calibrated_scale_from(c, jh, "gn") for c in calibs]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[2] == 1.0
    assert got[1] == unknown.calibrated_scale_from(calibs[1], th, "gn", "cpu")


# -- the reference's properties, on the synthetic hand ----------------------------


def test_recovers_perturbed_pose(hands):
    _, th = hands
    rng = np.random.default_rng(0)
    b = 3
    angles, wr = _poses(rng, b)
    target = _targets(th, angles, wr)
    init_a = angles + rng.uniform(-0.15, 0.15, (b, 22)).astype(np.float32)
    init_w = wr.copy()
    init_w[:, :3, 3] += rng.uniform(-8, 8, (b, 3))
    before = np.linalg.norm(_targets(th, init_a, init_w) - target, axis=-1).mean(-1)
    res = gn.fit_pose(_batched(th, b), torch.from_numpy(target), torch.from_numpy(init_a), torch.from_numpy(init_w), iters=8)
    assert before.min() > 2.0  # mm
    assert float(res.residual.max()) < 0.5, res.residual


def test_weighted_fit_ignores_downweighted_outliers(hands):
    _, th = hands
    rng = np.random.default_rng(1)
    angles, wr = _poses(rng, 1)
    target = _targets(th, angles, wr)
    corrupted = target.copy()
    corrupted[:, 0] += 200.0  # a gross outlier on one landmark
    w = np.ones((1, 21), np.float32)
    w[:, 0] = 1e-6
    res = gn.fit_pose(
        _batched(th, 1), torch.from_numpy(corrupted), torch.from_numpy(angles), torch.from_numpy(wr), iters=6,
        weights=torch.from_numpy(w),
    )
    clean = skin_landmarks(_batched(th, 1), res.joint_angles, res.wrist).numpy()
    assert np.linalg.norm(clean[:, 1:] - target[:, 1:], axis=-1).max() < 1.0


def test_recovers_known_scale(hands):
    _, th = hands
    rng = np.random.default_rng(2)
    angles, wr = _poses(rng, 6)
    target = _targets(th, angles, wr, 1.13)
    init_a = angles + rng.uniform(-0.1, 0.1, (6, 22)).astype(np.float32)
    res = gn.calibrate_scale_window(th, torch.from_numpy(target), torch.from_numpy(init_a), torch.from_numpy(wr), iters=8)
    np.testing.assert_allclose(float(torch.exp(res.log_scale)), 1.13, rtol=5e-3)
    assert float(res.residual) < 0.5


def test_masked_frames_ignored(hands):
    _, th = hands
    rng = np.random.default_rng(3)
    angles, wr = _poses(rng, 4)
    target = _targets(th, angles, wr, 0.9)
    target[2:] = 1e6  # garbage in the masked frames
    mask = torch.tensor([1.0, 1.0, 0.0, 0.0])
    res = gn.calibrate_scale_window(
        th, torch.from_numpy(target), torch.from_numpy(angles), torch.from_numpy(wr), frame_mask=mask, iters=8
    )
    np.testing.assert_allclose(float(torch.exp(res.log_scale)), 0.9, rtol=1e-2)
    assert torch.isfinite(res.wrist).all()


def test_jacobian_is_finite_at_zero(hands):
    """``so3_exp``'s safe branch keeps forward-mode derivatives finite at
    delta = 0, and float32 (no float64 tangents)."""
    _, th = hands
    angles, wr = _poses(np.random.default_rng(4), 1)

    def f(delta):
        a, w = gn._apply_delta(torch.from_numpy(angles[0]), torch.from_numpy(wr[0]), delta)
        return skin_landmarks(th, a, w).reshape(-1)

    jac = torch.func.jacfwd(f)(torch.zeros(gn.N_POSE))
    assert jac.shape == (63, gn.N_POSE) and jac.dtype == torch.float32 and torch.isfinite(jac).all()
    assert float(jac[:, 23:].abs().max()) > 0.5  # translation moves every landmark


# -- the CLI's gn calibration ------------------------------------------------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("gn"))


def test_unknown_skeleton_cli_gn_matches_jax(tree):
    """``--calib-mode gn`` with both passes in lockstep over the two
    recordings (the JAX side fits each hand's window op by op, ~6 s a
    window here; the sequential passes are held in ``test_torch_protocol.py``
    with the mean): the calibrated scales and pickles as JAX's."""
    argv = ["--batch-recordings", "2", "--generic-hand-model", tree["generic"], "--calib-mode", "gn"]
    j, t, jl, tl = run_both(tree, junknown, unknown, "unknown_gn", argv)
    results = assert_same_results(j, t, 2)
    assert_same_lines(jl, tl)
    assert all(0.5 < r["calibrated_scale"] < 2.0 for r in results.values())
