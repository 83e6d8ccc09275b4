"""Port parity: training (``absolutetrack_tpu_torch/training/``) against the
JAX package's ``training/`` on the CPU, plus the train state's file.

Inputs are made from seeds with numpy; the model is
``ModelConfig.tiny(input_size=(32, 32))`` with JAX's seeded params carried by
``load_jax_params``; the hand model is ``chip_smoke.synthetic_hand_model()``
in meters; B = 2 to 4 windows of T = 2. Tolerances, each measured before
it was fixed:

* ``pose_loss``/``sequence_loss`` on the same ``RegressorOutput``: the loss
  and each metric within 1e-6 relative (measured <= 1.5e-7: f32 FK and
  sums in another order);
* ``loss_fn`` over the unrolled model: 1e-5 relative (measured <= 4.4e-6,
  the unknown branch's scale term);
* gradients: each leaf within 1e-4 of that leaf's largest |g| (measured
  <= 1.1e-6);
* the optimizer alone on identical gradients: params, ``mu`` and ``nu``
  within 1e-6 of each leaf's largest value (measured <= 1.8e-7), counts
  and flags exact;
* one train step: params within 1e-6 wherever |g| exceeds the gradient
  tolerance (measured <= 7.5e-9); elsewhere a rounding difference can flip
  the sign of Adam's first update, ~lr * g/|g|, so within 2 lr (measured
  <= 5.5e-7: no flip in this batch);
* the train-state file: byte-equal;
* ``synthetic_sequence_batch``: exact; ``learnable_windows``: 1e-5
  (measured 1.3e-6);
* rendered windows: crops before their uint8 rounding >= 95% within the
  whole warp's 0.05 on the 0..255 scale (``tests/test_torch_warp.py``,
  which assumes source coordinates an f32 ulp apart) and all within 1.02:
  here each package computes its own crop cameras (2e-7 relative apart,
  measured) and source coordinate planes, which differ by up to 1.8e-3 px
  (measured), and at a mesh silhouette's 0-to-255 step within one source
  pixel that moves a sample by up to 2 x 255 x 2e-3 (measured: at most
  0.47, 97.4-99.7% within 0.05); the stored uint8 crops at most 2 apart and
  >= 99% equal (measured 1 and 99.6%); crop cameras 1e-5 relative; masks
  and labels exact.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from absolutetrack_tpu.geometry import camera as jcam
from absolutetrack_tpu.kinematics import hand_model as jhm
from absolutetrack_tpu.models import checkpoint as jckpt
from absolutetrack_tpu.models import init_umetrack_params
from absolutetrack_tpu.models.config import ModelConfig as JConfig
from absolutetrack_tpu.models.regressor import RegressorOutput as JOut
from absolutetrack_tpu.parallel import make_mesh
from absolutetrack_tpu.tracker import video_data as jvd
from absolutetrack_tpu.training import loss as jloss
from absolutetrack_tpu.training import rendered as jrendered
from absolutetrack_tpu.training import synthetic as jsynthetic
from absolutetrack_tpu.training import train as jtrain
from absolutetrack_tpu_torch.kinematics.hand_model import hand_model_from_dict, scaled_hand_model
from absolutetrack_tpu_torch.models import checkpoint
from absolutetrack_tpu_torch.models.config import ModelConfig
from absolutetrack_tpu_torch.models.layers import set_conv_precision
from absolutetrack_tpu_torch.models.params import (
    export_jax_params,
    export_jax_tensors,
    load_jax_params,
    load_jax_train_state,
)
from absolutetrack_tpu_torch.models.regressor import RegressorOutput
from absolutetrack_tpu_torch.parallel import make_mesh as make_port_mesh
from absolutetrack_tpu_torch.tracker import video_data as vd
from absolutetrack_tpu_torch.training import loss, optimizer, rendered, synthetic, train

jax.config.update("jax_platforms", "cpu")

CFG = ModelConfig.tiny(input_size=(32, 32))
JCFG = JConfig.tiny(input_size=(32, 32))
LOSS_REL = 1e-6
LOSS_FN_REL = 1e-5
GRAD_TOL = 1e-4  # of each leaf's largest |g|
OPT_REL = 1e-6
PARAM_TOL = 1e-6
LR = 1e-4
LEARNABLE_TOL = 1e-5
CAMERA_REL = 1e-5
WARP_TOL = 0.05  # 0..255 scale, tests/test_torch_warp.py
WARP_WITHIN = 0.95
CROPS_MAX = 2 * 255 * 2e-3
CROPS_EQUAL = 0.99


def setup_module():
    set_conv_precision("highest")


def _hand_dict():
    return chip_smoke.synthetic_hand_model()


def _hands(b):
    """(JAX, port) batched hand models in meters, left-canonical."""
    d = _hand_dict()
    jh = jhm.scaled_hand_model(jhm.hand_model_from_dict(d), 0.001)
    jh = jax.tree.map(lambda x: jnp.broadcast_to(x, (b,) + x.shape), jh)
    ph = scaled_hand_model(hand_model_from_dict(d), 0.001)
    return jh, ph.map(lambda x: x.expand((b,) + x.shape))


def _batch(b=4, t=2, seed=0, size=(32, 32)):
    """A seeded numpy SequenceBatch (JAX's field order) and its hand models."""
    rng = np.random.default_rng(seed)
    jh, ph = _hands(b)
    use_mem = np.zeros((t, b), bool)
    use_mem[1:] = True
    wrist = np.broadcast_to(np.eye(4, dtype=np.float32), (t, b, 4, 4)).copy()
    wrist[..., :3, 3] = rng.uniform(-0.05, 0.05, (t, b, 3))
    fields = dict(
        images=rng.uniform(0, 1, (t, b, 2) + size).astype(np.float32),
        intrinsics=np.broadcast_to(np.eye(3, dtype=np.float32) * [250, 250, 1], (t, b, 2, 3, 3)).copy(),
        extrinsics=np.broadcast_to(np.eye(4, dtype=np.float32), (t, b, 2, 4, 4)).copy(),
        use_memory=use_mem,
        sample_mask=np.ones((t, b), bool),
        hand_idx=(np.arange(b) % 2).astype(np.int32),
        skel_axes=np.asarray(jh.joint_rotation_axes),
        skel_rest=np.asarray(jh.joint_rest_positions),
        gt_joint_angles=rng.uniform(-0.5, 0.5, (t, b, 22)).astype(np.float32),
        gt_wrist=wrist,
        gt_log_scale=rng.uniform(-0.2, 0.2, b).astype(np.float32),
    )
    return jtrain.SequenceBatch(**fields), train.SequenceBatch(**fields), jh, ph


def _rel(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def jparams():
    return init_umetrack_params(jax.random.PRNGKey(0), JCFG)


def _port_model(jparams):
    return load_jax_params(jax.tree.map(np.asarray, jparams), CFG, device="cpu")


def _flat(tree, prefix=""):
    """A param tree's leaves by path."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


# --------------------------------------------------------------------------
# the losses
# --------------------------------------------------------------------------


def _outputs(t, b, seed):
    """A seeded RegressorOutput (T, B, ...): rotations from random
    quaternions, positive scales and sigmas."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((t, b, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = np.moveaxis(q, -1, 0)
    rot = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)
    xf = np.broadcast_to(np.eye(4), (t, b, 4, 4)).copy()
    xf[..., :3, :3] = rot
    xf[..., :3, 3] = rng.uniform(-0.1, 0.1, (t, b, 3))
    return dict(
        joint_angles=rng.uniform(-0.5, 0.5, (t, b, 22)).astype(np.float32),
        wrist_xfs=xf.astype(np.float32),
        skel_scales=rng.uniform(0.8, 1.2, (t, b)).astype(np.float32),
        landmark_uncertainty_sigmas=rng.uniform(0.005, 0.05, (t, b, 21)).astype(np.float32),
    )


@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("which", ["pose_loss", "sequence_loss"])
def test_losses_match_jax(which, with_scale):
    t, b = 2, 3
    out = _outputs(t, b, 1)
    jb, pb, jh, ph = _batch(b, t, seed=2)
    mask = np.ones((t, b), bool)
    mask[1, 2] = False
    scale = pb.gt_log_scale if with_scale else None
    if which == "pose_loss":
        flat = lambda x: x.reshape((t * b,) + x.shape[2:])  # noqa: E731
        jh = jax.tree.map(lambda x: jnp.concatenate([x] * t), jh)
        ph = ph.map(lambda x: torch.cat([x] * t))
        jout = JOut(**{k: jnp.asarray(flat(v)) for k, v in out.items()})
        pout = RegressorOutput(**{k: torch.from_numpy(flat(v)) for k, v in out.items()})
        js = None if scale is None else jnp.asarray(np.concatenate([scale] * t))
        ps = None if scale is None else torch.from_numpy(np.concatenate([scale] * t))
        want = jloss.pose_loss(jout, jh, jnp.asarray(flat(jb.gt_joint_angles)), jnp.asarray(flat(jb.gt_wrist)),
                               jnp.asarray(flat(mask)), gt_log_scale=js)
        got = loss.pose_loss(pout, ph, torch.from_numpy(flat(pb.gt_joint_angles)), torch.from_numpy(flat(pb.gt_wrist)),
                             torch.from_numpy(flat(mask)), gt_log_scale=ps)
    else:
        jout = JOut(**{k: jnp.asarray(v) for k, v in out.items()})
        pout = RegressorOutput(**{k: torch.from_numpy(v) for k, v in out.items()})
        want = jloss.sequence_loss(jout, jh, jnp.asarray(jb.gt_joint_angles), jnp.asarray(jb.gt_wrist),
                                   jnp.asarray(mask), gt_log_scale=None if scale is None else jnp.asarray(scale))
        got = loss.sequence_loss(pout, ph, torch.from_numpy(pb.gt_joint_angles), torch.from_numpy(pb.gt_wrist),
                                 torch.from_numpy(mask), gt_log_scale=None if scale is None else torch.from_numpy(scale))
    assert list(got[1]) == list(want[1])
    assert ("skel_scale_logmse" in got[1]) == with_scale
    assert _rel(want[0], got[0].numpy()) <= LOSS_REL
    for k in want[1]:
        assert _rel(want[1][k], got[1][k].numpy()) <= LOSS_REL, k


def test_zero_distance_gives_a_nonfinite_gradient():
    """A prediction exactly on the GT: ``jnp.linalg.norm``'s gradient at 0 is
    NaN, and so is the port's, so both optimizers' guards see it."""
    t, b = 1, 2
    _, _, jh, ph = _batch(b, t, seed=3)
    out = _outputs(t, b, 4)
    gt_ja, gt_wr = out["joint_angles"][0], out["wrist_xfs"][0]
    mask = np.ones(b, bool)

    def jf(ja):
        o = JOut(ja, jnp.asarray(gt_wr), None, jnp.asarray(out["landmark_uncertainty_sigmas"][0]))
        return jloss.pose_loss(o, jh, jnp.asarray(gt_ja), jnp.asarray(gt_wr), jnp.asarray(mask))[0]

    jg = np.asarray(jax.grad(jf)(jnp.asarray(gt_ja)))
    ja = torch.from_numpy(gt_ja.copy()).requires_grad_(True)
    o = RegressorOutput(ja, torch.from_numpy(gt_wr), None, torch.from_numpy(out["landmark_uncertainty_sigmas"][0]))
    total, _ = loss.pose_loss(o, ph, torch.from_numpy(gt_ja), torch.from_numpy(gt_wr), torch.from_numpy(mask))
    (pg,) = torch.autograd.grad(total, ja)
    assert not np.isfinite(jg).all()
    assert not torch.isfinite(pg).all()
    np.testing.assert_array_equal(np.isfinite(jg), torch.isfinite(pg).numpy())


# --------------------------------------------------------------------------
# loss_fn and its gradients through the unrolled model
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_value_and_grad(jparams):
    """JAX's (loss, metrics) and gradients for each branch on one batch."""
    jb, _, jh, _ = _batch(4, 2, seed=5)
    jb = jax.tree.map(jnp.asarray, jb)
    out = {}
    for branch in ("known", "unknown"):
        fn = jax.jit(jax.value_and_grad(lambda p, b=branch: jtrain.loss_fn(p, jb, jh, JCFG, b), has_aux=True))
        (total, metrics), grads = fn(jparams)
        out[branch] = (float(total), {k: float(v) for k, v in metrics.items()}, jax.tree.map(np.asarray, grads))
    # "both" is the two losses' sum (``loss_fn``'s own definition), one compile fewer
    (tk, mk, gk), (tu, mu, gu) = out["known"], out["unknown"]
    metrics = {f"u_{k}": v for k, v in mu.items()}
    metrics.update(mk)
    metrics["total"] = tk + tu
    out["both"] = (tk + tu, metrics, jax.tree.map(np.add, gk, gu))
    return out


def _port_value_and_grad(jparams, branch):
    model = _port_model(jparams).requires_grad_(True)
    _, pb, _, ph = _batch(4, 2, seed=5)
    pb, ph = train.to_device(pb, ph, "cpu")
    total, metrics = train.loss_fn(model, pb, ph, CFG, branch)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(total, [p for _, p in model.named_parameters()], allow_unused=True)
    return float(total), {k: float(v) for k, v in metrics.items()}, dict(zip(names, grads))


@pytest.mark.parametrize("branch", ["known", "unknown", "both"])
def test_loss_fn_and_gradients_match_jax(jparams, jax_value_and_grad, branch):
    want_total, want_metrics, want_grads = jax_value_and_grad[branch]
    total, metrics, grads = _port_value_and_grad(jparams, branch)
    assert abs(total - want_total) <= LOSS_FN_REL * abs(want_total)
    assert sorted(metrics) == sorted(want_metrics)
    for k, v in want_metrics.items():
        assert abs(metrics[k] - v) <= LOSS_FN_REL * abs(v), k
    unused = {n for n, g in grads.items() if g is None}
    got = _flat(export_jax_tensors({n: torch.zeros_like(p) if g is None else g for (n, g), p in zip(
        grads.items(), _port_model(jparams).parameters())}, CFG))
    want = _flat(want_grads)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        scale = np.abs(w).max()
        assert np.abs(got[k] - w).max() <= GRAD_TOL * max(scale, 1e-30), (k, scale)
    if branch == "known":
        assert unused and all(n.startswith("regressor_u.") for n in unused)
        assert all(not np.any(want[k]) for k in want if k.startswith("/regressor_u/"))
    elif branch == "unknown":
        assert all(n.startswith(("regressor_k.", "skeleton_encoder.")) for n in unused)
    else:
        assert not unused


def test_masked_samples_do_not_contribute(jparams):
    """The port's counterpart of ``tests/test_training.py``'s: the loss with
    half the batch masked equals the loss of the unmasked half."""
    model = _port_model(jparams)
    _, pb, _, ph = _batch(4, 2, seed=6)
    mask = pb.sample_mask.copy()
    mask[:, 2:] = False
    masked, _ = train.loss_fn(model, *train.to_device(pb._replace(sample_mask=mask), ph, "cpu"), CFG)
    time_major = {"images", "intrinsics", "extrinsics", "use_memory", "sample_mask", "gt_joint_angles", "gt_wrist"}
    half = train.SequenceBatch(**{k: (v[:, :2] if k in time_major else v[:2]) for k, v in pb._asdict().items()})
    halved, _ = train.loss_fn(model, *train.to_device(half, ph.map(lambda x: x[:2]), "cpu"), CFG)
    np.testing.assert_allclose(float(masked), float(halved), rtol=2e-4)


class _Branch(torch.nn.Module):
    """One branch's step as a module, for ``torch.func.functional_call``."""

    def __init__(self, model, branch):
        super().__init__()
        self.model, self.branch = model, branch

    def forward(self, state, frame, skel):
        if self.branch == "known":
            _, out = self.model.regress_pose_use_skeleton(state, frame, skel)
        else:
            _, out = self.model.regress_pose_pred_skel_scale(state, frame)
        return tuple(x for x in out if x is not None)


@pytest.mark.parametrize("branch", ["known", "unknown"])
def test_gradcheck_through_the_model_in_float64(branch):
    """``torch.autograd.gradcheck`` in float64 through
    ``regress_pose_use_skeleton`` / ``regress_pose_pred_skel_scale`` (the
    in-place writes of the wrist recovery, Procrustes and fusion), with
    respect to the regressor's output bias and the fusion's final bias."""
    from absolutetrack_tpu_torch.models.temporal import TemporalState
    from absolutetrack_tpu_torch.models.umetrack import FrameInputs, SkeletonInputs, UmeTrackModel

    model = UmeTrackModel(CFG, device="cpu", generator=torch.Generator().manual_seed(3)).double()
    _, pb, _, _ = _batch(2, 1, seed=7)
    d = lambda x: torch.from_numpy(np.asarray(x)).double()  # noqa: E731
    ext = d(pb.extrinsics[0]).clone()
    ext[:, 1, 0, 3] = -0.06
    frame = FrameInputs(d(pb.images[0]), d(pb.intrinsics[0]), ext, torch.ones(2, 2, dtype=torch.bool),
                        torch.tensor([0, 1]), torch.tensor([True, False]), torch.ones(2, dtype=torch.bool))
    h, w = CFG.feature_size
    state = TemporalState(torch.rand(2, h, w, CFG.n_temporal_memory_channels, dtype=torch.float64,
                                     generator=torch.Generator().manual_seed(4)),
                          torch.eye(4, dtype=torch.float64).expand(2, 4, 4))
    skel = SkeletonInputs(d(pb.skel_axes), d(pb.skel_rest))
    head = "regressor_k" if branch == "known" else "regressor_u"
    module = _Branch(model, branch)
    names = (f"model.{head}.out.bias", "model.fusion.final.bias")
    start = dict(module.named_parameters())

    def fn(*biases):
        return torch.func.functional_call(module, dict(zip(names, biases)), (state, frame, skel))

    inputs = tuple((start[n].detach() + 0.01).requires_grad_(True) for n in names)
    assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-5, rtol=1e-4, fast_mode=True)


# --------------------------------------------------------------------------
# the optimizer alone, on identical gradients
# --------------------------------------------------------------------------

OPT_SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}


def _opt_grads(case, rng):
    """The case's gradient sequence: dicts of float32 arrays, None (the
    port) / zeros (JAX) for a parameter without a gradient."""
    def draw(scale):
        return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in OPT_SHAPES.items()}

    nan = {k: np.where(np.arange(np.prod(s)).reshape(s) == 1, np.nan, 0.1).astype(np.float32)
           for k, s in OPT_SHAPES.items()}
    if case == "unclipped":  # norm < 1, one parameter without a gradient
        return [dict(draw(0.05), b=None) for _ in range(3)]
    if case == "clipped":  # norm > 1
        return [draw(2.0) for _ in range(3)]
    if case == "one_nan":
        return [draw(0.1), nan, draw(0.1), draw(3.0)]
    return [draw(0.1)] + [nan] * 11 + [draw(0.1)]  # the 11th NaN step is applied


@pytest.mark.parametrize("case", ["unclipped", "clipped", "one_nan", "eleven_nans"])
def test_optimizer_matches_optax(case):
    """optax's ``apply_if_finite(chain(clip_by_global_norm(1), adamw))`` and
    the port's, fed the same gradients, step by step: params, moments,
    count and the guard's fields."""
    rng = np.random.default_rng(["unclipped", "clipped", "one_nan", "eleven_nans"].index(case))
    init = {k: rng.uniform(-1, 1, s).astype(np.float32) for k, s in OPT_SHAPES.items()}
    jopt, popt = jtrain.make_optimizer(1e-2), train.make_optimizer(1e-2)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    js = jopt.init(jp)
    pp = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    ps = popt.init(pp)
    for i, g in enumerate(_opt_grads(case, rng)):
        ju, js = jopt.update({k: jnp.zeros(OPT_SHAPES[k]) if v is None else jnp.asarray(v) for k, v in g.items()},
                             js, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        pu, ps = popt.update({k: None if v is None else torch.from_numpy(v) for k, v in g.items()}, ps, pp)
        optimizer.apply_updates(pp, pu)
        adam = js.inner_state[1][0]
        for name, want, got in (("params", jp, pp), ("mu", adam.mu, ps.inner_state.mu), ("nu", adam.nu, ps.inner_state.nu)):
            for k in OPT_SHAPES:
                w, x = np.asarray(want[k]), got[k].numpy()
                np.testing.assert_array_equal(np.isnan(w), np.isnan(x))
                scale = max(np.nanmax(np.abs(w), initial=0.0), 1e-30)
                np.testing.assert_allclose(x, w, rtol=0, atol=OPT_REL * scale, err_msg=f"step {i} {name} {k}")
        for field in ("notfinite_count", "last_finite", "total_notfinite"):
            assert getattr(ps, field).item() == np.asarray(getattr(js, field)).item(), (i, field)
        assert ps.inner_state.count.item() == int(adam.count), i
        assert ps.inner_state.count.dtype == ps.notfinite_count.dtype == torch.int32
    if case == "eleven_nans":
        assert ps.notfinite_count.item() == 0 and ps.total_notfinite.item() == 11
        assert all(torch.isnan(p).all() for p in pp.values())  # the 11th NaN update went through


def test_optimizer_differs_from_torch_adamw():
    """The three pieces that torch's stock ones compute otherwise: the clip
    (``clip_grad_norm_`` scales by ``1 / (norm + 1e-6)``), the decay's place
    and the guard; here the clip alone moves the result."""
    g = {"w": torch.full((4,), 2.0)}
    p = {"w": torch.ones(4)}
    opt = train.make_optimizer(1.0, weight_decay=0.0)
    state = opt.init(p)
    _, state = opt.update(g, state, p)
    # optax: g / |g| exactly (norm 4 -> 0.5); clip_grad_norm_ would give 0.5 / (1 + 2.5e-7)
    np.testing.assert_array_equal(state.inner_state.mu["w"].numpy(), np.float32(0.1) * np.float32(0.5))


# --------------------------------------------------------------------------
# one train step against JAX's make_train_step
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_step(jparams):
    """JAX's state after one train step (mesh 1 x 1) and its metrics."""
    jb, _, jh, _ = _batch(4, 2, seed=8)
    jb = jax.tree.map(jnp.asarray, jb)
    opt = jtrain.make_optimizer(LR)
    params = jax.tree.map(jnp.array, jparams)  # the step donates its state
    state = jtrain.TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    mesh = make_mesh(data=1, model=1, devices=jax.devices()[:1])
    with mesh:
        step = jtrain.make_train_step(mesh, JCFG, opt, branch="known")
        new_state, metrics = step(state, jb, jh)
    return jax.tree.map(np.asarray, new_state), {k: float(v) for k, v in metrics.items()}


def test_train_step_matches_jax(jparams, jax_step):
    """The loss, then the params after the step by the gradient's size
    (the port's gradients, which are JAX's within ``GRAD_TOL``)."""
    want_state, want_metrics = jax_step
    model = _port_model(jparams)
    _, pb, _, ph = _batch(4, 2, seed=8)
    names = [n for n, _ in model.named_parameters()]
    total, _ = train.loss_fn(model.requires_grad_(True), *train.to_device(pb, ph, "cpu"), CFG)
    grads = dict(zip(names, torch.autograd.grad(total, list(model.parameters()), allow_unused=True)))
    grads = {n: torch.zeros_like(p) if grads[n] is None else grads[n] for n, p in model.named_parameters()}
    state = train.init_train_state(model, train.make_optimizer(LR))
    step = train.make_train_step(CFG, train.make_optimizer(LR), branch="known")
    state, metrics = step(state, pb, ph)
    assert state.params is model and int(state.step) == 1 and state.step.dtype == torch.int32
    for k, v in want_metrics.items():
        assert abs(float(metrics[k]) - v) <= LOSS_FN_REL * abs(v), k
    got, want, g = _flat(export_jax_params(model)), _flat(want_state.params), _flat(export_jax_tensors(grads, CFG))
    for k, w in want.items():
        strong = np.abs(g[k]) > GRAD_TOL * np.abs(g[k]).max()
        d = np.abs(got[k] - w)
        assert d[strong].max(initial=0.0) <= PARAM_TOL, k
        assert d.max() <= 2 * LR, k


def test_train_step_refuses_a_mesh():
    """The steps take a ``parallel.Mesh`` and nothing else; a mesh of
    several ranks needs their process group (``tests/test_torch_parallel.py``
    runs the steps in such worlds)."""
    with pytest.raises(TypeError, match="parallel.Mesh"):
        train.make_train_step(CFG, train.make_optimizer(), mesh=object())
    with pytest.raises(TypeError, match="parallel.Mesh"):
        train.make_eval_step(CFG, mesh=object())
    with pytest.raises(RuntimeError, match="torchrun"):
        make_port_mesh(data=1, model=2, devices="cpu")


def test_eval_step_matches_jax(jparams):
    jb, pb, jh, ph = _batch(4, 2, seed=9)
    mesh = make_mesh(data=1, model=1, devices=jax.devices()[:1])
    with mesh:
        want = jtrain.make_eval_step(mesh, JCFG)(jparams, jax.tree.map(jnp.asarray, jb), jh)
    got = train.make_eval_step(CFG)(_port_model(jparams), pb, ph)
    assert _rel(want["err_sum_m"], got["err_sum_m"].numpy()) <= LOSS_FN_REL
    assert float(got["err_count"]) == float(want["err_count"]) == 8
    assert got["scales"] is None and not got["joint_angles"].requires_grad


# --------------------------------------------------------------------------
# the train state's file
# --------------------------------------------------------------------------


def test_train_state_file_is_jaxs_and_crosses_both_ways(tmp_path, jax_step):
    """The port's file for a state carried from JAX equals JAX's
    ``save_train_state`` byte for byte; each package reads the other's."""
    jstate = jax_step[0]
    jckpt.save_train_state(str(tmp_path / "jax.train"), jax.tree.map(jnp.asarray, jstate))
    state = load_jax_train_state(jstate, CFG, device="cpu")
    checkpoint.save_train_state(str(tmp_path / "port.train"), state)
    assert (tmp_path / "port.train").read_bytes() == (tmp_path / "jax.train").read_bytes()

    back = checkpoint.load_train_state(str(tmp_path / "jax.train"), state)
    checkpoint.save_train_state(str(tmp_path / "again.train"), back)
    assert (tmp_path / "again.train").read_bytes() == (tmp_path / "jax.train").read_bytes()
    assert int(back.step) == 1 and back.opt_state.inner_state.count.item() == 1
    jtemplate = jax.tree.map(jnp.zeros_like, jax.tree.map(jnp.asarray, jstate))
    jback = jckpt.load_train_state(str(tmp_path / "port.train"), jtemplate)
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert not (tmp_path / "port.train.tmp").exists()


def test_load_train_state_checks_the_architecture(tmp_path, jparams):
    model = _port_model(jparams)
    state = train.init_train_state(model, train.make_optimizer())
    checkpoint.save_train_state(str(tmp_path / "s.train"), state)
    other = train.init_train_state(load_jax_params(jax.tree.map(np.asarray, init_umetrack_params(
        jax.random.PRNGKey(0), JConfig.tiny(input_size=(32, 32), n_image_feature_channels=16))),
        ModelConfig.tiny(input_size=(32, 32), n_image_feature_channels=16), device="cpu"), train.make_optimizer())
    with pytest.raises(ValueError, match="expected an array of shape"):
        checkpoint.load_train_state(str(tmp_path / "s.train"), other)


# --------------------------------------------------------------------------
# the window builders
# --------------------------------------------------------------------------


@pytest.mark.parametrize("b,t,seed", [(2, 2, 0), (3, 4, 7)])
def test_synthetic_sequence_batch_equals_jax(b, t, seed):
    want = jsynthetic.synthetic_sequence_batch(b, t, JCFG, seed)
    got = synthetic.synthetic_sequence_batch(b, t, CFG, seed)
    for name, w in want._asdict().items():
        x = getattr(got, name)
        assert x.dtype == w.dtype, name
        np.testing.assert_array_equal(x, w, err_msg=name)
    jh, ph = jsynthetic.synthetic_hand_model_m(b, seed), synthetic.synthetic_hand_model_m(b, seed)
    for name, w in jh._asdict().items():
        x = getattr(ph, name)
        assert (w is None) == (x is None), name
        if w is not None:
            assert x.dtype == np.asarray(w).dtype, name
            np.testing.assert_array_equal(x, np.asarray(w), err_msg=name)


def test_learnable_windows_match_jax(tmp_path):
    """With a given hand model and with the generic hand model's JSON (the
    port takes its path; JAX reads the same file)."""
    jh, ph = _hands(3)
    jb, _ = jsynthetic.learnable_windows(3, 2, JCFG, seed=4, hand_m=jh)
    pb, _ = synthetic.learnable_windows(3, 2, CFG, seed=4, hand_m=ph)
    generic = tmp_path / "generic.json"
    generic.write_text(json.dumps({k: np.asarray(v).tolist() for k, v in _hand_dict().items()}))
    jb2, jh2 = jsynthetic.learnable_windows(2, 2, JCFG, seed=5, hand_m=jax.tree.map(
        lambda x: jnp.broadcast_to(x, (2,) + x.shape), jhm.scaled_hand_model(jhm.load_hand_model_json(str(generic)), 0.001)))
    pb2, ph2 = synthetic.learnable_windows(2, 2, CFG, seed=5, generic_hand_model=str(generic))
    for want, got in ((jb, pb), (jb2, pb2)):
        for name, w in want._asdict().items():
            x = getattr(got, name)
            np.testing.assert_allclose(x, np.asarray(w), rtol=0, atol=LEARNABLE_TOL, err_msg=name)
        assert np.asarray(got.images).max() > 0.5
    np.testing.assert_array_equal(ph2.joint_rest_positions, np.asarray(jh2.joint_rest_positions))


@pytest.fixture(scope="module")
def label_tree(tmp_path_factory):
    """Three recordings of a mesh scene (12 frames each) and the scene's hand
    model as the generic one."""
    root = tmp_path_factory.mktemp("labels")
    scene = chip_smoke.build_scene(1, 14, mesh=True)
    paths = []
    for i in range(3):
        p = root / f"recording_{i:02d}.json"
        p.write_text(json.dumps(chip_smoke.labels_json(scene, i, 12)))
        paths.append(str(p))
    generic = root / "generic_hand_model.json"
    generic.write_text(json.dumps({k: np.asarray(v).tolist() for k, v in scene["hand_model"].items()}))
    return dict(paths=paths, generic=str(generic))


def _jax_labels(labels):
    """The port's labels as the JAX package's (numpy arrays, JAX trees)."""
    if isinstance(labels, jvd.HandPoseLabels):
        return labels
    tree = lambda t, xs: t(*(None if x is None else jnp.asarray(np.asarray(x)) for x in xs))  # noqa: E731
    fields = {f.name: getattr(labels, f.name) for f in dataclasses.fields(labels)}
    fields["cameras"] = tree(jcam.Camera, labels.cameras)
    fields["hand_model"] = tree(jhm.HandModel, labels.hand_model)
    return jvd.HandPoseLabels(**fields)


_JAX_FRAME_SOURCE = jvd.make_frame_source


class _Frames:
    """The JAX renderer's frames for either package's labels, one source
    per recording and renderer (the two mesh renderers agree bit for bit
    only given the same projections, ``tests/test_torch_frames.py``; here
    both window builders see the same frames)."""

    sources = {}

    def __init__(self, labels, renderer="mesh", landmarks_world=None, blob_sigma=3.0, image_size=None):
        jl = _jax_labels(labels)
        key = (renderer, blob_sigma) + tuple(
            np.asarray(x).tobytes() for x in (jl.joint_angles, jl.wrist_transforms, jl.camera_to_world,
                                              jl.hand_model.joint_rest_positions))
        if key not in self.sources:
            lm = jrendered._gt_landmarks_mm(jl) if renderer == "blobs" else None
            self.sources[key] = _JAX_FRAME_SOURCE(jl, renderer=renderer, landmarks_world=lm, blob_sigma=blob_sigma)
        self.src = self.sources[key]

    def render_frame(self, i):
        return self.src.render_frame(i)


@pytest.fixture
def same_frames(monkeypatch, label_tree):
    """Both builders render through ``_Frames``; JAX's scale reference reads
    the tree's generic hand model (its path is fixed there)."""
    real_json = jhm.load_hand_model_json
    monkeypatch.setattr(jvd, "make_frame_source", _Frames)
    monkeypatch.setattr(rendered, "make_frame_source", _Frames)
    monkeypatch.setattr(jhm, "load_hand_model_json", lambda path: real_json(label_tree["generic"]))


class _Unrounded:
    """Records the crops (x 255) that each builder rounds to uint8."""

    def __init__(self, monkeypatch):
        self.crops, real = [], np.round

        def record(x, *args, **kwargs):
            if isinstance(x, np.ndarray) and x.ndim == 4 and x.dtype == np.float32:
                self.crops.append(x.copy())
            return real(x, *args, **kwargs)

        monkeypatch.setattr(np, "round", record)


def _compare_windows(want, got, want_hand, got_hand, unrounded=None):
    """The two packages' windows, held as the module docstring says (the
    crops before their rounding when recorded)."""
    if unrounded is not None:
        assert len(unrounded.crops) == 2
        d = np.abs(unrounded.crops[1] - unrounded.crops[0])
        assert d.max() <= CROPS_MAX and (d <= WARP_TOL).mean() >= WARP_WITHIN, (d.max(), (d <= WARP_TOL).mean())
    wi, gi = np.asarray(want.images), np.asarray(got.images)
    assert gi.dtype == wi.dtype == np.uint8 and gi.shape == wi.shape
    d = np.abs(wi.astype(np.int16) - gi.astype(np.int16))
    assert d.max() <= 2 and (d == 0).mean() >= CROPS_EQUAL, (d.max(), (d == 0).mean())
    for name in ("intrinsics", "extrinsics"):
        w, x = np.asarray(getattr(want, name)), getattr(got, name)
        np.testing.assert_allclose(x, w, rtol=0, atol=CAMERA_REL * np.abs(w).max(), err_msg=name)
    for name in ("use_memory", "sample_mask", "hand_idx", "skel_axes", "skel_rest", "gt_joint_angles", "gt_wrist",
                 "gt_log_scale"):
        w, x = np.asarray(getattr(want, name)), getattr(got, name)
        assert x.dtype == w.dtype, name
        np.testing.assert_array_equal(x, w, err_msg=name)
    for name, w in want_hand._asdict().items():
        x = getattr(got_hand, name)
        assert (w is None) == (x is None), name
        if w is not None:
            np.testing.assert_array_equal(x, np.asarray(w), err_msg=name)


@pytest.mark.parametrize("renderer,jitter", [("mesh", None), ("blobs", None), ("mesh", 5)])
def test_rendered_windows_match_jax(label_tree, same_frames, monkeypatch, renderer, jitter):
    """2 windows of T = 2 at 32x32 through each package's crop slots and
    warp, with crop jitter in one case."""
    path = label_tree["paths"][0]
    unrounded = _Unrounded(monkeypatch)
    want, want_hand = jrendered.rendered_windows_from_labels(
        jvd.load_labels(path), [0, 5], 2, cfg=JCFG, renderer=renderer, crop_jitter_seed=jitter)
    got, got_hand = rendered.rendered_windows_from_labels(
        vd.load_labels(path), [0, 5], 2, cfg=CFG, renderer=renderer, crop_jitter_seed=jitter,
        generic_hand_model=label_tree["generic"], device="cpu")
    assert got.images.shape == (2, 4, 2, 32, 32) and got.sample_mask.any()
    _compare_windows(want, got, want_hand, got_hand, unrounded)


def test_rendered_dataset_and_its_cache_cross_both_ways(tmp_path, label_tree, same_frames, monkeypatch):
    """Two recordings, one augmented replica each with jittered crops:
    the windows match JAX's; each package's ``.npz`` cache is a hit for the
    other (the builders refuse to run) and gives back the same arrays."""
    kw = dict(window_t=2, stride=4, max_windows_per_recording=2, augment=1, crop_jitter=True, seed=3)
    paths = label_tree["paths"][:2]
    want, want_hand = jrendered.rendered_dataset(paths, cfg=JCFG, cache_path=str(tmp_path / "jax.npz"), **kw)
    got, got_hand = rendered.rendered_dataset(paths, cfg=CFG, cache_path=str(tmp_path / "port.npz"),
                                              generic_hand_model=label_tree["generic"], device="cpu", **kw)
    assert got.hand_idx.shape == (2 * 2 * 2 * 2,)
    _compare_windows(want, got, want_hand, got_hand)
    assert bytes(np.load(tmp_path / "jax.npz")["meta_json"]) == bytes(np.load(tmp_path / "port.npz")["meta_json"])

    def refuse(*args, **kwargs):
        raise AssertionError("the cache was not used")

    monkeypatch.setattr(rendered, "rendered_windows_from_labels", refuse)
    monkeypatch.setattr(jrendered, "rendered_windows_from_labels", refuse)
    from_jax, from_jax_hand = rendered.rendered_dataset(paths, cfg=CFG, cache_path=str(tmp_path / "jax.npz"), **kw)
    from_port, from_port_hand = jrendered.rendered_dataset(paths, cfg=JCFG, cache_path=str(tmp_path / "port.npz"), **kw)
    for a, b in ((from_jax, want), (from_port, got), (from_jax_hand, want_hand), (from_port_hand, got_hand)):
        for name in a._fields:
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None), name
            if x is not None:
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)
    batch, hand = rendered.slice_windows(from_jax, from_jax_hand, np.array([1, 3]))
    assert batch.images.dtype == np.float32 and batch.images.shape[1] == 2 and hand.joint_rest_positions.shape[0] == 2


def test_rendered_windows_default_to_the_card(label_tree, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rendered.rendered_windows_from_labels(vd.load_labels(label_tree["paths"][0]), [0], 2, cfg=CFG,
                                              generic_hand_model=label_tree["generic"])
