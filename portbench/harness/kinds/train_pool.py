"""Training on a pool of windows held on the card.

Set-up draws the weights and a pool of ``pool_factor`` x ``batch``
windows (``frames`` frames x the configuration's views of noise crops,
crop intrinsics and extrinsics, hands alternating left and right, a
skeleton scale, true joint angles and wrists) on the card from the seed,
builds the program's train step (``training.train.make_train_step``, both
heads, its clipped AdamW) and runs its first three steps through the
window's own feed: each step takes ``batch`` windows without replacement
from a permutation of the pool drawn every ``pool_factor`` steps, so the
first three steps' rows all differ. The window repeats the step. The
reference then follows the first three steps from the same weights and
rows: each step's loss, the first gradient as the optimizer got it (its
first moment / (1 - b1)) and the parameters' change after three steps,
each leaf's norm against the reference's.
"""

from __future__ import annotations

import statistics
import time

import torch

from ...reference import training as ref_training
from ...reference.network import make_params, quat_to_rot
from .. import scene as scn
from ..core import Context, SetupClock, load_params, model_config
from ..counts import train_step_flops
from ..trace import traced

CHECKED_STEPS = 3
B1 = ref_training.B1


def rigid(rot, t):
    out = torch.zeros(rot.shape[:-2] + (4, 4), device=rot.device)
    out[..., :3, :3] = rot
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def random_rotation(g, shape, device):
    q = torch.randn(shape + (4,), generator=g, device=device)
    return quat_to_rot(q / torch.linalg.norm(q, dim=-1, keepdim=True))


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap between two norms, against the reference's norm
    of that leaf or of the median leaf, whichever is larger."""
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in names)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in names)


class Pool:
    """The windows, on the device, and the rows of a step."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str):
        self.b = traffic["batch"]
        self.p = traffic["pool_factor"] * self.b
        t, v, (h, w) = traffic["frames"], cfg["num_views"], cfg["input_size"]
        p, dev = self.p, device
        g = torch.Generator(device=dev).manual_seed((2 * seed + 1) % 2**63)
        self.feed_gen = torch.Generator(device=dev).manual_seed((2 * seed + 2) % 2**63)

        def rand(*shape):
            return torch.rand(shape, generator=g, device=dev)

        self.images = rand(t, p, v, h, w)
        focal = 150.0 + 200.0 * rand(t, p, v)
        intr = torch.zeros(t, p, v, 3, 3, device=dev)
        intr[..., 0, 0], intr[..., 1, 1] = focal, focal
        intr[..., 0, 2], intr[..., 1, 2], intr[..., 2, 2] = (w - 1) / 2, (h - 1) / 2, 1.0
        self.intrinsics = intr
        ext_t = torch.stack([0.05 * torch.randn((t, p, v), generator=g, device=dev),
                             0.05 * torch.randn((t, p, v), generator=g, device=dev),
                             0.25 + 0.2 * rand(t, p, v)], -1)
        self.extrinsics = rigid(random_rotation(g, (t, p, v), dev), ext_t)
        self.use_memory = (torch.arange(t, device=dev) > 0)[:, None].expand(t, p).contiguous()
        self.sample_mask = torch.ones(t, p, dtype=torch.bool, device=dev)
        self.hand_idx = (torch.arange(p, device=dev) % 2).to(torch.int32)
        self.scale = 0.85 + 0.3 * rand(p)
        angles = 0.7 * rand(t, p, 22) - 0.35
        angles[..., 20:] = 0.0
        self.angles = angles
        wrist_t = torch.stack([0.24 * rand(t, p) - 0.12, 0.24 * rand(t, p) - 0.12, 0.30 + 0.12 * rand(t, p)], -1)
        self.wrist = rigid(random_rotation(g, (t, p), dev), wrist_t)
        hand = scn.synthetic_hand_model()
        self.fk = scn.hand_tensors(hand, dev, scale=1e-3)  # metres
        ints = ("joint_frame_index", "joint_parent", "joint_first_child", "joint_next_sibling",
                "landmark_rest_bone_indices")
        self.hand_const = {k: torch.as_tensor(v, dtype=torch.int64 if k in ints else torch.float32, device=dev)
                           for k, v in hand.items()}
        self.perm = None

    def rows(self, step: int) -> torch.Tensor:
        """The step's ``batch`` rows: a new permutation every pool_factor steps."""
        epoch = self.p // self.b
        if step % epoch == 0:
            self.perm = torch.randperm(self.p, generator=self.feed_gen, device=self.images.device)
        j = step % epoch
        return self.perm[j * self.b:(j + 1) * self.b]

    def fields(self, idx: torch.Tensor) -> dict:
        """The rows' windows (time-major) and their hands' scaled lengths."""
        s = self.scale[idx]
        return dict(
            images=self.images[:, idx], intrinsics=self.intrinsics[:, idx], extrinsics=self.extrinsics[:, idx],
            use_memory=self.use_memory[:, idx], sample_mask=self.sample_mask[:, idx], hand_idx=self.hand_idx[idx],
            skel_axes=self.fk["axes"].expand(idx.shape[0], -1, -1), skel_rest=self.fk["rest"] * s[:, None, None],
            gt_joint_angles=self.angles[:, idx], gt_wrist=self.wrist[:, idx], gt_log_scale=torch.log(s),
            lm_rest=self.fk["lm_rest"] * s[:, None, None],
        )

    def program_inputs(self, f: dict):
        """(SequenceBatch, HandModel) of the program for the rows ``f``."""
        from absolutetrack_tpu_torch.kinematics.hand_model import HandModel
        from absolutetrack_tpu_torch.training.train import SequenceBatch

        b = f["hand_idx"].shape[0]
        batch = SequenceBatch(*(f[k] for k in SequenceBatch._fields))
        const = {k: v.expand((b,) + v.shape) for k, v in self.hand_const.items()}
        hand = HandModel(**dict(const, joint_rest_positions=f["skel_rest"], landmark_rest_positions=f["lm_rest"]))
        return batch, hand

    def reference_inputs(self, f: dict):
        hand = dict(axes=self.fk["axes"], rest=f["skel_rest"], lm_rest=f["lm_rest"], weights=self.fk["weights"])
        return f, hand


def plant(step, faults):
    """The train step with the named faults planted under it (checks of the
    check): ``frozen`` returns its state unchanged, ``half`` trains on the
    first half of the batch alone, ``altered`` doubles one leaf's gradient."""
    if not faults:
        return step

    def broken(state, batch, hand):
        import absolutetrack_tpu_torch.training.train as tr

        if "half" in faults:
            b = batch.hand_idx.shape[0] // 2
            batch = type(batch)(*(None if x is None else (x[:, :b] if x.dim() >= 2 and k in tr._TIME_MAJOR else x[:b])
                                  for k, x in zip(batch._fields, batch)))
            hand = hand.map(lambda x: x[:b])
        if "frozen" in faults:
            before = {k: p.detach().clone() for k, p in state.params.named_parameters()}
        if "altered" in faults:
            real = tr.loss_and_grads

            def doubled(*a, **kw):
                loss, metrics, grads = real(*a, **kw)
                grads = dict(grads)
                grads["backbone.stem.weight"] = grads["backbone.stem.weight"] * 2
                return loss, metrics, grads

            tr.loss_and_grads = doubled
        try:
            new, metrics = step(state, batch, hand)
        finally:
            if "altered" in faults:
                tr.loss_and_grads = real
        if "frozen" in faults:
            with torch.no_grad():
                for k, p in new.params.named_parameters():
                    p.copy_(before[k])
        return new, metrics

    return broken


class Cell:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.traffic = ctx.spec.traffic

    def setup(self):
        from absolutetrack_tpu_torch.models.layers import set_conv_precision
        from absolutetrack_tpu_torch.models.umetrack import UmeTrackModel
        from absolutetrack_tpu_torch.training.train import init_train_state, make_optimizer, make_train_step

        ctx, tr = self.ctx, self.traffic
        part = self.clock = SetupClock(ctx)
        set_conv_precision(ctx.spec.config["conv_precision"])
        params = make_params(ctx.cfg, ctx.seed, ctx.device, **ctx.spec.config["init"])
        model = UmeTrackModel(model_config(ctx.spec.config), device=ctx.device)
        load_params(model, params)
        opt = make_optimizer(tr["lr"], tr["weight_decay"], tr["clip_norm"])
        self.state = init_train_state(model, opt)
        self.step = plant(make_train_step(model.cfg, opt, branch="both"), ctx.faults)
        part("model")
        self.pool = Pool(ctx.cfg, tr, ctx.seed, ctx.device)
        part("pool")

        self.rows, losses = [], []
        for k in range(CHECKED_STEPS):
            idx = self.pool.rows(k)
            self.rows.append(idx.clone())
            self.state, metrics = self.step(self.state, *self.pool.program_inputs(self.pool.fields(idx)))
            losses.append(metrics["total"])
            if k == 0:
                mu = self.state.opt_state.inner_state.mu
                self.grad_norms = {n: float(torch.linalg.vector_norm(m / (1 - B1))) for n, m in mu.items()}
        self.losses = [float(x) for x in losses]
        self.change_norms = {n: float(torch.linalg.vector_norm(p.detach() - params[n]))
                             for n, p in self.state.params.named_parameters()}
        self.next_step = CHECKED_STEPS
        del params
        part("first_steps")

    def steps(self, n: int):
        for _ in range(n):
            self.state, _ = self.step(self.state, *self.pool.program_inputs(self.pool.fields(self.pool.rows(self.next_step))))
            self.next_step += 1

    def window(self, seconds: float) -> dict:
        tr = self.traffic
        before = int(self.state.opt_state.total_notfinite)
        t0 = time.perf_counter()
        n = 0
        while n == 0 or time.perf_counter() - t0 < seconds:
            self.steps(1)
            n += 1
        self.ctx.sync()
        elapsed = time.perf_counter() - t0
        crops = n * tr["batch"] * tr["frames"] * self.ctx.cfg["num_views"]
        failed = int(self.state.opt_state.total_notfinite) - before
        print(f"window: {n} steps of {tr['batch']} windows in {elapsed:.4f} s", flush=True)
        return dict(metrics={"train_crops_per_s": crops / elapsed}, attempted=n, failed=failed, steps=n,
                    seconds=elapsed, step_flops=train_step_flops(self.ctx.cfg, tr["batch"], tr["frames"]))

    def trace(self) -> dict:
        n = self.traffic["traced_steps"]
        with traced(self.ctx.device) as box:
            self.steps(n)
        return dict(trace=box[0], traced_steps=n)

    def release(self):
        del self.state, self.step
        if self.ctx.device == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        """Three steps of the reference from the same weights and rows."""
        ctx, tr = self.ctx, self.traffic
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        params = make_params(ctx.cfg, ctx.seed, ctx.device, **ctx.spec.config["init"])
        start = {k: v.clone() for k, v in params.items()}
        batches = [self.pool.reference_inputs(self.pool.fields(idx)) for idx in self.rows]
        hands = {id(f): h for f, h in batches}
        losses, first = ref_training.train_steps(
            ctx.cfg, params, [f for f, _ in batches], lambda f: hands[id(f)],
            lr=tr["lr"], weight_decay=tr["weight_decay"], clip=tr["clip_norm"])
        ref_grad = {k: float(torch.linalg.vector_norm(g)) for k, g in first.items()}
        ref_change = {k: float(torch.linalg.vector_norm(params[k] - start[k])) for k in params}
        med = statistics.median(ref_grad.values())
        # leaves whose gradient is nought to rounding move under Adam by round-off alone
        moving = {k for k, g in ref_grad.items() if g >= 1e-3 * med}
        lim = ctx.spec.limits
        return [
            ("loss_gap", max(abs(a - b) / abs(b) for a, b in zip(self.losses, losses)), lim["loss_gap"]),
            ("grad_gap", leaf_gap(self.grad_norms, ref_grad), lim["grad_gap"]),
            ("change_gap", leaf_gap(self.change_norms, ref_change, moving), lim["change_gap"]),
        ]
