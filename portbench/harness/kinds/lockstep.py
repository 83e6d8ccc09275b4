"""The pose-driven lockstep evaluation over a set of recordings.

Set-up builds one seeded scene (the frozen rig, hand and uint8 frames)
of ``recordings + frames - 1`` frames; recording r is frames r..r+frames-1
(the program reads them through its label parser, as host numpy frames),
draws the weights on the card and runs one warm-up pass. A pass is
``apps.eval_lib.track_recordings_batched(pipelined=True)`` over every
recording in chunks of ``chunk`` frames; the window repeats whole passes.
The check tracks a seeded sample of the last pass's recordings with the
plain reference and compares validity, landmarks and joint angles.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from ...reference import tracking as ref_tracking
from ...reference.network import make_params
from .. import scene as scn
from ..core import Context, SetupClock, load_params, model_config
from ..counts import eval_frame_flops
from ..trace import traced


def plant(faults):
    """Patch the program with the named faults (checks of the check):
    ``frozen`` keeps the tracker's state unchanged, ``half`` leaves the
    second half of each chunk's samples out of the crops, ``altered`` adds
    0.3 rad to the joint angles of each recording's left hand in its first
    frame. Returns the undo."""
    import absolutetrack_tpu_torch.tracker.batched as batched

    cls = batched.BatchedTracker
    saved = {k: getattr(cls, k) for k in ("_finish", "make_inputs")}

    def finish(self, state, new_temporal, slots, out):
        new_state, res = saved["_finish"](self, state, new_temporal, slots, out)
        if "frozen" in faults:
            new_state = state
        if "altered" in faults and not state.valid_history.any():
            # the first frame's answer for each recording's left hand
            res = res._replace(joint_angles=res.joint_angles + torch.tensor([0.3, 0.0], device=res.joint_angles.device)[:, None])
        return new_state, res

    def make_inputs(self, *a, **kw):
        frame = saved["make_inputs"](self, *a, **kw)
        if "half" in faults:
            half = frame.left_images.shape[0] // 2
            frame = frame._replace(left_images=torch.cat([frame.left_images[:half],
                                                          torch.zeros_like(frame.left_images[half:])]))
        return frame

    cls._finish, cls.make_inputs = finish, make_inputs

    def undo():
        for k, v in saved.items():
            setattr(cls, k, v)

    return undo


def sample(traffic: dict, seed: int):
    """The recordings that the check compares, drawn from the seed."""
    rng = np.random.default_rng(seed % 2**64)
    return sorted(rng.choice(traffic["recordings"], size=traffic["check_recordings"], replace=False).tolist())


def control_precision(cfg: dict) -> dict:
    """The control's arguments to the reference tracker: one precision step
    below the configuration's trunk, with bf16 sampler rows. Under a bf16
    trunk every conv runs in float8 e4m3; under an f32 one the trunk runs
    in bf16."""
    return dict(trunk_dtype=torch.bfloat16, bf16_rows=True, fp8=cfg["compute_dtype"] == "bfloat16")


def as_result(ref: dict) -> SimpleNamespace:
    """The reference's (F, 2, ...) tensors in the eval driver's hands-major layout."""
    def hm(x):
        return np.moveaxis(x.cpu().numpy(), 0, 1)

    return SimpleNamespace(valid_tracking=hm(ref["valid"]), tracked_keypoints=hm(ref["landmarks"]),
                           joint_angles=hm(ref["angles"]))


class Cell:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.traffic = ctx.spec.traffic
        self.undo = None

    def setup(self):
        from absolutetrack_tpu_torch.models.layers import set_conv_precision
        from absolutetrack_tpu_torch.models.umetrack import UmeTrackModel

        ctx, tr = self.ctx, self.traffic
        part = self.clock = SetupClock(ctx)
        r, f = tr["recordings"], tr["frames"]
        self.scene = scn.build_scene(ctx.seed, r + f - 1)
        self.recordings = scn.scene_recordings(self.scene, range(r), f)
        part("scene")
        set_conv_precision(ctx.spec.config["conv_precision"])
        self.model = UmeTrackModel(model_config(ctx.spec.config), device=ctx.device)
        load_params(self.model, make_params(ctx.cfg, ctx.seed, ctx.device, **ctx.spec.config["init"]))
        part("model")
        if ctx.faults:
            self.undo = plant(ctx.faults)
        self.results = self._pass()
        part("warm_up_pass")

    def _pass(self, **kw):
        from absolutetrack_tpu_torch.apps import eval_lib

        return eval_lib.track_recordings_batched(self.model, self.recordings, chunk_size=self.traffic["chunk"],
                                                 pipelined=True, **kw)

    def window(self, seconds: float) -> dict:
        tr = self.traffic
        t0 = time.perf_counter()
        passes = failed = 0
        ends = []
        while passes == 0 or time.perf_counter() - t0 < seconds:
            self.results = self._pass()
            ends.append(time.perf_counter())
            passes += 1
            failed += sum(1 for res in self.results
                          if not (np.isfinite(res.tracked_keypoints).all() and res.valid_tracking.all()))
        self.ctx.sync()
        elapsed = time.perf_counter() - t0
        frames = passes * tr["recordings"] * tr["frames"]
        print(f"window: {passes} passes of {tr['recordings']} x {tr['frames']} frames in {elapsed:.4f} s; each pass "
              f"{[round(b - a, 4) for a, b in zip([t0] + ends, ends)]} s", flush=True)
        return dict(metrics={"frames_per_s": frames / elapsed}, attempted=passes * tr["recordings"], failed=failed,
                    frames=frames, seconds=elapsed, frame_flops=eval_frame_flops(self.ctx.cfg))

    def trace(self) -> dict:
        """One pass under the profiler, and the crop sampler's bytes."""
        from absolutetrack_tpu_torch.ops import warp_kernel

        ctx = self.ctx
        with traced(ctx.device) as box:
            self._pass()

        calls = []
        kernel = warp_kernel.K1

        def record(images, image_idx, x, y, src_valid_hw=None, row_mode=0):
            n, p = x.shape[0], x.shape[1:].numel()
            calls.append((n, p, scn.touched_source_bytes(images, image_idx, x, y, src_valid_hw or images.shape[1:])))
            return kernel(images, image_idx, x, y, src_valid_hw, row_mode)

        if ctx.device == "cuda":
            warp_kernel.K1 = record
            try:
                self._pass()
            finally:
                warp_kernel.K1 = kernel
        return dict(trace=box[0], k1_calls=calls)

    def release(self):
        del self.model
        if self.undo is not None:
            self.undo()
        if self.ctx.device == "cuda":
            torch.cuda.empty_cache()

    def put_control(self):
        """The control's results in place of the program's for the sampled
        recordings (probes and the control's test, after set-up)."""
        ctx, tr = self.ctx, self.traffic
        params = make_params(ctx.cfg, ctx.seed, ctx.device, **ctx.spec.config["init"])
        for r in sample(tr, ctx.seed):
            rec = scn.reference_recording(self.scene, r, tr["frames"], ctx.device)
            self.results[r] = as_result(ref_tracking.track(ctx.cfg, params, rec, **control_precision(ctx.cfg)))

    def check(self):
        """The reference over a seeded sample of the recordings."""
        ctx, tr = self.ctx, self.traffic
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        params = make_params(ctx.cfg, ctx.seed, ctx.device, **ctx.spec.config["init"])
        bf16 = ctx.cfg["compute_dtype"] == "bfloat16"
        mismatch, lm, ang = 0, [], []
        for r in sample(tr, ctx.seed):
            rec = scn.reference_recording(self.scene, r, tr["frames"], ctx.device)
            ref = as_result(ref_tracking.track(ctx.cfg, params, rec, torch.bfloat16 if bf16 else torch.float32, bf16))
            got = self.results[r]
            mismatch += int((ref.valid_tracking != got.valid_tracking).sum())
            both = ref.valid_tracking & got.valid_tracking
            lm.append(np.where(both[..., None], np.linalg.norm(ref.tracked_keypoints - got.tracked_keypoints, axis=-1),
                               np.nan))
            ang.append(np.where(both[..., None], np.abs(ref.joint_angles - got.joint_angles)[..., :20], np.nan))
        lm, ang = np.stack(lm), np.stack(ang)  # (recordings, hands, frames, points)
        lim = ctx.spec.limits
        return [
            ("valid_mismatch", float(mismatch), lim["valid_mismatch"]),
            ("landmark_mean_mm", float(np.nanmean(lm)), lim["landmark_mean_mm"]),
            ("angle_max_rad", float(np.nanmax(ang)), lim["angle_max_rad"]),
        ]
