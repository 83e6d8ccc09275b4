"""The unknown-skeleton protocol in lockstep over a set of recordings.

Set-up is the ``lockstep`` kind's (one seeded scene, recording r its
frames r..r+frames-1, the weights drawn on the card, one warm-up pass); the
scene's hand is the generic skeleton. The weights are the configuration's
``init`` with two of the unknown-skeleton head's outputs rescaled
(``weights``): the log-scale times ``init.scale_output``, so that the
calibrated scales lie near 1, as a trained model's do, and the finger
angles times ``init.angle_output``, so that pass 1's poses differ from
frame to frame and the Gauss-Newton fit, which weights each frame by its
pose, departs from a plain mean of the scales. A pass is
``apps.eval_lib.track_recordings_unknown_skeleton`` over every recording:
pass 1 over the first 30 frames (the configuration's ``calib_frames``)
through the unknown-skeleton head, one calibration of the scales (its
``calib_mode``),
pass 2 over every frame on each recording's scaled skeleton; the window
repeats whole passes and counts each recording frame once a pass. The
check runs the plain reference's protocol over a seeded sample of the last
pass's recordings and compares the calibrated scales (``scale_gap``), the
calibration alone (``calib_gap``: the reference's dense Gauss-Newton on
the program's own pass-1 outputs against the program's scale) and pass 2's
validity, landmarks and joint angles, the reference's pass 2 tracking on
the program's calibrated skeleton, so that pass 2 is held as the
``lockstep`` kind holds a pass and the scale by the two gaps alone. The faults are the ``lockstep``
kind's, planted under both passes, and ``mean``, the mean of the per-frame
scales in the calibration's place.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ...reference import unknown_skeleton as ref_unknown
from ...reference.network import make_params
from .. import scene as scn
from ..core import Context, SetupClock, load_params, model_config
from ..unknown_counts import protocol_flops
from . import lockstep


def weights(ctx: Context) -> dict:
    """The seeded weights, ``regressor_u``'s log-scale output scaled by
    ``init.scale_output`` and its 20 finger-angle outputs by
    ``init.angle_output``. At random init the calibrated scales read 0.2 to
    9 over seeds, and a skeleton 9 times too large leaves every crop; the
    angles move by 0.02-0.15 rad from frame to frame, too little to weight
    the frames of a window apart."""
    init = dict(ctx.spec.config["init"])
    scale_output, angle_output = init.pop("scale_output"), init.pop("angle_output")
    params = make_params(ctx.cfg, ctx.seed, ctx.device, **init)
    k = 20 + 3 * ctx.cfg["n_wrist_rigid_pts"]
    for name in ("regressor_u.out.weight", "regressor_u.out.bias"):
        params[name][k] *= scale_output
        params[name][:20] *= angle_output
    return params


def as_calibration(ref: dict) -> SimpleNamespace:
    """The reference's pass-1 dict of (F, 2, ...) in the eval driver's hands-major layout."""
    def hm(x):
        return np.moveaxis(x.cpu().numpy(), 0, 1)

    return SimpleNamespace(valid_tracking=hm(ref["valid"]), joint_angles=hm(ref["angles"]),
                           wrist_xfs=hm(ref["wrist_mm"]), predicted_scales=hm(ref["scale"]))


def calibration_inputs(calib, device) -> dict:
    """The eval driver's pass 1 of one recording as the reference's pass-1 dict."""
    def fm(x):
        return torch.as_tensor(np.moveaxis(np.asarray(x), 0, 1), device=device)

    return dict(valid=fm(calib.valid_tracking), angles=fm(calib.joint_angles).float(),
                wrist_mm=fm(calib.wrist_xfs).float(), scale=fm(calib.predicted_scales).float())


class Cell(lockstep.Cell):
    def __init__(self, ctx: Context):
        from absolutetrack_tpu_torch.apps import eval_lib

        if not hasattr(eval_lib, "track_recordings_unknown_skeleton"):
            raise SystemExit("portbench: the program has no apps.eval_lib.track_recordings_unknown_skeleton")
        super().__init__(ctx)
        self.protocol = ctx.spec.config["protocol"]
        self.scales = self.calibration = None

    def setup(self):
        from absolutetrack_tpu_torch.models.layers import set_conv_precision
        from absolutetrack_tpu_torch.models.umetrack import UmeTrackModel

        ctx, tr = self.ctx, self.traffic
        part = self.clock = SetupClock(ctx)
        self.scene = scn.build_scene(ctx.seed, tr["recordings"] + tr["frames"] - 1)
        self.recordings = scn.scene_recordings(self.scene, range(tr["recordings"]), tr["frames"])
        part("scene")
        set_conv_precision(ctx.spec.config["conv_precision"])
        self.model = UmeTrackModel(model_config(ctx.spec.config), device=ctx.device)
        load_params(self.model, weights(ctx))
        part("model")
        if ctx.faults:
            self.undo = lockstep.plant(ctx.faults)
        self.results = self._pass()
        part("warm_up_pass")

    def _pass(self):
        from absolutetrack_tpu_torch.apps import eval_lib

        mode = "mean" if "mean" in self.ctx.faults else self.protocol["calib_mode"]
        run = eval_lib.track_recordings_unknown_skeleton(
            self.model, lambda: self.recordings, self.recordings[0][0].hand_model, mode,
            chunk_size=self.traffic["chunk"])
        self.scales, self.calibration = run.scales, run.calibration
        return run.results

    def window(self, seconds: float) -> dict:
        out = super().window(seconds)
        tr = self.traffic
        out["protocol_flops"] = protocol_flops(self.ctx.cfg, tr["recordings"], self.protocol["calib_frames"],
                                               tr["frames"])
        out["passes"] = out["frames"] // (tr["recordings"] * tr["frames"])
        return out

    def _reference(self, rec: dict, params, **precision):
        p = self.protocol
        return ref_unknown.protocol(self.ctx.cfg, params, rec, p["calib_frames"], p["gn_iters"], p["gn_damping"],
                                    **precision)

    def put_control(self):
        """The control's pass 1, scales and pass-2 results in place of the
        program's for the sampled recordings (probes and the control's test,
        after set-up)."""
        ctx = self.ctx
        params = weights(ctx)
        for r in lockstep.sample(self.traffic, ctx.seed):
            rec = scn.reference_recording(self.scene, r, self.traffic["frames"], ctx.device)
            self.scales[r], calib, ref = self._reference(rec, params, **lockstep.control_precision(ctx.cfg))
            self.calibration[r], self.results[r] = as_calibration(calib), lockstep.as_result(ref)

    def check(self):
        """The reference's protocol over a seeded sample of the recordings."""
        ctx = self.ctx
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        params = weights(ctx)
        bf16 = ctx.cfg["compute_dtype"] == "bfloat16"
        p = self.protocol
        gap, calib_gap, mismatch, lm, ang = 0.0, 0.0, 0, [], []
        for r in lockstep.sample(self.traffic, ctx.seed):
            rec = scn.reference_recording(self.scene, r, self.traffic["frames"], ctx.device)
            scale, _, ref = self._reference(rec, params, trunk_dtype=torch.bfloat16 if bf16 else torch.float32,
                                            bf16_rows=bf16, track_scale=self.scales[r])
            log_s = float(np.log(self.scales[r]))
            gap = max(gap, abs(log_s - float(np.log(scale))))
            own, _ = ref_unknown.calibrate(rec["hand"], calibration_inputs(self.calibration[r], ctx.device),
                                           p["gn_iters"], p["gn_damping"])
            calib_gap = max(calib_gap, abs(log_s - float(np.log(own))))
            ref, got = lockstep.as_result(ref), self.results[r]
            mismatch += int((ref.valid_tracking != got.valid_tracking).sum())
            both = ref.valid_tracking & got.valid_tracking
            lm.append(np.where(both[..., None], np.linalg.norm(ref.tracked_keypoints - got.tracked_keypoints, axis=-1),
                               np.nan))
            ang.append(np.where(both[..., None], np.abs(ref.joint_angles - got.joint_angles)[..., :20], np.nan))
        lm, ang = np.stack(lm), np.stack(ang)
        lim = ctx.spec.limits
        return [
            ("scale_gap", gap, lim["scale_gap"]),
            ("calib_gap", calib_gap, lim["calib_gap"]),
            ("valid_mismatch", float(mismatch), lim["valid_mismatch"]),
            ("landmark_mean_mm", float(np.nanmean(lm)), lim["landmark_mean_mm"]),
            ("angle_max_rad", float(np.nanmax(ang)), lim["angle_max_rad"]),
        ]
