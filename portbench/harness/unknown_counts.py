"""Model FLOPs of one pass of the unknown-skeleton protocol, from the
configuration's shapes through ``counts.py``: each hand of each pass-1
frame through the trunk, the fusion, the memory and the unknown-skeleton
head; each pass-2 frame as a frame of the known-skeleton eval. The
calibration's Gauss-Newton solve is left out (it is no model work), as is
what ``counts.py`` leaves out, so a share of a peak is a lower bound."""

from __future__ import annotations

from .counts import eval_frame_flops, sample_flops


def protocol_flops(cfg: dict, recordings: int, calib_frames: int, frames: int) -> int:
    calib = recordings * min(calib_frames, frames) * 2 * sample_flops(cfg, known=False, unknown=True)
    return calib + recordings * frames * eval_frame_flops(cfg)
