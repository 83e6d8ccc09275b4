"""Times the unknown-skeleton calibration's Gauss-Newton fit over W windows
two ways on one device: one ``calibrate_scale_window`` call and one
readback a window (the calibration before the batched solve), and one
``calibrate_scale_windows`` call with one readback. Both fit the same
seeded windows of T frames (the smoke scene's hand, targets from
perturbed poses at per-window scales); prints one JSON line with the
median ms of each and the largest log-scale difference between them.

    python3 scripts/gn_windows_timing.py --windows 48 --frames 30 --repeats 5
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from absolutetrack_tpu_torch.kinematics import hand_model as hm  # noqa: E402
from absolutetrack_tpu_torch.kinematics.skinning import skin_landmarks  # noqa: E402
from absolutetrack_tpu_torch.models.layers import set_conv_precision  # noqa: E402
from absolutetrack_tpu_torch.ops import gauss_newton as gn  # noqa: E402


def windows(n_w: int, n_t: int, device, seed: int = 0):
    rng = np.random.default_rng(seed)
    hand = hm.hand_model_from_dict(chip_smoke.synthetic_hand_model()).to(device)
    angles = rng.uniform(-0.2, 0.8, (n_w, n_t, 22)).astype(np.float32)
    wrist = np.broadcast_to(np.eye(4, dtype=np.float32), (n_w, n_t, 4, 4)).copy()
    wrist[..., :3, 3] = rng.uniform(-100, 100, (n_w, n_t, 3))
    scale = rng.uniform(0.85, 1.15, (n_w, n_t)).astype(np.float32)
    angles, wrist, scale = (torch.as_tensor(x, device=device) for x in (angles, wrist, scale))
    targets = skin_landmarks(hm.scaled_hand_model(hand.map(lambda x: x.expand((n_w, n_t) + x.shape)), scale),
                             angles, wrist)
    init = angles + torch.as_tensor(rng.uniform(-0.05, 0.05, angles.shape).astype(np.float32), device=device)
    return hand, targets, init, wrist, torch.ones(n_w, n_t, device=device)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--windows", type=int, default=48)
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    set_conv_precision("highest")
    hand, targets, init, wrist, mask = windows(args.windows, args.frames, args.device)

    def sync():
        if args.device == "cuda":
            torch.cuda.synchronize()

    def loop():
        return [float(gn.calibrate_scale_window(hand, targets[w], init[w], wrist[w], mask[w]).log_scale.cpu())
                for w in range(args.windows)]

    def batched():
        return gn.calibrate_scale_windows(hand, targets, init, wrist, mask).log_scale.cpu().tolist()

    out = {}
    for name, fn in (("loop", loop), ("batched", batched), ("loop", loop), ("batched", batched)):
        fn()  # warm-up
        times = []
        for _ in range(args.repeats):
            sync()
            t0 = time.perf_counter()
            got = fn()
            times.append((time.perf_counter() - t0) * 1e3)
        out.setdefault(name + "_ms", []).extend(times)
        out[name] = got
    gap = max(abs(a - b) for a, b in zip(out.pop("loop"), out.pop("batched")))
    line = dict(windows=args.windows, frames=args.frames, device=args.device,
                kind=torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu",
                loop_ms_median=statistics.median(out["loop_ms"]),
                batched_ms_median=statistics.median(out["batched_ms"]), log_scale_max_gap=gap, **out)
    print(json.dumps(line))


if __name__ == "__main__":
    main()
