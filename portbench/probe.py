"""Measurements that set the benchmark's parameters; the benchmark's own
runs never run them.

    python3 portbench/probe.py sweep --workload f32-train-pool --batches 128 256 512 1024
    python3 portbench/probe.py readings --workload f32-train-pool --seeds 1 2 3 --control --faults half altered

``sweep`` runs a training cell's set-up and a traced stretch of steps at
each batch size: step ms, device idle share and peak memory. ``readings``
runs set-up and the check (no window) on each seed, for the program as
configured, then for the control (a training cell: the program with TF32
on, its own lower-precision path; an eval cell: the plain reference one
precision step below the configuration's trunk in the program's place,
``lockstep.control_precision``) and for each named
fault planted in the program; it prints one JSON line a run.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.harness import core  # noqa: E402


def emit(out, **row):
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def sweep(args):
    import torch

    from portbench.harness.trace import traced

    for b in args.batches:
        spec = core.load_spec(args.workload)
        spec.traffic["batch"] = b
        cell = core.kind_driver(spec.traffic["kind"]).Cell(core.Context(spec, args.seed))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            cell.setup()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cell.steps(args.steps)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) / args.steps * 1e3
            with traced("cuda") as box:
                cell.steps(args.steps)
            tr = box[0]
            emit(args.out, batch=b, step_ms=step_ms, crops_per_s=b * spec.traffic["frames"] * 2 / step_ms * 1e3,
                 idle_share=1 - tr.busy_s / tr.window_s, traced_step_ms=tr.window_s / args.steps * 1e3,
                 kernels_per_step=tr.kernels / args.steps, peak_bytes=torch.cuda.max_memory_allocated(),
                 setup=cell.clock.parts)
        except torch.cuda.OutOfMemoryError as e:
            emit(args.out, batch=b, error=str(e)[:200])
        finally:
            for name in ("state", "step", "pool"):
                if hasattr(cell, name):
                    delattr(cell, name)


def readings(args):
    import torch

    runs = [("sound", s, ()) for s in args.seeds]
    if args.control:
        runs += [("control", s, ()) for s in args.control_seeds]
    runs += [(f"fault:{f}", s, (f,)) for f in args.faults for s in args.control_seeds]
    for what, seed, faults in runs:
        spec = core.load_spec(args.workload)
        kind = spec.traffic["kind"]
        if what == "control" and kind == "train_pool":
            spec.config["conv_precision"] = "high"  # the program's TF32 path
        cell = core.kind_driver(kind).Cell(core.Context(spec, seed, faults=faults))
        t0 = time.perf_counter()
        cell.setup()
        cell.release()
        if what == "control" and kind == "lockstep":
            cell.put_control()
        checks = cell.check()
        emit(args.out, workload=args.workload, run=what, seed=seed, seconds=time.perf_counter() - t0,
             checks={n: v for n, v, _ in checks})
        del cell
        torch.cuda.empty_cache()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("what", choices=("sweep", "readings"))
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=20261018)
    p.add_argument("--batches", type=int, nargs="*", default=[128, 256, 512, 1024])
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control", action="store_true")
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--out", default=None, help="append each JSON line to this file too")
    args = p.parse_args(argv)
    core.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    print(f"device {torch.cuda.get_device_name(0)}, power limit {core.power_limit()}", file=sys.stderr)
    spec = core.load_spec(args.workload)
    core.kind_driver(spec.traffic["kind"])
    (sweep if args.what == "sweep" else readings)(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
