"""The port's benchmark: one cell of ``BENCHMARK.json`` on this machine's card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Sets up the cell (weights and inputs made on the card from the seed, every
shape warmed up), measures for ``--seconds``, checks what the timed path
produced against the plain reference in ``portbench/reference/``, and
prints one JSON line last on standard output: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics from a
traced stretch. Exits 2 without a result when there is no card (or fewer
than the cell asks for), and 3 when the port loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.harness import core  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    core.set_cache_dirs()
    spec = core.load_spec(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {spec.chips} CUDA device(s), this machine has {n}", file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    line, checks = core.run_cell(spec, args.seed, args.seconds, bool(args.trace), T_START)
    print(f"device {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}, "
          f"power limit {core.power_limit()}", file=sys.stderr)
    bad = core.forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {bad}; the port may not", file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r} {'ok' if value <= limit else 'FAIL'}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
