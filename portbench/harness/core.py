"""The harness: finds a cell's configuration, traffic, limits and metric
readers by the names in ``BENCHMARK.json``, runs the cell's kind of work,
and builds the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own under ``portbench/``:
``configs/<config>.json``, ``traffic/<traffic>.json`` (its ``kind`` names
the driver in ``harness/kinds/``), ``limits/<workload>.json`` and
``metrics/<metric>.py`` (a ``read(record)`` that returns a number or None).
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
CACHE_DIR = ROOT / ".portbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "absolutetrack_tpu")

Check = Tuple[str, float, float]  # name, value, limit (a value above its limit fails)


def set_cache_dirs() -> None:
    """Fixed build and kernel-cache directories inside the checkout, set
    before anything imports torch."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE_DIR / sub)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Spec:
    """A cell as ``BENCHMARK.json`` and its data files give it."""

    workload: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def load_spec(workload: str, root: Path = ROOT) -> Spec:
    bench = load_json(root / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[cell["config"]]["file"])
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Spec(
        workload=workload,
        chips=cell["chips"],
        config=config,
        traffic=load_json(root / "portbench" / "traffic" / f"{cell['traffic']}.json"),
        limits=load_json(root / "portbench" / "limits" / f"{workload}.json"),
        end_to_end=e2e,
        per_layer=layer,
    )


def model_config(config: dict):
    """The program's ``ModelConfig`` with the configuration file's fields."""
    from absolutetrack_tpu_torch.models.config import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in config["model"].items() if k in fields}
    return ModelConfig(**kw)


def kind_driver(name: str):
    return importlib.import_module(f"portbench.harness.kinds.{name}")


def metric_reader(name: str) -> Callable[[dict], Optional[float]]:
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclasses.dataclass
class Context:
    """What a kind's driver gets: the cell, its seed and device, and the
    faults planted under it (tests and probes only)."""

    spec: Spec
    seed: int
    device: str = "cuda"
    faults: Tuple[str, ...] = ()

    @property
    def cfg(self) -> dict:
        """The configuration's model sizes (the reference's dict)."""
        return self.spec.config["model"]

    def sync(self) -> None:
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()


class SetupClock:
    """Seconds of each named part of a set-up, the device synchronised at each part's end."""

    def __init__(self, ctx: "Context"):
        self.ctx = ctx
        self.parts = {}
        self.last = time.perf_counter()

    def __call__(self, name: str) -> None:
        self.ctx.sync()
        now = time.perf_counter()
        self.parts[name] = round(now - self.last, 4)
        self.last = now


def load_params(model, params) -> None:
    """The benchmark's weights into the program's model, name for name."""
    import torch

    named = dict(model.named_parameters())
    if set(named) != set(params):
        raise RuntimeError(f"parameter names differ: {sorted(set(named) ^ set(params))[:8]}")
    with torch.no_grad():
        for k, p in named.items():
            if p.shape != params[k].shape:
                raise RuntimeError(f"{k}: the program's {tuple(p.shape)}, the configuration's {tuple(params[k].shape)}")
            p.copy_(params[k])


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the port may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", faults: Tuple[str, ...] = ()) -> Tuple[dict, List[Check]]:
    """Set up, measure, trace, check -> (the result line's dict, the checks)."""
    import torch

    from absolutetrack_tpu_torch.ops import warp_kernel

    warp_kernel.BUILD_DIR = CACHE_DIR / "k1"  # the program's K1 build, at the benchmark's fixed path
    ctx = Context(spec, seed, device, faults)
    cell = kind_driver(spec.traffic["kind"]).Cell(ctx)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cell.setup()
    ctx.sync()
    setup_s = time.perf_counter() - t_start
    print(f"setup_s {setup_s:.4f}: {json.dumps(cell.clock.parts)}", file=sys.stderr)
    window = cell.window(seconds)
    record = dict(window=window, cfg=ctx.cfg, config=spec.config, traffic=spec.traffic)
    if trace:
        record.update(cell.trace())
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    cell.release()
    checks = cell.check()

    if trace:
        metrics = {}
        for m in spec.per_layer:
            value = metric_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(window["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in spec.end_to_end}
    dev = dict(
        platform="gpu" if device == "cuda" else device,
        kind=torch.cuda.get_device_name(0) if device == "cuda" else device,
        count=spec.chips,
        memory_peak_bytes=int(peak),
    )
    line = dict(correct=all(v <= lim for _, v, lim in checks), attempted=window["attempted"],
                failed=window["failed"], metrics=metrics, device=dev)
    tr = record.get("trace")
    if trace and tr is not None and tr.busy_s > 0:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = dict(device_ops=tr.top_ops(), idle_gaps=tr.idle_gaps())
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return line, checks


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().replace("\n", "; ") or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"
