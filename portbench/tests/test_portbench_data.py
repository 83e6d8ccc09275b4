"""The benchmark is driven by data: every cell, configuration, traffic mix,
limit file and metric reader that BENCHMARK.json names loads by its name,
and a cell added as files alone is found without a code edit."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from portbench.harness import core

BENCH = core.load_json(core.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [c["name"] for c in BENCH["workloads"]])
def test_cell_loads(workload):
    spec = core.load_spec(workload)
    assert spec.chips == 1
    assert core.kind_driver(spec.traffic["kind"]).Cell
    assert {m["name"] for m in spec.end_to_end} >= {"setup_s"} and len(spec.end_to_end) >= 2
    assert spec.per_layer, "every cell reports a per-layer metric"
    for m in spec.per_layer:
        assert callable(core.metric_reader(m["name"]))
    assert core.model_config(spec.config).input_size == tuple(spec.config["model"]["input_size"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_reader_finds_nothing_in_an_empty_record(metric):
    empty = dict(window={}, cfg={}, config={}, traffic={})
    assert core.metric_reader(metric)(empty) is None


def test_benchmark_file_keeps_the_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for c in BENCH["configs"]:
        assert (core.ROOT / c["file"]).is_file() and set(c["reduced"]) <= set(core.load_json(core.ROOT / c["file"])["reduced"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_cell_added_as_files_is_found(tmp_path):
    """A copy of the benchmark gains a traffic mix, limits, a metric reader
    and a cell by files and BENCHMARK.json entries alone."""
    shutil.copytree(core.BENCH_DIR, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = dict(BENCH)
    traffic = dict(core.load_json(core.BENCH_DIR / "traffic" / "train-pool.json"), batch=8)
    (tmp_path / "portbench" / "traffic" / "train-pool-b8.json").write_text(json.dumps(traffic))
    shutil.copy(core.BENCH_DIR / "limits" / "f32-train-pool.json", tmp_path / "portbench" / "limits" / "f32-train-b8.json")
    (tmp_path / "portbench" / "metrics" / "pool_rows.train.py").write_text(
        "def read(record):\n    return float(record['traffic']['batch'])\n")
    bench["workloads"] = BENCH["workloads"] + [dict(name="f32-train-b8", config="umetrack-f32", traffic="train-pool-b8",
                                                    chips=1, why="a small batch")]
    bench["per_layer"] = BENCH["per_layer"] + [dict(name="pool_rows.train", unit="rows", better="higher",
                                                    source="program_counter", layer="train step",
                                                    moves="train_crops_per_s", workloads=["f32-train-b8"])]
    bench["end_to_end"] = [dict(m, workloads=m["workloads"] + ["f32-train-b8"]) if m["name"] == "train_crops_per_s" else m
                           for m in BENCH["end_to_end"]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from portbench.harness import core; "
            "s = core.load_spec('f32-train-b8'); assert core.ROOT == __import__('pathlib').Path(sys.argv[1]); "
            "r = core.metric_reader('pool_rows.train'); print(s.traffic['batch'], [m['name'] for m in s.per_layer], "
            "r(dict(traffic=s.traffic)))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True, text=True, check=True)
    batch, metrics, value = out.stdout.split(" ", 1)[0], out.stdout, out.stdout.strip().rsplit(" ", 1)[-1]
    assert batch == "8" and "pool_rows.train" in metrics and value == "8.0"
