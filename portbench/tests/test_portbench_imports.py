"""Nothing the benchmark runs loads JAX or the JAX package (by whole
top-level names: the port's name begins with the JAX package's), nothing
reads the repository's older benches, and the reference imports nothing
of the program."""

import re
import subprocess
import sys
import types

from portbench.harness import core

SOURCES = [p for p in core.BENCH_DIR.rglob("*.py") if "tests" not in p.parts]


def test_whole_name_check(monkeypatch):
    before = set(core.forbidden_modules())
    for name in ("absolutetrack_tpu_torch", "absolutetrack_tpu_torchx.y", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(core.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "absolutetrack_tpu.models", types.ModuleType("absolutetrack_tpu.models"))
    assert "absolutetrack_tpu" in core.forbidden_modules()


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[2]); import pb_helpers; "
            "from portbench.harness import core; pb_helpers.run_tiny('bf16-lockstep'); "
            "pb_helpers.run_tiny('f32-train-pool'); import torch; "
            "print('LOADED', sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(core.ROOT), str(core.BENCH_DIR / "tests")],
                         capture_output=True, text=True, check=True)
    loaded = out.stdout.rsplit("LOADED", 1)[1]
    assert "absolutetrack_tpu_torch" in loaded
    for name in core.FORBIDDEN:
        assert f"'{name}'" not in loaded


def test_sources_read_no_older_bench():
    for path in SOURCES:
        text = path.read_text()
        for old in ("benchmarks/", "bench.py", "chip_smoke", "import jax", "from jax"):
            assert old not in text, f"{path} names {old}"


def test_reference_imports_nothing_of_the_program():
    for path in (core.BENCH_DIR / "reference").glob("*.py"):
        imports = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", path.read_text(), re.M)
        assert all(m.split(".")[0] in ("__future__", "math", "typing", "numpy", "torch", "") or m.startswith(".")
                   for m in imports), (path, imports)
