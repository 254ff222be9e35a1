"""The benchmark's data and isolation: every file ``BENCHMARK.json`` names
loads, names and units keep to their characters, the harness holds no
cell, configuration or metric name, nothing the benchmark runs imports the
JAX package (top-level names compared whole), the reference and the
traffic import nothing of the program, and ``run.py`` gives no result
without a card."""
import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from cics_bench import check, spec

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _imports(path):
    """Top-level module names a source file imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_every_named_file_loads():
    for path in spec.files(BENCH):
        assert path.is_file(), path
        if path.suffix == ".json":
            json.loads(path.read_text())
    for m in BENCH["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for w in BENCH["workloads"]:
        cell = spec.Cell(w["name"], BENCH)
        assert cell.days >= 1 and set(cell.limits) <= set(check.NUMBERS)
        assert {"start", "handoff", "step_p95", "ledger_p95", "split_days",
                "gate_flips"} <= set(cell.limits)
        assert cell.traffic["scenarios"]


def test_names_units_and_keys():
    names = [c["name"] for c in BENCH["configs"]] \
        + [w["name"] for w in BENCH["workloads"]] \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_the_harness_names_no_cell_config_or_metric():
    text = "".join((HERE / f).read_text() for f in
                   ("run.py", "harness.py", "spec.py", "check.py",
                    "trace.py"))
    names = [c["name"] for c in BENCH["configs"]] \
        + [w["name"] for w in BENCH["workloads"]] \
        + [w["traffic"] for w in BENCH["workloads"]] \
        + [m["name"] for m in BENCH["per_layer"] + BENCH["end_to_end"]]
    assert not [n for n in names if n in text]


def test_no_source_imports_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path
    for sub in ("reference", "traffic", "costs"):
        for path in (HERE / sub).rglob("*.py"):
            assert "repro_torch" not in _imports(path), path


def _python(code, cwd=ROOT, env_extra=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "BENCH_RUN")}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_nothing_the_benchmark_loads_imports_jax_or_the_program():
    code = (
        "import sys; sys.path[:0] = ['.', 'src']\n"
        "import cics_bench.reference.day, cics_bench.traffic.generator\n"
        "import cics_bench.check\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'repro_torch' not in tops, 'reference loads the program'\n"
        "import cics_bench.harness, cics_bench.trace, cics_bench.spec\n"
        "from cics_bench import spec\n"
        "for m in spec.benchmark()['per_layer']: spec.reader(m['name'])\n"
        "import repro_torch.sim.engine, repro_torch.kernels.vcc_pgd.kernel\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'repro'}))\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("where", ["checkout", "benchmark_alone"])
def test_run_gives_no_result_without_a_card_or_the_program(where,
                                                           tmp_path):
    cwd = ROOT
    if where == "benchmark_alone":
        shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
        shutil.copytree(HERE, tmp_path / "cics_bench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        cwd = tmp_path
    out = subprocess.run(
        [sys.executable, "cics_bench/run.py", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "2147483653",
         "--seconds", "1", "--trace", "0"], cwd=cwd,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "No result" in out.stderr or "missing" in out.stderr
