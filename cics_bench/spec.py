"""The benchmark's data: ``BENCHMARK.json`` at the checkout's root, and the
files it names, found by name under ``cics_bench/``:

* ``configs/<config>.json``: the program's ``SimConfig`` fields under
  ``sim``, the configuration's ``source``, what was ``assumed``, what was
  ``reduced``;
* ``workloads/<cell>.json``: the days a rollout plans, the fleets of each
  scenario that the check samples and the limits of the comparison that
  decides ``correct``;
* ``traffic/<traffic>.json``: the scenario library (``traffic.generator``);
* ``metrics/<metric>.py``: one reader a per-layer metric.
"""
from __future__ import annotations

import importlib
import json
import re
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def benchmark() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, its own
    file, its traffic and its metrics."""

    def __init__(self, name: str, bench: Dict = None):
        bench = benchmark() if bench is None else bench
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = json.loads(
            (ROOT / self.config_entry["file"]).read_text())
        self.workload = json.loads(
            (HERE / "workloads" / f"{name}.json").read_text())
        from cics_bench.traffic import generator
        self.traffic = generator.load(self.entry["traffic"])
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    @property
    def sim(self) -> Dict:
        return dict(self.config["sim"])

    @property
    def days(self) -> int:
        return int(self.workload["rollout_days"])

    @property
    def sample_per_scenario(self) -> int:
        return int(self.workload.get("sample_per_scenario", 1))

    @property
    def limits(self) -> Dict[str, float]:
        return dict(self.workload["limits"])


def module(metric: str):
    """``metrics/<metric>.py``: its ``read(run)``; ``COST``, the cost
    module of the kernel it reads, where it reads one; ``measure(ctx)``,
    where it takes a reading of its own after the traced window."""
    return importlib.import_module(f"cics_bench.metrics.{metric}")


def reader(metric: str):
    return module(metric).read


def files(bench: Dict) -> List[Path]:
    """Every file ``BENCHMARK.json`` names or the harness finds by a name
    in it."""
    out = [ROOT / c["file"] for c in bench["configs"]]
    for w in bench["workloads"]:
        out.append(HERE / "workloads" / f"{w['name']}.json")
        out.append(HERE / "traffic" / f"{w['traffic']}.json")
    for m in bench["per_layer"]:
        out.append(HERE / "metrics" / f"{m['name']}.py")
    return out
