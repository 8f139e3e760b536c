"""The benchmark's manifest, ``BENCHMARK.json`` at the root of the
checkout, and the files it names.

Everything a cell needs is found by name: its configuration in
``portbench/configs/<config>.json``, its traffic mix in
``portbench/traffic/<traffic>.json``, the limits its output check holds
in ``portbench/limits/<workload>.json``, each per-layer metric's reader
in ``portbench/metrics/<metric>.py`` and each kernel's count of
operations and bytes in ``portbench/counts/<kernel>.py``.  A new cell,
configuration, metric or count is a new file and a new entry, never an
edit.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: Optional[tuple]
    layer: str = ""
    moves: str = ""
    bound: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    chips: int
    why: str


def _load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def traffic_file(name: str) -> Dict:
    return _load_json(HERE / "traffic" / f"{name}.json")


def limits_file(workload: str) -> Dict:
    return _load_json(HERE / "limits" / f"{workload}.json")


class Manifest:
    """``BENCHMARK.json`` read and checked for the names the harness
    looks files up by."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.raw = _load_json(self.root / "BENCHMARK.json")
        self.cells = {w["name"]: Cell(w["name"], w["config"], w["traffic"],
                                      int(w["chips"]), w["why"])
                      for w in self.raw["workloads"]}
        self.configs = {c["name"]: c for c in self.raw["configs"]}
        self.end_to_end = [Metric(m["name"], m["unit"], m["better"],
                                  m["source"], _tuple(m.get("workloads")),
                                  bound=m["bound"])
                           for m in self.raw["end_to_end"]]
        self.per_layer = [Metric(m["name"], m["unit"], m["better"],
                                 m["source"], _tuple(m.get("workloads")),
                                 layer=m["layer"], moves=m["moves"])
                          for m in self.raw["per_layer"]]

    def cell(self, name: str) -> Cell:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                           f"{sorted(self.cells)}")
        return self.cells[name]

    def config(self, cell: Cell) -> Dict:
        return _load_json(self.root / self.configs[cell.config]["file"])

    def traffic(self, cell: Cell) -> Dict:
        return traffic_file(cell.traffic)

    def limits(self, cell: Cell) -> Dict:
        return limits_file(cell.name)

    def end_to_end_for(self, cell: Cell) -> List[Metric]:
        return [m for m in self.end_to_end
                if m.workloads is None or cell.name in m.workloads]

    def per_layer_for(self, cell: Cell) -> List[Metric]:
        """The per-layer metrics this cell reports: those that list it,
        and those without a list whose end-to-end metric it reports."""
        reported = {m.name for m in self.end_to_end_for(cell)}
        return [m for m in self.per_layer
                if (cell.name in m.workloads if m.workloads is not None
                    else m.moves in reported)]


def _tuple(x) -> Optional[tuple]:
    return None if x is None else tuple(x)


def load_file(folder: str, name: str):
    """The module of ``portbench/<folder>/<name>.py``, loaded from its
    file (a name may hold dots)."""
    path = HERE / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.{folder}." + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(name: str):
    """The module of ``portbench/metrics/<name>.py``: it declares
    ``LAYER``, ``UNIT``, ``SOURCE`` and ``MOVES``, optionally ``RANGES``
    (the profiler ranges it reads: a name with a file in
    ``portbench/counts`` wraps that file's entry point), and defines
    ``read(run)``, which returns the metric's value or None where the run
    holds nothing for it to read."""
    return load_file("metrics", name)
