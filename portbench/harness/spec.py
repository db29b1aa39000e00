"""What a run is: a workload of ``BENCHMARK.json`` and the files the
harness finds by name -- its configuration (``portbench/configs/``), its
traffic mix (``portbench/traffic/``), its limits of correctness
(``portbench/limits/<workload>.json``) -- and the readers of its metrics
(``portbench/metrics/<metric>.py``), the work formulas of its model family
(``portbench/work/``), of its kernels (``portbench/kernels/``) and its
plain reference (``portbench/reference/``).  A later cell, mix, metric or
kernel is a new file and a new entry, never an edit of a file here.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import sys
from dataclasses import dataclass

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def read_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    mod_name = f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def name(self) -> str:
        return self.workload["name"]

    def metrics(self, trace: bool) -> list[dict]:
        """The metrics this cell reports in a run with or without the
        trace: those that list it, or that list no cells."""
        group = self.per_layer if trace else self.end_to_end
        return [m for m in group
                if self.name in m.get("workloads", [self.name])]


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else read_json(ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        if w["name"] == name:
            break
    else:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(workload=w, config=read_json(ROOT / conf["file"]),
                traffic=read_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                limits=read_json(BENCH / "limits" / f"{name}.json"),
                end_to_end=bench["end_to_end"], per_layer=bench["per_layer"])
