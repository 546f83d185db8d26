"""Finding a cell's files by name: ``BENCHMARK.json`` at the root of the
checkout names the cells, their configurations and metrics; the
configuration's file, ``traffic/<traffic>.json``, ``checks/<cell>.json``
and ``metrics/<metric>.py`` beside this module hold the rest.  Adding a
configuration, a traffic mix, a cell or a metric adds files and entries,
and edits none."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_name = "perfbench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict = None) -> Dict:
    """Everything a run of cell ``name`` reads: the cell's entry, its
    configuration (the file's JSON), its traffic mix, its limits, and its
    metrics with ``--trace 0`` (``end_to_end``) and ``--trace 1``
    (``per_layer``), each (name, unit)."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; choose "
                       f"from {sorted(by_name)}")
    entry = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    return {
        "name": name,
        "chips": entry["chips"],
        "config": load_json(ROOT / conf["file"]),
        "mix": load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        "limits": load_json(HERE / "checks" / f"{name}.json"),
        "metrics": {
            0: [(m["name"], m["unit"]) for m in bench["end_to_end"]
                if _applies(m, name)],
            1: [(m["name"], m["unit"]) for m in bench["per_layer"]
                if _applies(m, name)],
        },
    }
