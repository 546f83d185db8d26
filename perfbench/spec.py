"""Finding a cell's files by name.  ``BENCHMARK.json`` at the root of the
checkout names the cells, their configurations and metrics; the files
beside this module hold the rest, each found by the name that the
configuration or ``BENCHMARK.json`` gives it:

- ``traffic/<traffic>.json``: a traffic mix's parameters, which
  :mod:`perfbench.traffic` reads;
- ``checks/<cell>.json``: a cell's limit and the readings it was set
  from;
- ``metrics/<metric>.py``: a metric's reader, ``read(run)``, which
  returns None where it finds nothing to read;
- ``reference/<name>.py``: a mechanism, for each name in a
  configuration's ``layers`` (``[mixer, ffn]`` a layer).  It holds
  everything the benchmark knows of it: ``PORT``, the kind of the port's
  ``BlockSpec`` it stands for (``attn_mla``, ``attn``, ``mamba``, ``dense``,
  ``moe``), which the harness holds against the program's layer before
  set-up; ``KEY``, the key its tree sits under in a layer (``mixer``,
  ``ffn``, ``moe``); ``leaves(cfg)``, the leaves it draws, ``(shape,
  init)`` each in the order they are drawn (:mod:`perfbench.weights`);
  ``residual(p, c, x, fwd)``, its plain fp32 branch of the residual stream
  (:class:`perfbench.reference.Forward`); and its model FLOPs:
  ``params(c)``, the weights a token passes through, and where not 0
  ``pair_flops(c)``, the operations a live (query, key) pair, and
  ``token_flops(c)``, the operations a token outside the products.  A
  variant of a mechanism (MLA without q LoRA, say, beside ``mla``)
  declares the same ``PORT``, names the file it varies in ``VARIES``, and
  may import that file's helpers;
- ``kernels/<op>.py``: one of the port's kernel ops, by the name after
  ``::`` of ``OP``, its name in the trace.  ``ATTR`` is the attribute of
  ``repro_torch.kernels.ops`` that the traced batches' calls are recorded
  at; ``record(*args)`` what a call records (neither syncing the device
  nor launching anything); ``work(call)`` its operations and bytes
  (:mod:`perfbench.counts`) and the dtype whose peak bounds it.

A configuration brings its file under ``configs/``, its cells' traffic
and checks, and any mechanism or kernel op that is not there yet, as new
files: adding a configuration, a traffic mix, a cell, a metric, a
mechanism or a kernel op adds files and entries, and edits none.
"""

from __future__ import annotations

import functools
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: where mechanisms and kernel-op files are looked for, in order
MECHANISM_DIRS: List[Path] = [HERE / "reference"]
KERNEL_DIRS: List[Path] = [HERE / "kernels"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@functools.lru_cache(maxsize=None)
def _load(path: Path):
    """The module in the file ``path``: one of the ``perfbench.reference``
    package's by its import name (so that its relative imports resolve),
    any other loaded from the file alone; once a file."""
    if path.parent == HERE / "reference":
        return importlib.import_module(f"perfbench.reference.{path.stem}")
    name = "perfbench_file_" + "_".join(path.parts[-2:]).replace(
        ".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _find(dirs: List[Path], stem: str, what: str):
    paths = [d / f"{stem}.py" for d in dirs]
    for path in paths:
        if path.is_file():
            return _load(path)
    raise LookupError(f"no {what} {stem!r}: looked for "
                      f"{', '.join(str(p) for p in paths)}")


def reader(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    return _find([HERE / "metrics"], name, "metric").read


def mechanism(name: str):
    """The module of the mechanism a configuration's ``layers`` name
    ``name``: ``<name>.py`` in the first of :data:`MECHANISM_DIRS` that
    holds one."""
    mod = _find(MECHANISM_DIRS, name, "mechanism")
    if not hasattr(mod, "PORT"):
        raise LookupError(f"{mod.__file__} is not a mechanism: it declares "
                          f"no PORT")
    return mod


def base_mechanism(kind: str) -> str:
    """The name of the one mechanism that stands for the port's block kind
    ``kind`` and varies none."""
    files: Dict[str, Path] = {}
    for d in MECHANISM_DIRS:
        for path in sorted(d.glob("*.py")):
            files.setdefault(path.stem, path)
    found = [stem for stem, path in files.items() if stem != "__init__"
             and getattr(_load(path), "PORT", None) == kind
             and not getattr(_load(path), "VARIES", None)]
    if len(found) != 1:
        raise LookupError(f"{len(found)} mechanisms stand for the port's "
                          f"{kind!r} and vary none in "
                          f"{[str(d) for d in MECHANISM_DIRS]}: {found}")
    return found[0]


def kernel_op(op: str):
    """The file of the kernel op named ``op`` in the trace
    (``<namespace>::<name>``): ``<name>.py`` in :data:`KERNEL_DIRS`."""
    mod = _find(KERNEL_DIRS, op.split("::")[-1], "kernel-op file")
    if mod.OP != op:
        raise LookupError(f"{mod.__file__} is the file of {mod.OP!r}, not "
                          f"of {op!r}")
    return mod


def kernel_ops() -> list:
    """Every kernel-op file of :data:`KERNEL_DIRS`."""
    return [_load(p) for d in KERNEL_DIRS for p in sorted(d.glob("*.py"))]


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
