"""Metrics split by cell: ``<base>.decode`` is ``<base>`` read in the cells
whose rate is ``output_tokens_per_s.decode``.  Each such metric reads what
its base reads, says the same of itself, and shares no cell with it."""

from pathlib import Path

import pytest

from perfbench import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = spec.load_json(ROOT / "BENCHMARK.json")
METRICS = {m["name"]: m for m in BENCH["end_to_end"] + BENCH["per_layer"]}
SPLIT = sorted(n for n in METRICS if n.endswith(".decode"))


def test_there_are_split_metrics():
    assert "output_tokens_per_s.decode" in SPLIT and len(SPLIT) > 1


@pytest.mark.parametrize("name", SPLIT)
def test_a_split_metric_is_its_base_in_other_cells(name):
    base = name[:-len(".decode")]
    m, b = METRICS[name], METRICS[base]
    for key in ("unit", "better", "source"):
        assert m[key] == b[key]
    if "layer" in m:
        assert m["layer"] == b["layer"]
        assert b["moves"] == "output_tokens_per_s"
        assert m["moves"] == "output_tokens_per_s.decode"
    assert m["workloads"] and not set(m["workloads"]) & set(b["workloads"])


@pytest.mark.parametrize("name", SPLIT)
def test_a_split_metric_reads_what_its_base_reads(name, monkeypatch):
    base = name[:-len(".decode")]
    read = spec.reader(name)
    asked = []

    def reader(n):
        asked.append(n)
        return lambda run: ("read", run)
    monkeypatch.setattr(spec, "reader", reader)
    assert read("the run") == ("read", "the run")
    assert asked == [base]
