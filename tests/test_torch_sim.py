"""The port's simulators and telemetry exporters equal the JAX package's.

* ``repro_torch.sim``: on every golden plan (the two ``tpu:`` ones and the
  multi-core ``ga_noc`` case included) the port's ``simulate_plan`` writes
  the reference's trace JSON byte for byte, and its cross-validation report,
  bandwidth profile and NoC profile are the reference's; the invariants of
  ``tests/test_sim.py`` are held the same way, plan by plan.
* ``repro_torch.core.simulate``: the row-level executor gives the
  reference's occupancies, loads, rounds and updates, and deadlocks where
  it does.
* ``repro_torch.obs``: ``render_metrics`` text, histogram snapshots, and
  the Perfetto documents of a recorder and of a trace are the reference's;
  ``explore --telemetry`` records the reference's span tree.

Plans reach the port as the reference's JSON, graphs through the port's
own workload resolver (fingerprints equal).  Tolerance: exact throughout
(host integer and float arithmetic in the same order).
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from conftest import chain_graph, fig5_like_graph  # noqa: E402
from test_golden_workloads import CASES, WORKLOADS, golden_path  # noqa: E402

from repro import obs as ref_obs  # noqa: E402
from repro import sim as ref_sim  # noqa: E402
from repro.api import ExploreSpec as RefSpec  # noqa: E402
from repro.api import GAOptions as RefGAOptions  # noqa: E402
from repro.api import GreedyOptions as RefGreedyOptions  # noqa: E402
from repro.api import build_workload as ref_build_workload  # noqa: E402
from repro.api import run as ref_run  # noqa: E402
from repro.api.cli import main as ref_main  # noqa: E402
from repro.core import AcceleratorConfig as RefAcc  # noqa: E402
from repro.core import CachedEvaluator as RefEvaluator  # noqa: E402
from repro.core import HWSpace as RefHWSpace  # noqa: E402
from repro.core import Objective as RefObjective  # noqa: E402
from repro.core import simulate as ref_simulate  # noqa: E402
from repro.core.graph import graph_to_json  # noqa: E402
from repro.core.partition import random_partition, split_to_fit  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch import sim  # noqa: E402
from repro_torch.api import ExploreResult, build_workload  # noqa: E402
from repro_torch.api.cli import main  # noqa: E402
from repro_torch.bridge import acc_from_reference, graph_from_reference  # noqa: E402
from repro_torch.core import DeadlockError, simulate_subgraph  # noqa: E402

KB = 1 << 10


def _port_result(ref_res) -> ExploreResult:
    return ExploreResult.from_json(ref_res.to_json())


def _traces(uri, groups, ref_acc, **kw):
    """The reference's and the port's trace of one plan."""
    ref = ref_sim.simulate_plan(ref_build_workload(uri), groups, ref_acc,
                                **kw)
    port = sim.simulate_plan(build_workload(uri), groups,
                             acc_from_reference(dataclasses.asdict(ref_acc)),
                             **kw)
    return ref, port


def _assert_same_trace(ref, port, meta=None):
    assert port.to_json(meta=meta) == ref.to_json(meta=meta)
    assert port.to_json(include_steps=False) == \
        ref.to_json(include_steps=False)
    assert port.bandwidth_profile().to_dict() == \
        ref.bandwidth_profile().to_dict()
    assert port.noc_profile().to_dict() == ref.noc_profile().to_dict()
    links = ref.acc.weight_share_cores
    assert port.noc_profile(links=links).to_dict() == \
        ref.noc_profile(links=links).to_dict()


def _greedy_plan(uri, **acc_kw):
    """The reference's greedy plan of ``tests/test_sim.py``, and the same
    plan found by the port on the CPU (asserted equal)."""
    from repro_torch.api import run
    from repro_torch.bridge import spec_from_reference

    acc = RefAcc(**acc_kw) if acc_kw else RefAcc()
    spec = RefSpec(workload=uri, strategy="greedy",
                   objective=RefObjective(metric="ema", alpha=None),
                   hw=RefHWSpace(mode="fixed", base=acc),
                   options=RefGreedyOptions(eval_budget=2_000))
    res = ref_run(spec)
    assert res.feasible
    port = run(spec_from_reference(spec.to_json()), device="cpu")
    assert port.to_json() == res.to_json()
    return res


# ---------------------------------------------------------------------------
# the goldens: byte-equal traces and reports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workload_key,strategy", CASES)
def test_golden_plans_cross_validate_exactly(workload_key, strategy):
    text = golden_path(workload_key, strategy).read_text()
    from repro.api import ExploreResult as RefResult

    ref_res = RefResult.from_json(text)
    port_res = ExploreResult.from_json(text)
    uri = WORKLOADS[workload_key]
    ref_trace, port_trace = _traces(uri, ref_res.groups, ref_res.acc)
    ref_report = ref_sim.cross_validate_trace(ref_trace, ref_res.plan)
    port_report = sim.cross_validate_trace(port_trace, port_res.plan)
    assert port_report.ok, port_report.summary()
    assert port_report.to_dict() == ref_report.to_dict()
    assert port_report.summary() == ref_report.summary()
    meta = {"workload": uri, "strategy": strategy,
            "validation": ref_report.to_dict()}
    _assert_same_trace(ref_trace, port_trace, meta)
    fresh = sim.cross_validate(build_workload(uri), port_res.groups,
                               port_res.acc)
    assert fresh.to_dict() == ref_sim.cross_validate(
        ref_build_workload(uri), ref_res.groups, ref_res.acc).to_dict()


def test_golden_cases_include_both_tpu_plans_and_the_multicore_plan():
    keys = {w for w, _ in CASES}
    assert "tpu_gemma3-4b_L0" in keys and len(CASES) == 10
    assert ("synthetic_layered24", "ga_noc") in CASES


# ---------------------------------------------------------------------------
# the invariants of tests/test_sim.py, port against reference
# ---------------------------------------------------------------------------

def test_trace_is_deterministic_and_json_stable():
    res = _greedy_plan("synthetic:branchy:16?seed=2")
    ref, port = _traces("synthetic:branchy:16?seed=2", res.groups, res.acc)
    _assert_same_trace(ref, port)
    again = sim.simulate_plan(build_workload("synthetic:branchy:16?seed=2"),
                              res.groups, port.acc)
    assert again.to_json() == port.to_json()


@pytest.mark.parametrize("steps", (1, 3, 16))
def test_coalescing_preserves_every_total(steps):
    res = _greedy_plan("netlib:vgg16")
    ref, port = _traces("netlib:vgg16", res.groups, res.acc,
                        steps_per_subgraph=steps)
    _assert_same_trace(ref, port)
    assert sim.cross_validate_trace(port, _port_result(res).plan).ok


def test_prologue_and_prefetch_cover_all_weight_traffic():
    res = _greedy_plan("netlib:resnet50")
    ref, port = _traces("netlib:resnet50", res.groups, res.acc)
    _assert_same_trace(ref, port)
    prologue = [s for s in port.steps if s.subgraph == sim.PROLOGUE]
    assert [dataclasses.asdict(s) for s in prologue] == \
        [dataclasses.asdict(s) for s in ref.steps
         if s.subgraph == ref_sim.PROLOGUE]


def test_occupancy_stays_within_analytical_footprint():
    res = _greedy_plan("netlib:googlenet")
    ref, port = _traces("netlib:googlenet", res.groups, res.acc)
    _assert_same_trace(ref, port)
    for sg in port.subgraphs:
        assert sg.peak_occ_act <= sg.footprint


def test_streamed_single_layer_restreams_weights_mid_subgraph():
    res = _greedy_plan("netlib:vgg16", glb_bytes=24 * KB, wbuf_bytes=24 * KB)
    ref, port = _traces("netlib:vgg16", res.groups, res.acc)
    _assert_same_trace(ref, port)
    assert any(sg.stream_blocks > 1 for sg in port.subgraphs)
    assert sim.cross_validate_trace(port, _port_result(res).plan).ok


def test_infeasible_plans_are_rejected():
    acc = RefAcc(glb_bytes=2 * KB, wbuf_bytes=2 * KB)
    uri = "synthetic:diamond:8?seed=1"
    with pytest.raises(ValueError, match="infeasible") as ref_err:
        ref_sim.simulate_plan(ref_build_workload(uri), [set(range(8))], acc)
    with pytest.raises(ValueError, match="infeasible") as port_err:
        sim.simulate_plan(build_workload(uri), [set(range(8))],
                          acc_from_reference(dataclasses.asdict(acc)))
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("share", (2, 3, 4))
@pytest.mark.parametrize("uri", ("synthetic:layered:16?seed=7",
                                 "netlib:vgg16"))
def test_multicore_plans_cross_validate_exactly(uri, share):
    res = _greedy_plan(uri, weight_share_cores=share, n_cores=share)
    port = sim.cross_validate(build_workload(uri), res.groups,
                              acc_from_reference(dataclasses.asdict(res.acc)))
    ref = ref_sim.cross_validate(ref_build_workload(uri), res.groups,
                                 res.acc)
    assert port.ok and port.noc_simulated == port.noc_analytical > 0
    assert port.to_dict() == ref.to_dict()


@pytest.mark.parametrize("share", (1, 2, 3))
def test_multicore_prologue_shards_weights_per_core(share):
    res = _greedy_plan("netlib:vgg16", weight_share_cores=share,
                       n_cores=share)
    ref, port = _traces("netlib:vgg16", res.groups, res.acc)
    _assert_same_trace(ref, port)
    assert sim.cross_validate_trace(port, _port_result(res).plan).ok


def test_single_core_trace_has_no_noc_traffic():
    res = _greedy_plan("netlib:vgg16")
    ref, port = _traces("netlib:vgg16", res.groups, res.acc)
    assert port.total_noc_bytes == ref.total_noc_bytes == 0
    _assert_same_trace(ref, port)


def test_plan_metric_equals_trace_profile_at_subgraph_resolution():
    res = _greedy_plan("netlib:resnet50")
    ref, port = _traces("netlib:resnet50", res.groups, res.acc,
                        steps_per_subgraph=1)
    _assert_same_trace(ref, port)
    plan = _port_result(res).plan
    assert plan.metric("bandwidth") == res.plan.metric("bandwidth") == \
        pytest.approx(port.bandwidth_profile().percentiles["p95"],
                      rel=1e-9)


def test_noc_metrics_equal_trace_profile_at_subgraph_resolution():
    res = _greedy_plan("netlib:vgg16", weight_share_cores=2, n_cores=2)
    ref, port = _traces("netlib:vgg16", res.groups, res.acc,
                        steps_per_subgraph=1)
    _assert_same_trace(ref, port)
    assert port.noc_profile(links=2).to_dict()["peak"] > 0


# the reference draws these from hypothesis; here, seeded draws of the same
# space (kind, n, workload seed, partition seed)
_PROPERTY_CASES = [
    (kind, int(n), int(seed), int(pseed))
    for kind, (n, seed, pseed) in zip(
        ("layered", "branchy", "diamond", "chain", "pyramid") * 2,
        np.random.default_rng(17).integers((2, 0, 0), (21, 1001, 1001),
                                           size=(10, 3)))]


@pytest.mark.parametrize("kind,n,seed,pseed", _PROPERTY_CASES)
def test_property_any_feasible_plan_cross_validates(kind, n, seed, pseed):
    import random

    uri = f"synthetic:{kind}:{n}?seed={seed}"
    g = ref_build_workload(uri)
    acc = RefAcc(glb_bytes=16 * KB, wbuf_bytes=16 * KB)
    groups = split_to_fit(g, random_partition(g, random.Random(pseed),
                                              mean_size=3.0),
                          acc, ev=RefEvaluator(g))
    ref = ref_sim.cross_validate(g, groups, acc)
    port = sim.cross_validate(build_workload(uri), groups,
                              acc_from_reference(dataclasses.asdict(acc)))
    assert port.ok, port.summary()
    assert port.to_dict() == ref.to_dict()
    ref_trace, port_trace = _traces(uri, groups, acc)
    _assert_same_trace(ref_trace, port_trace)


# ---------------------------------------------------------------------------
# core/simulate.py: the row-level executor (tests/test_simulate.py)
# ---------------------------------------------------------------------------

def _both(g, nodes, **kw):
    ref = ref_simulate.simulate_subgraph(g, nodes, **kw)
    port = simulate_subgraph(graph_from_reference(graph_to_json(g)), nodes,
                             **kw)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    return port


def test_chain_executes_correctly_with_derived_capacity():
    g, nodes = chain_graph()
    res = _both(g, nodes, seed=1)
    assert all(n <= g.nodes[t].out_len for t, n in res.dram_loads.items())


def test_diamond_with_lcm_alignment_executes():
    g, (_, _, n0, n1, n2, n3, n4) = fig5_like_graph()
    assert _both(g, {n0, n1, n2, n3, n4}, out_tile=2, seed=3).rounds > 0


def test_capacity_below_window_span_deadlocks():
    g, nodes = chain_graph()
    with pytest.raises(ref_simulate.DeadlockError) as ref_err:
        ref_simulate.simulate_subgraph(g, nodes, seed=1,
                                       capacity_override={0: 2})
    with pytest.raises(DeadlockError) as port_err:
        simulate_subgraph(graph_from_reference(graph_to_json(g)), nodes,
                          seed=1, capacity_override={0: 2})
    assert str(port_err.value) == str(ref_err.value)


def test_full_edge_phase_execution():
    from repro.core import FULL, Graph

    g = Graph("attn")
    i = g.add_node("in", 32, 1)
    q = g.add_node("q", 32, 1)
    a = g.add_node("a", 32, 1)
    o = g.add_node("o", 32, 1, is_output=True)
    g.add_edge(i, q, F=1, s=1)
    g.add_edge(q, a, kind=FULL)
    g.add_edge(a, o, F=1, s=1)
    assert _both(g, {q, a, o}, seed=5).max_occupancy[q] == 32


# ---------------------------------------------------------------------------
# telemetry exporters (tests/test_obs.py)
# ---------------------------------------------------------------------------

def _observe_both(buckets, values):
    ref = ref_obs.Histogram(buckets=buckets) if buckets else \
        ref_obs.Histogram()
    port = obs.Histogram(buckets=buckets) if buckets else obs.Histogram()
    for v in values:
        ref.observe(v)
        port.observe(v)
    return ref, port


@pytest.mark.parametrize("buckets,values", [
    ((0.1, 1.0, 10.0), (0.05, 0.5, 0.5, 5.0, 50.0)),
    (None, ()),
    (None, [0.001] * 9_000 + [20.0] * 1_000),
], ids=["exact", "empty", "never_drops"])
def test_histogram_exact_count_sum_max_and_cumulative_buckets(buckets,
                                                              values):
    ref, port = _observe_both(buckets, values)
    assert port.cumulative() == ref.cumulative()
    assert port.snapshot_ms() == ref.snapshot_ms()
    for q in (0.5, 0.95, 0.99):
        assert port.quantile(q) == ref.quantile(q)


def test_render_metrics_text_format():
    ref_h, port_h = _observe_both((1.0,), (0.5, 2.0))
    ref_lat, port_lat = _observe_both(None, (0.003, 0.04, 0.04, 1.7, 12.0))

    def families(h, lat_h):
        return [
            ("t_total", "counter", "Things.", [({"tier": "a"}, 3)]),
            ("g", "gauge", "A gauge.", [(None, 1.5)]),
            ("lat", "histogram", "Latency.", [({"tier": "a"}, h)]),
            ("req_seconds", "histogram", "Requests.",
             [({"tier": "store"}, lat_h), ({"tier": "zoo"}, lat_h)]),
        ]

    text = obs.render_metrics(families(port_h, port_lat))
    assert text == ref_obs.render_metrics(families(ref_h, ref_lat))
    assert 'lat_bucket{le="+Inf",tier="a"} 2' in text.splitlines()


def _copy_recorder(ref_rec):
    """The port's recorder holding the reference recorder's spans, samples
    and counters (the exporters' input, timestamps included)."""
    rec = obs.Recorder()
    rec.spans = [obs.Span(**dataclasses.asdict(sp)) for sp in ref_rec.spans]
    rec.samples = list(ref_rec.samples)
    rec.counters = dict(ref_rec.counters)
    return rec


def _ga_spec():
    return RefSpec(workload="synthetic:layered:10?seed=2", strategy="ga",
                   sample_budget=150, seed=0,
                   options=RefGAOptions(population=10))


def test_recorder_export_is_schema_valid_chrome_trace():
    ref_rec = ref_obs.Recorder()
    with ref_obs.recording(ref_rec):
        ref_run(_ga_spec(), store=None)
    meta = {"kind": "search", "workload": "synthetic:layered:10?seed=2"}
    ref_doc = ref_obs.chrome_trace_doc(ref_obs.recorder_events(ref_rec),
                                       counters=ref_rec.counters, meta=meta)
    port_rec = _copy_recorder(ref_rec)
    port_doc = obs.chrome_trace_doc(obs.recorder_events(port_rec),
                                    counters=port_rec.counters, meta=meta)
    assert json.dumps(port_doc) == json.dumps(ref_doc)
    assert port_rec.span_tree() == ref_rec.span_tree()


def test_traffic_export_is_schema_valid_chrome_trace(tmp_path):
    res = _greedy_plan("synthetic:chain:6?seed=1")
    ref, port = _traces("synthetic:chain:6?seed=1", res.groups, res.acc)
    meta = {"kind": "traffic"}
    ref_doc = ref_obs.chrome_trace_doc(ref_obs.traffic_events(ref),
                                       meta=meta)
    port_doc = obs.chrome_trace_doc(obs.traffic_events(port), meta=meta)
    assert json.dumps(port_doc) == json.dumps(ref_doc)
    obs.write_chrome_trace(str(tmp_path / "port.json"), port_doc)
    ref_obs.write_chrome_trace(str(tmp_path / "ref.json"), ref_doc)
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()


def _shape(nodes):
    return [(n["name"], _shape(n["children"])) for n in nodes]


@pytest.mark.parametrize("port_backend,ref_backend",
                         [("serial", "serial"), ("torch", "vector")])
def test_ga_span_tree_shape_is_pinned(port_backend, ref_backend):
    """The same seeded GA records the reference's span tree: per-call on
    ``serial``, and per batch on the port's ``torch`` backend (on the CPU)
    as on the reference's batched ``vector`` backend."""
    from repro_torch.api import run
    from repro_torch.bridge import spec_from_reference

    spec = _ga_spec()
    ref_rec = ref_obs.Recorder()
    with ref_obs.recording(ref_rec):
        ref_res = ref_run(spec, store=None, eval_backend=ref_backend)
    rec = obs.Recorder()
    with obs.recording(rec):
        res = run(spec_from_reference(spec.to_json()), store=None,
                  eval_backend=port_backend, device="cpu")
    assert res.to_json() == ref_res.to_json()
    tree = rec.span_tree()
    assert _shape(tree) == _shape(ref_rec.span_tree())
    assert [n["name"] for n in tree] == ["resolve-workload", "strategy:ga"]
    assert [name for name, _, _ in rec.samples] == \
        [name for name, _, _ in ref_rec.samples]
    assert [v for _, _, v in rec.samples] == \
        [v for _, _, v in ref_rec.samples]


def test_explore_telemetry_records_the_reference_span_tree(tmp_path,
                                                           capsys):
    args = ["explore", "--workload", "synthetic:layered:10?seed=2",
            "--strategy", "ga", "--budget", "150", "--opt", "population=10"]
    port_out, ref_out = tmp_path / "port.json", tmp_path / "ref.json"
    port_tel, ref_tel = tmp_path / "port.trace", tmp_path / "ref.trace"
    assert main(["--device", "cpu", *args, "--eval-backend", "serial",
                 "--telemetry", str(port_tel), "--out", str(port_out)]) == 0
    assert ref_main([*args, "--telemetry", str(ref_tel), "--out",
                     str(ref_out)]) == 0
    assert "telemetry written to" in capsys.readouterr().out
    assert port_out.read_text() == ref_out.read_text()
    port_doc, ref_doc = (json.loads(p.read_text())
                         for p in (port_tel, ref_tel))

    def skeleton(doc):
        # everything but the clock: event kinds, names, arguments, and
        # the counters' names
        return ([(e["ph"], e["name"], e.get("args") if e["ph"] != "C"
                  else None) for e in doc["traceEvents"]],
                sorted(doc.get("counters", {})), doc.get("meta"))

    assert skeleton(port_doc) == skeleton(ref_doc)
