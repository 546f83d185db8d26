"""The port's plan server, zoo and kernel loading under threads.

* ``repro_torch.serve.plans``: tiered zoo → store → search resolution,
  in-flight deduplication, warm evaluators and the HTTP protocol, as
  ``tests/test_serve_plans.py`` holds the reference's, on ``device="cpu"``
  (the ``torch`` backend's plain version).  Every served result is
  byte-equal to the reference's ``run`` of the same spec, and a zoo or
  store written by either package serves from the other.
* ``repro_torch.serve.zoo`` and the CLI's ``zoo``/``store``/``trace``
  subcommands write the reference CLI's bytes.
* ``repro_torch.kernels._build.load``: threads that ask for one library at
  once build and load it once; concurrent builds use private temporary
  names.

Tolerance: exact (byte-equal JSON).
"""

import ctypes
import json
import sys
import threading
import types
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.api import ExploreSpec as RefSpec  # noqa: E402
from repro.api import ResultStore as RefStore  # noqa: E402
from repro.api import run as ref_run  # noqa: E402
from repro.api.cli import main as ref_main  # noqa: E402
from repro.core import HWSpace as RefHWSpace  # noqa: E402
from repro.core import Objective as RefObjective  # noqa: E402
from repro.core.graph import graph_to_json  # noqa: E402
from repro.serve.plans import PlanService as RefPlanService  # noqa: E402
from repro.serve.zoo import build_zoo as ref_build_zoo  # noqa: E402
from repro_torch.api import ResultStore, spec_key  # noqa: E402
from repro_torch.api.cli import main  # noqa: E402
from repro_torch.bridge import spec_from_reference  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    PlanService,
    build_zoo,
    fetch_stats,
    request_plan,
    resolve_plan,
    serve_in_thread,
    verify_zoo,
    zoo_coverage,
    zoo_specs,
)
from repro_torch.serve.plans import fetch_metrics  # noqa: E402


def ref_greedy_spec(workload="synthetic:chain:6?seed=1", **kw):
    defaults = dict(
        workload=workload,
        strategy="greedy",
        objective=RefObjective(metric="ema", alpha=None),
        hw=RefHWSpace(mode="fixed"),
        sample_budget=100,
        seed=0,
    )
    defaults.update(kw)
    return RefSpec(**defaults)


def greedy_spec(workload="synthetic:chain:6?seed=1", **kw):
    """The port's spec, bridged from the reference's."""
    return spec_from_reference(ref_greedy_spec(workload, **kw).to_json())


def ref_json(spec) -> str:
    """The reference's result of the port's ``spec``."""
    return ref_run(RefSpec.from_json(spec.to_json())).to_json()


def service(tmp_path, **kw) -> PlanService:
    return PlanService(ResultStore(tmp_path / "store"), device="cpu", **kw)


def _artifacts(root):
    return {p.name: p.read_bytes() for p in sorted(root.glob("*.json"))}


# ---------------------------------------------------------------------------
# resolve_plan
# ---------------------------------------------------------------------------

def test_resolve_plan_cold_then_store_hit(tmp_path):
    store = ResultStore(tmp_path / "store")
    spec = greedy_spec()
    first, src1 = resolve_plan(spec, store=store, device="cpu")
    second, src2 = resolve_plan(spec, store=store, device="cpu")
    assert (src1, src2) == ("search", "store")
    assert second.to_json() == first.to_json() == ref_json(spec)
    assert store.writes == 1
    # the reference's store holds the same file, byte for byte
    ref_spec = ref_greedy_spec()
    ref_run(ref_spec, store=RefStore(tmp_path / "ref"))
    assert _artifacts(tmp_path / "store") == _artifacts(tmp_path / "ref")


def test_resolve_plan_without_store_always_searches():
    from repro_torch.api import run

    spec = greedy_spec()
    calls = []

    def searcher(s):
        calls.append(s)
        return run(s, device="cpu")

    _, src = resolve_plan(spec, searcher=searcher)
    _, src2 = resolve_plan(spec, searcher=searcher)
    assert (src, src2) == ("search", "search") and len(calls) == 2


def test_resolve_plan_zoo_tier_wins_and_store_stays_clean(tmp_path):
    # the zoo is written by the reference and served by the port
    ref_build_zoo(RefStore(tmp_path / "zoo"), [ref_greedy_spec()])
    zoo = ResultStore(tmp_path / "zoo", read_only=True)
    store = ResultStore(tmp_path / "store")
    spec = greedy_spec()
    res, src = resolve_plan(spec, store=store, zoo=zoo, device="cpu")
    assert src == "zoo" and len(store) == 0
    assert res.to_json() == ref_json(spec)


def test_resolve_plan_revalidates_file_workloads(tmp_path):
    from conftest import chain_graph, small_graph

    path = tmp_path / "net.json"
    path.write_text(graph_to_json(small_graph()))
    spec = greedy_spec(workload=f"file:{path}")
    store = ResultStore(tmp_path / "store")
    _, src1 = resolve_plan(spec, store=store, device="cpu")
    _, src2 = resolve_plan(spec, store=store, device="cpu")
    assert (src1, src2) == ("search", "store")
    path.write_text(graph_to_json(chain_graph(8)[0]))   # file changed
    res, src3 = resolve_plan(spec, store=store, device="cpu")
    assert src3 == "search"
    assert res.to_json() == ref_json(spec)


def test_resolve_plan_default_searcher_runs_on_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        resolve_plan(greedy_spec(strategy="ga", sample_budget=40))


# ---------------------------------------------------------------------------
# PlanService
# ---------------------------------------------------------------------------

def test_service_cold_then_hit(tmp_path):
    svc = service(tmp_path)
    try:
        spec = greedy_spec()
        a = svc.plan(spec)
        b = svc.plan(spec)
        assert (a.served_from, b.served_from) == ("search", "store")
        assert not a.deduped and not b.deduped
        assert svc.searches == 1 and svc.store_hits == 1
        assert b.result.to_json() == a.result.to_json() == ref_json(spec)
        assert a.key == b.key == spec_key(spec)
    finally:
        svc.close()


@pytest.mark.parametrize("strategy", ["greedy", "ga"])
def test_concurrent_identical_requests_search_exactly_once(tmp_path,
                                                           strategy):
    """N identical concurrent requests: one search, N-1 dedup joins, and
    every caller gets the reference's result; the GA case searches
    through the ``torch`` backend's batches."""
    n = 8
    svc = service(tmp_path, workers=4)
    spec = greedy_spec("synthetic:layered:10?seed=5", strategy=strategy)
    out = [None] * n
    barrier = threading.Barrier(n)

    def hit(i):
        barrier.wait()
        out[i] = svc.plan(spec)

    try:
        threads = [threading.Thread(target=hit, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert svc.searches == 1
        assert svc.dedup_joins == n - 1
        assert sum(r.deduped for r in out) == n - 1
        assert {r.result.to_json() for r in out} == {ref_json(spec)}
        assert len(svc.store) == 1
    finally:
        svc.close()


def test_distinct_specs_do_not_dedup(tmp_path):
    svc = service(tmp_path, workers=2)
    try:
        a = svc.plan(greedy_spec(seed=0))
        b = svc.plan(greedy_spec(seed=1))
        assert svc.searches == 2 and svc.dedup_joins == 0
        assert a.key != b.key
    finally:
        svc.close()


def test_warm_evaluator_reused_across_same_workload_searches(tmp_path):
    svc = service(tmp_path)
    try:
        svc.plan(greedy_spec(sample_budget=50))
        svc.plan(greedy_spec(sample_budget=60))
        assert svc.searches == 2
        assert svc.stats()["server"]["warm_evaluators"] == 1
        evs = [w.ev for w in svc._evaluators.values()]
        assert [type(ev.executor).__name__ for ev in evs] == ["TorchExecutor"]
        assert evs[0].executor.device == torch.device("cpu")
        svc.plan(greedy_spec(workload="synthetic:layered:8?seed=2"))
        assert svc.stats()["server"]["warm_evaluators"] == 2
    finally:
        svc.close()


def test_service_zoo_tier_is_read_only(tmp_path):
    spec = greedy_spec()
    build_zoo(ResultStore(tmp_path / "zoo"), [spec], device="cpu")
    zoo = ResultStore(tmp_path / "zoo", read_only=True)
    before = sorted(p.name for p in (tmp_path / "zoo").iterdir())
    svc = PlanService(ResultStore(tmp_path / "store"), zoo=zoo, device="cpu")
    try:
        resp = svc.plan(spec)
        assert resp.served_from == "zoo"
        assert svc.zoo_hits == 1 and svc.searches == 0
        assert len(svc.store) == 0
        assert sorted(p.name for p in (tmp_path / "zoo").iterdir()) == before
        assert resp.result.to_json() == ref_json(spec)
    finally:
        svc.close()


def test_closed_service_rejects_requests(tmp_path):
    svc = service(tmp_path)
    svc.close()
    with pytest.raises(RuntimeError):
        svc.plan(greedy_spec())


def test_service_on_the_card_without_one_fails_the_search(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    svc = PlanService(ResultStore(tmp_path / "store"))
    try:
        with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
            svc.plan(greedy_spec(strategy="ga", sample_budget=40))
        assert svc.errors == 1 and len(svc.store) == 0
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# HTTP shell + clients
# ---------------------------------------------------------------------------

def test_http_roundtrip_hit_and_stats_schema(tmp_path):
    server = serve_in_thread(service(tmp_path))
    ref_svc = RefPlanService(RefStore(tmp_path / "ref"))
    try:
        spec = greedy_spec()
        first = request_plan(server.url, spec)
        second = request_plan(server.url, spec)
        assert first["ok"] and first["served_from"] == "search"
        assert second["served_from"] == "store"
        assert second["result"] == first["result"]
        assert json.dumps(first["result"]) == \
            json.dumps(json.loads(ref_json(spec)))
        assert second["key"] == spec_key(spec)
        stats = fetch_stats(server.url)
        ref_svc.plan(RefSpec.from_json(spec.to_json()))
        ref_svc.plan(RefSpec.from_json(spec.to_json()))
        ref_stats = ref_svc.stats()
        assert set(stats) == set(ref_stats)
        assert set(stats["server"]) == set(ref_stats["server"])
        for field in ("version", "workers", "requests", "searches",
                      "store_hits", "zoo_hits", "dedup_joins", "errors",
                      "in_flight", "warm_evaluators"):
            assert stats["server"][field] == ref_stats["server"][field], field
        assert stats["store"]["entries"] == 1 and stats["zoo"] is None
    finally:
        server.close()
        ref_svc.close()


def test_http_bad_spec_is_400_and_unknown_route_404(tmp_path):
    server = serve_in_thread(service(tmp_path))
    try:
        req = urllib.request.Request(
            server.url + "/plan", data=b"{not json",
            headers={"Content-Type": "application/json"}, method="POST")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=10)
        assert exc.value.code == 400
        assert not json.loads(exc.value.read().decode())["ok"]
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(server.url + "/nope", timeout=10)
        assert exc.value.code == 404
        with urllib.request.urlopen(server.url + "/healthz",
                                    timeout=10) as resp:
            assert json.loads(resp.read().decode()) == {"ok": True}
    finally:
        server.close()


def test_http_search_failure_is_500(tmp_path):
    server = serve_in_thread(service(tmp_path))
    try:
        bad = greedy_spec(workload="netlib:no-such-model")
        req = urllib.request.Request(
            server.url + "/plan", data=bad.to_json().encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=30)
        assert exc.value.code == 500
        assert fetch_stats(server.url)["server"]["errors"] == 1
    finally:
        server.close()


def _prom(text):
    out = {}
    for line in text.splitlines():
        assert line
        if not line.startswith("#"):
            key, raw = line.rsplit(" ", 1)
            out[key] = float(raw)
    return out


def test_metrics_endpoint_parses_and_counters_are_monotone(tmp_path):
    server = serve_in_thread(service(tmp_path))
    ref_svc = RefPlanService(RefStore(tmp_path / "ref"))
    try:
        spec = greedy_spec()
        for _ in range(2):
            assert request_plan(server.url, spec)["ok"]
            ref_svc.plan(RefSpec.from_json(spec.to_json()))
        text = fetch_metrics(server.url)
        ref_text = ref_svc.metrics_text()
        # the same families, samples and counts; only clocks may differ
        assert [ln for ln in text.splitlines() if ln.startswith("#")] == \
            [ln for ln in ref_text.splitlines() if ln.startswith("#")]
        m1, ref_m = _prom(text), _prom(ref_text)
        assert set(m1) == set(ref_m)
        clocked = ("_sum", "_bucket", "uptime", "_bytes")
        for key, value in ref_m.items():
            if not any(c in key.split("{")[0] for c in clocked):
                assert m1[key] == value, key
        assert m1['repro_plan_served_total{tier="search"}'] == 1
        assert request_plan(server.url, spec)["served_from"] == "store"
        m2 = _prom(fetch_metrics(server.url))
        for key, v1 in m1.items():
            if any(s in key for s in ("_total", "_count", "_bucket",
                                      "_sum")):
                assert m2[key] >= v1, key
        assert m2["repro_plan_requests_total"] == 3
    finally:
        server.close()
        ref_svc.close()


# ---------------------------------------------------------------------------
# zoo
# ---------------------------------------------------------------------------

def test_zoo_build_is_resumable_and_coverage_tracks(tmp_path):
    specs = zoo_specs(workloads=["synthetic:chain:6?seed=1"],
                      strategies=["greedy"],
                      objectives=[("ema", None), ("energy", 0.002)],
                      budget=100)
    assert len(specs) == 2
    store = ResultStore(tmp_path / "zoo")
    assert all(r["status"] == "missing" for r in zoo_coverage(store, specs))
    first = build_zoo(store, specs, device="cpu")
    assert (first.built, first.replayed, first.failed) == (2, 0, 0)
    again = build_zoo(store, specs, device="cpu")
    assert (again.built, again.replayed, again.failed) == (0, 2, 0)
    assert all(r["status"] == "archived" for r in zoo_coverage(store, specs))
    assert zoo_coverage(None, specs)[0]["status"] == "missing"


def test_zoo_build_reports_failures_and_continues(tmp_path):
    good = greedy_spec()
    bad = greedy_spec(workload="netlib:no-such-model")
    report = build_zoo(ResultStore(tmp_path / "zoo"), [bad, good],
                       device="cpu")
    assert (report.built, report.failed) == (1, 1)
    assert len(report.errors) == 1 and "no-such-model" in report.errors[0]


def test_zoo_verify_clean_and_detects_tampering(tmp_path):
    store = ResultStore(tmp_path / "zoo")
    build_zoo(store, [greedy_spec()], device="cpu")
    assert verify_zoo(store) == []
    artifact = next(store.root.glob("*.json"))
    artifact.rename(store.root / ("0" * 64 + ".json"))
    problems = verify_zoo(store)
    assert len(problems) == 1 and "hashes to" in problems[0]


def test_zoo_verify_detects_cost_drift(tmp_path):
    store = ResultStore(tmp_path / "zoo")
    build_zoo(store, [greedy_spec()], device="cpu")
    artifact = next(store.root.glob("*.json"))
    doc = json.loads(artifact.read_text())
    doc["cost"] = doc["cost"] * 2 + 1.0
    artifact.write_text(json.dumps(doc))
    problems = verify_zoo(store, rebuild_graphs=False)
    assert len(problems) == 1 and "re-scored" in problems[0]


ZOO_GRID = ["--workloads",
            "synthetic:chain:6?seed=1,tpu:tinyllama-1.1b:0?tokens=512",
            "--budget", "100"]


def test_zoo_cli_writes_the_reference_artifacts(tmp_path, capsys):
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    assert main(["--device", "cpu", "zoo", "build", "--zoo-dir",
                 str(port_dir), *ZOO_GRID]) == 0
    assert ref_main(["zoo", "build", "--zoo-dir", str(ref_dir),
                     *ZOO_GRID]) == 0
    port, ref = _artifacts(port_dir), _artifacts(ref_dir)
    assert len(port) == 8 and port == ref
    capsys.readouterr()
    # each package verifies and lists the other's zoo
    assert main(["zoo", "verify", "--zoo-dir", str(ref_dir)]) == 0
    assert ref_main(["zoo", "verify", "--zoo-dir", str(port_dir)]) == 0
    assert "8 artifacts verified clean" in capsys.readouterr().out
    assert main(["zoo", "ls", "--json", "--zoo-dir", str(ref_dir),
                 *ZOO_GRID]) == 0
    port_ls = json.loads(capsys.readouterr().out)
    assert ref_main(["zoo", "ls", "--json", "--zoo-dir", str(ref_dir),
                     *ZOO_GRID]) == 0
    assert port_ls == json.loads(capsys.readouterr().out)
    assert port_ls["archived"] == 8
    # a second build replays all eight and searches none
    assert main(["--device", "cpu", "zoo", "build", "--zoo-dir",
                 str(port_dir), *ZOO_GRID]) == 0
    assert "0 built, 8 already archived, 0 failed" in \
        capsys.readouterr().out
    # tampering is caught
    victim = sorted(port_dir.glob("*.json"))[0]
    victim.rename(port_dir / ("f" * 64 + ".json"))
    assert main(["zoo", "verify", "--zoo-dir", str(port_dir)]) == 1
    assert "FAIL" in capsys.readouterr().out


@pytest.mark.parametrize("cmd", [
    ["zoo", "build", *ZOO_GRID, "--zoo-dir"],
    ["serve-plans", "--port", "0", "--store-dir"],
    ["trace", "synthetic:chain:6?seed=1", "--strategy", "greedy",
     "--store-dir"],
], ids=["zoo_build", "serve_plans", "trace"])
def test_card_commands_without_gpu_exit_2(cmd, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    assert main([*cmd, str(tmp_path / "dir")]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error:") and "--device cpu" in err
    assert not (tmp_path / "dir").exists()


# ---------------------------------------------------------------------------
# the CLI's trace and store subcommands
# ---------------------------------------------------------------------------

TRACE = ["trace", "synthetic:layered:24?seed=7", "--strategy", "ga",
         "--budget", "300", "--opt", "population=10"]


@pytest.mark.parametrize("extra", [[], ["--no-steps"],
                                   ["--steps-per-subgraph", "3"]],
                         ids=["steps", "no_steps", "coalesced"])
def test_trace_cli_writes_the_reference_trace(extra, tmp_path, capsys):
    port_out, ref_out = tmp_path / "port.json", tmp_path / "ref.json"
    assert main(["--device", "cpu", *TRACE, *extra, "--out",
                 str(port_out), "--perfetto", str(tmp_path / "port.pf")]) \
        == 0
    port_text = capsys.readouterr().out
    assert ref_main([*TRACE, *extra, "--out", str(ref_out), "--perfetto",
                     str(tmp_path / "ref.pf")]) == 0
    ref_text = capsys.readouterr().out
    assert port_out.read_bytes() == ref_out.read_bytes()
    assert (tmp_path / "port.pf").read_bytes() == \
        (tmp_path / "ref.pf").read_bytes()
    assert port_text.replace(str(port_out), "OUT").replace(
        str(tmp_path / "port.pf"), "PF") == ref_text.replace(
        str(ref_out), "OUT").replace(str(tmp_path / "ref.pf"), "PF")
    assert json.loads(port_out.read_text())["meta"]["validation"]["ok"]


def test_trace_cli_replays_an_archived_plan(tmp_path, capsys):
    plan = tmp_path / "plan.json"
    assert ref_main(["explore", "--workload", "netlib:vgg16", "--strategy",
                     "greedy", "--hw-mode", "fixed", "--cores", "2",
                     "--out", str(plan)]) == 0
    assert main(["--device", "cpu", "trace", "--plan", str(plan),
                 "--out", str(tmp_path / "port.json")]) == 0
    assert ref_main(["trace", "--plan", str(plan), "--out",
                     str(tmp_path / "ref.json")]) == 0
    capsys.readouterr()
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()
    for cli in (main, ref_main):
        with pytest.raises(SystemExit, match="--plan replays an archived"):
            cli(["--device", "cpu"] * (cli is main)
                + ["trace", "--plan", str(plan), "--workload",
                   "netlib:vgg16"])


def test_store_ls_and_gc_print_the_reference_listing(tmp_path, capsys):
    store = tmp_path / "store"
    for seed in (0, 1):
        assert ref_main(["explore", "--workload", "synthetic:chain:6?seed=1",
                         "--strategy", "greedy", "--seed", str(seed),
                         "--store-dir", str(store)]) == 0
    capsys.readouterr()
    for args in (["store", "ls", "--json"], ["store", "ls"]):
        assert main([*args, "--store-dir", str(store)]) == 0
        port = capsys.readouterr().out
        assert ref_main([*args, "--store-dir", str(store)]) == 0
        assert port == capsys.readouterr().out
    assert main(["store", "gc", "--store-dir", str(store), "--max-bytes",
                 "1"]) == 0
    assert "evicted 2 entries" in capsys.readouterr().out
    assert ResultStore(store).entries() == []


# ---------------------------------------------------------------------------
# kernel loading from many threads
# ---------------------------------------------------------------------------

def test_concurrent_first_loads_build_and_load_once(monkeypatch):
    """Eight threads ask for one library at once: one build, one
    ``ctypes`` load, and all eight get the same handle."""
    builds, loads = [], []
    lock = threading.Lock()

    def fake_build_all(names):
        with lock:
            builds.append(list(names))
        threading.Event().wait(0.05)   # a build takes time
        return {n: _build.BUILD_DIR / f"{n}-fake.so" for n in names}

    class FakeLib:
        def __init__(self, path):
            with lock:
                loads.append(path)

        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "build_all", fake_build_all)
    monkeypatch.setattr(ctypes, "CDLL", FakeLib)
    n = 8
    barrier = threading.Barrier(n)
    got = [None] * n

    def first_load(i):
        barrier.wait()
        got[i] = _build.load("finish_batch")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=first_load, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert builds == [["finish_batch"]] and len(loads) == 1
    assert all(lib is got[0] for lib in got)
    sig = _build._SIGNATURES["finish_batch"]["finish_batch_launch"]
    assert got[0].finish_batch_launch.argtypes == sig[0]


def test_concurrent_builds_write_private_temporary_files(monkeypatch,
                                                         tmp_path):
    """Two threads building one source at once (no lock above
    ``build_all``) write to different temporary files."""
    outs = []
    lock = threading.Lock()

    class FakeNvcc:
        returncode = 0

        def __init__(self, cmd, **_kw):
            out = cmd[cmd.index("-o") + 1]
            with lock:
                outs.append(out)
            with open(out, "wb") as f:
                f.write(b"lib")

        def communicate(self):
            threading.Event().wait(0.05)
            return "", "ptxas info    : Used 8 registers"

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "/bin/true")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeNvcc)
    barrier = threading.Barrier(2)
    paths = []

    def build():
        barrier.wait()
        paths.append(_build.build_all(["finish_batch"])["finish_batch"])

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(outs) == 2 and len(set(outs)) == 2
    assert paths[0] == paths[1] and paths[0].read_bytes() == b"lib"
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        sorted([paths[0].name, paths[0].with_suffix(".log").name])
