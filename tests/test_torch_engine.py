"""The port's ``torch`` executor against the JAX package's scalar kernel.

``TorchExecutor("cpu")`` (the plain version of the CUDA kernel behind the
same struct-of-arrays packing the card path uses) must return the same
``SubgraphCost`` as the reference's ``CostKernel(g).cost`` for every query
of the differential-parity corpora, and every strategy must return the
same result JSON as the reference's serial run.  Graphs and hardware
points cross through the bridge as JSON and plain dicts.  Tolerance:
bitwise.
"""

import sys
from dataclasses import asdict

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from backend_parity import (  # noqa: E402
    adversarial_accs,
    fuzz_corpus,
    scheme_corpus,
)
from conftest import small_graph  # noqa: E402

from repro.api import (  # noqa: E402
    EnumOptions,
    ExploreSpec,
    GAOptions,
    SAOptions,
    TwoStepOptions,
)
from repro.api import run as ref_run  # noqa: E402
from repro.core import AcceleratorConfig, CostKernel, HWSpace, Objective  # noqa: E402
from repro.core.graph import graph_to_json  # noqa: E402
from repro_torch.api import compare, list_strategies, run  # noqa: E402
from repro_torch.bridge import (  # noqa: E402
    acc_from_reference,
    graph_from_reference,
    spec_from_reference,
)
from repro_torch.core import CostKernel as PortKernel  # noqa: E402
from repro_torch.core import TorchExecutor  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    BACKENDS,
    SerialExecutor,
    make_executor,
    pool_mp_context,
)
from repro_torch.obs import Recorder, recording  # noqa: E402

KB = 1 << 10
CORPORA = {"scheme": scheme_corpus, "fuzz": fuzz_corpus}


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_torch_executor_matches_reference_scalar_kernel(corpus):
    accs_seen = set()
    rec = Recorder()
    for label, g, queries in CORPORA[corpus]():
        pg = graph_from_reference(graph_to_json(g))
        port_queries = [(nodes, acc_from_reference(asdict(acc)))
                        for nodes, acc in queries]
        ex = TorchExecutor("cpu")
        with recording(rec):
            got = ex.evaluate(PortKernel(pg), port_queries)
        reference = CostKernel(g)
        assert len(got) == len(queries)
        for (nodes, acc), cost in zip(queries, got):
            want = reference.cost(nodes, acc)
            assert asdict(cost) == asdict(want), (
                f"{label}: nodes={sorted(nodes)} glb={acc.glb_bytes} "
                f"wbuf={acc.wbuf_bytes} shared={acc.shared} "
                f"share={acc.weight_share_cores}")
            accs_seen.add(acc)
    assert set(adversarial_accs()) <= accs_seen
    # both sides of the guards ran: batched lanes and scalar fallbacks
    assert rec.counters["engine.array_lanes"] > 0
    assert rec.counters["engine.scalar_fallback"] > 0


def _strategy_spec(strategy):
    acc = AcceleratorConfig(glb_bytes=128 * KB, wbuf_bytes=144 * KB)
    options = {
        "ga": GAOptions(population=16),
        "sa": SAOptions(),
        "enum": EnumOptions(state_budget=20_000),
        "two_step": TwoStepOptions(capacity_samples=4,
                                   samples_per_capacity=400),
    }.get(strategy)
    return ExploreSpec(
        workload="dd",
        strategy=strategy,
        objective=Objective(metric="energy", alpha=0.002),
        hw=HWSpace(mode="shared", base=acc),
        sample_budget=240,
        seed=0,
        options=options,
    )


@pytest.mark.parametrize("strategy", ["dp", "enum", "ga", "greedy", "sa",
                                      "two_step"])
def test_every_strategy_matches_reference_serial_run(strategy):
    g = small_graph()
    spec = _strategy_spec(strategy)
    want = ref_run(spec, graph=g).to_json()
    got = run(spec_from_reference(spec.to_json()),
              graph=graph_from_reference(graph_to_json(g)),
              eval_backend="torch", device="cpu").to_json()
    assert got == want


def test_port_registers_the_same_strategies():
    assert sorted(list_strategies()) == ["dp", "enum", "ga", "greedy", "sa",
                                         "two_step"]


def test_backends_and_executor_resolution():
    assert BACKENDS == ("serial", "process", "vector", "torch")
    ex = make_executor(None, 1, device="cpu")
    assert isinstance(ex, TorchExecutor) and ex.device.type == "cpu"
    ex = make_executor("torch", 1, device="cpu")
    assert isinstance(ex, TorchExecutor) and ex.device.type == "cpu"
    assert isinstance(make_executor("serial", 1), SerialExecutor)
    with pytest.raises(ValueError, match="valid backends"):
        make_executor("jax", 1)
    # eval_jobs sizes the process pool only: never a silent backend switch
    for backend in (None, "serial", "vector", "torch"):
        with pytest.raises(ValueError, match="process"):
            make_executor(backend, 2, device="cpu")


def test_run_defaults_to_the_torch_backend_on_the_card():
    g = graph_from_reference(graph_to_json(small_graph()))
    spec = spec_from_reference(_strategy_spec("ga").to_json())
    rec = Recorder()
    with recording(rec):
        run(spec, graph=g, device="cpu")
    assert rec.counters["engine.array_batches"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA GPU"):
            run(spec, graph=g)


def test_parallel_compare_workers_use_the_requested_backend():
    """``compare(jobs=2)`` hands every worker the caller's backend and
    device, and returns the reference's serial results."""
    g = small_graph()
    specs = [_strategy_spec(s) for s in ("ga", "sa")]
    want = [ref_run(s, graph=g).to_json() for s in specs]
    port_g = graph_from_reference(graph_to_json(g))
    port_specs = [spec_from_reference(s.to_json()) for s in specs]
    got = compare(port_specs[0], port_specs, graph=port_g, jobs=2,
                  eval_backend="torch", device="cpu")
    assert [r.to_json() for r in got] == want
    with pytest.raises(ValueError, match="process"):
        compare(port_specs[0], port_specs, graph=port_g, jobs=2,
                eval_backend="process", device="cpu")
    if not torch.cuda.is_available():
        # the workers' default is the card too: no silent CPU run
        with pytest.raises(RuntimeError, match="CUDA GPU"):
            compare(port_specs[0], port_specs, graph=port_g, jobs=2)


def test_torch_executor_on_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        TorchExecutor("cuda")


def test_pool_context_avoids_forking_a_torch_parent():
    assert "torch" in sys.modules
    assert pool_mp_context().get_start_method() == "forkserver"


def test_process_backend_after_torch_matches_serial():
    """A worker pool started after torch (and its thread pools) came up
    forks from the forkserver, with the same answers as serial."""
    import warnings

    from repro_torch.core import ProcessExecutor

    torch.ones(4).sum()  # bring torch's thread pools up
    g = graph_from_reference(graph_to_json(small_graph()))
    spec = _strategy_spec("ga")
    queries = [(frozenset(range(i, i + 2)), acc_from_reference(
        asdict(spec.hw.base))) for i in range(7)]
    ex = ProcessExecutor(jobs=1)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            got = ex.evaluate(PortKernel(g), queries)
    finally:
        ex.close()
    want = SerialExecutor().evaluate(PortKernel(g), queries)
    assert [asdict(c) for c in got] == [asdict(c) for c in want]
