"""The readers of the program's spans (``perfbench/spans.py`` and the six
metrics on it) on a hand-built trace, on a trace of the engine on the CPU,
and on a trace without the spans, as the program had before it opened
them."""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.models.config import ModelConfig
from repro_torch.serve import ServeConfig, ServeEngine

from perfbench import harness, spans, spec, traffic, weights
from perfbench.tests import smoke_cells
from perfbench.trace import Trace

MAIN, OTHER = (1, 1), (1, 2)
NEW = ("decode_step_p95_ms", "mla_expand_ms", "mla_attend_ms",
       "moe_dispatch_ms", "moe_experts_idle_ms", "mamba_scan_idle_ms")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _host(name, ts, dur, thread=MAIN):
    return (name, "cpu_op", thread, float(ts), float(dur), None)


def _launch(ts, corr):
    return ("cudaLaunchKernel", "cuda_runtime", MAIN, float(ts), 1.0, corr)


def _kernel(ts, dur, corr):
    return ("k", "kernel", float(ts), float(dur), corr)


def _trace():
    """One prefill [0, 100] and two decode steps [100, 150], [150, 200] µs
    on the main thread, with the layers' spans nested in them."""
    host = [_host("serve.prefill", 0, 100),
            _host("serve.decode_step", 100, 50),
            _host("serve.decode_step", 150, 50),
            # on another thread: neither a forward nor idle time
            _host("serve.decode_step", 300, 10, OTHER),
            _host("mamba.scan", 0, 500, OTHER),
            _host("moe.route", 10, 10), _launch(12, 1),
            _host("moe.experts", 20, 40), _launch(25, 3),
            _host("moe.combine", 60, 10), _launch(62, 2),
            _host("mla.expand", 110, 10), _launch(111, 4),
            _host("mla.attend", 120, 25), _launch(121, 6),
            _host("mla.expand", 160, 10), _launch(161, 5),
            _host("mamba.scan", 180, 10)]
    device = [_kernel(30, 10, 1),       # moe.route's, 10 µs
              _kernel(40, 10, 3),       # moe.experts'
              ("memcpy", "gpu_memcpy", 45.0, 10.0, None),  # overlaps it
              _kernel(70, 5, 2),        # moe.combine's, 5 µs
              _kernel(120, 20, 4),      # mla.expand's, 20 µs
              _kernel(140, 8, 6),       # mla.attend's, 8 µs
              _kernel(170, 10, 5)]      # mla.expand's, 10 µs
    return Trace(device, host)


def _run(trace, batches=(), traced=()):
    run = harness.Run({})
    run.trace = trace
    run.batches = list(batches)
    run.traced_batches = list(traced)
    return run


def _read(name, run):
    return spec.reader(name)(run)


def test_the_readers_on_a_hand_built_trace():
    t = _trace()
    assert spans.count(t, *spans.FORWARD_SPANS) == 3
    assert spans.count(t, "serve.decode_step") == 2
    # busy [30, 55] (a kernel and a copy overlapping) inside [20, 60]
    assert spans.idle_s(t, "moe.experts") == pytest.approx(15e-6)
    # the main thread's span only; busy [170, 180] ends where it starts
    assert spans.idle_s(t, "mamba.scan") == pytest.approx(10e-6)
    run = _run(t)
    assert _read("moe_dispatch_ms", run) == pytest.approx(15e-3 / 3)
    assert _read("moe_experts_idle_ms", run) == pytest.approx(15e-3 / 3)
    assert _read("mla_expand_ms", run) == pytest.approx(30e-3 / 2)
    assert _read("mla_attend_ms", run) == pytest.approx(8e-3 / 2)
    assert _read("mamba_scan_idle_ms", run) == pytest.approx(10e-3 / 3)


def test_idle_time_counts_a_busy_stretch_across_two_spans_once_each():
    host = [_host("serve.prefill", 0, 100), _host("mamba.scan", 0, 20),
            _host("mamba.scan", 30, 20), _host("mamba.scan", 40, 20),
            _launch(1, 1)]
    device = [_kernel(10, 30, 1), _kernel(35, 10, None)]
    # spans [0, 20] and [30, 60] (two overlapping), busy [10, 45]
    assert spans.idle_s(Trace(device, host), "mamba.scan") == \
        pytest.approx((10 + 15) * 1e-6)


def test_decode_step_p95_is_the_nearest_rank_of_every_step():
    batches = [{"step_s": [i / 1e3 for i in range(1, 11)]},
               {"step_s": [i / 1e3 for i in range(11, 21)]}]
    assert _read("decode_step_p95_ms", _run(None, batches)) == \
        pytest.approx(19.0)


def test_every_reader_is_none_where_the_program_has_no_spans():
    bare = Trace([_kernel(0, 5, 1)],
                 [_host("aten::mm", 0, 5), _launch(1, 1)])
    stats = [{"batch": 2, "decode_steps": 3, "decode_s": 0.1}]
    for trace in (bare, None):
        run = _run(trace, stats, stats)
        assert {n: _read(n, run) for n in NEW} == dict.fromkeys(NEW)


@pytest.mark.parametrize("arch", ("deepseek-v2-236b", "jamba-v0.1-52b"))
def test_forwards_from_spans_are_the_traced_batches_forwards(arch):
    """The engine traced on the CPU as the harness traces its batches on
    the card: the spans count the forwards the stats count, and each
    reader listed for the architecture's cells reads a number."""
    cell = smoke_cells.cell(arch)
    cfg = ModelConfig(**cell["config"]["port"])
    mix = cell["mix"]
    tree, _ = weights.draw(cfg, 2**31 + 3, "cpu")
    eng = ServeEngine(cfg, tree, ServeConfig(
        max_batch=mix["batch"], max_len=traffic.max_len(mix)))
    run = harness.Run(cell["config"])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(2):
            b = traffic.batch(mix, cfg.vocab, 7, i)
            run.traced_batches.append(harness._serve_batch(eng, b, 0))
    run.trace = Trace.from_profiler(prof)
    run.batches = run.traced_batches
    assert spans.count(run.trace, *spans.FORWARD_SPANS) == sum(
        1 + b["decode_steps"] for b in run.traced_batches) == 2 * 4
    got = {n: _read(n, run) for n in NEW}
    listed = {"deepseek-v2-236b": NEW[:5],
              "jamba-v0.1-52b": NEW[:1] + NEW[3:]}[arch]
    assert all(got[n] is not None and got[n] >= 0 for n in listed), got
    # no kernel on the CPU: a span's time is all idle
    assert got["moe_experts_idle_ms"] > 0
    assert got["moe_dispatch_ms"] == 0.0
