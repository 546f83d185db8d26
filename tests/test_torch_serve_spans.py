"""The serving path's spans (``repro_torch.obs``), on the CPU.

With no recorder and no profiler a span is the shared no-op; under
``torch.profiler`` each span is a ``cpu_op`` range in the exported trace,
the serving path opens each of its spans once a layer of its kind a
forward, and the tokens are those of the same run without the profiler;
the engine's ``step_s`` holds one host time a decode step; and the
planner's span tree and result are the same with the profiler on.
"""

import contextlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.api import ExploreSpec, GAOptions, run
from repro_torch.configs import get_config
from repro_torch.models import lm_init, param_values
from repro_torch.models.config import ATTN_MLA, FFN_MOE, MAMBA
from repro_torch.obs.recorder import _NULL_SPAN, NullRecorder
from repro_torch.serve import Request, ServeConfig, ServeEngine

ARCHS = ("deepseek-v2-236b", "jamba-v0.1-52b")
SPANS = ("serve.prefill", "serve.decode_step", "mla.expand", "mla.attend",
         "moe.route", "moe.experts", "moe.combine", "mamba.scan")
NEW, PLEN = 4, 10


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _serve(arch, profiler=False, tmp_path=None):
    """One batch of 2 prompts through a smoke ``arch`` engine; (tokens,
    the batch's stats, the names of the exported trace's ``cpu_op``
    events or None)."""
    cfg = get_config(arch, smoke=True)
    values = param_values(lm_init(cfg, torch.Generator().manual_seed(0)))
    eng = ServeEngine(cfg, values, ServeConfig(max_batch=2, max_len=32))
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, PLEN).astype(
        np.int32), max_new_tokens=NEW) for i in range(2)]
    if not profiler:
        return eng.generate(reqs), eng.stats[0], None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = eng.generate(reqs)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    return out, eng.stats[0], names


def test_a_span_with_no_recorder_and_no_profiler_is_the_shared_no_op():
    assert isinstance(obs.current(), NullRecorder)
    assert obs.span("serve.decode_step") is _NULL_SPAN
    assert obs.span("serve.decode_step", step=1) is _NULL_SPAN
    assert NullRecorder().span("moe.route", k=1) is _NULL_SPAN
    with obs.span("mamba.scan") as sp:
        assert sp is _NULL_SPAN


def test_a_span_reaches_both_sinks_when_both_are_on(tmp_path):
    rec = obs.Recorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.recording(rec), obs.span("outer", k=1):
            with obs.span("inner"):
                torch.ones(2).sum()
        with obs.span("profiler.only"):
            pass
    assert obs.span("after") is _NULL_SPAN
    assert rec.span_tree() == [{"name": "outer", "children": [
        {"name": "inner", "children": []}]}]
    assert rec.spans[0].attrs == {"k": 1}
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    ev = {e["name"]: e for e in json.loads(path.read_text())["traceEvents"]
          if e.get("ph") == "X"}
    for name in ("outer", "inner", "profiler.only"):
        assert ev[name]["cat"] == "cpu_op"
    assert ev["outer"]["ts"] <= ev["inner"]["ts"]
    assert (ev["inner"]["ts"] + ev["inner"]["dur"]
            <= ev["outer"]["ts"] + ev["outer"]["dur"])


def test_the_planner_span_tree_and_result_are_the_same_under_the_profiler():
    spec = ExploreSpec(workload="synthetic:layered:12?seed=7",
                       strategy="ga", sample_budget=200,
                       options=GAOptions(population=10))
    runs = []
    for profiled in (False, True):
        rec = obs.Recorder()
        with profile(activities=[ProfilerActivity.CPU]) if profiled \
                else contextlib.nullcontext():
            with obs.recording(rec):
                result = run(spec, device="cpu")
        runs.append((result.to_json(), rec.span_tree(),
                     sorted(rec.counters)))
    assert runs[0] == runs[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_each_serving_span_runs_once_a_layer_of_its_kind_a_forward(
        arch, tmp_path):
    plain, _, _ = _serve(arch)
    tokens, st, names = _serve(arch, profiler=True, tmp_path=tmp_path)
    assert tokens == plain
    cfg = get_config(arch, smoke=True)
    specs = cfg.block_specs()
    steps = st["decode_steps"]
    assert steps == NEW - 1
    forwards = 1 + steps
    mla = sum(s.mixer == ATTN_MLA for s in specs)
    moe = sum(s.ffn == FFN_MOE for s in specs)
    mamba = sum(s.mixer == MAMBA for s in specs)
    assert moe and (mla if arch.startswith("deepseek") else mamba)
    want = {"serve.prefill": 1, "serve.decode_step": steps,
            # the prefill attends in the kernel: MLA's spans are decode's
            "mla.expand": mla * steps, "mla.attend": mla * steps,
            "moe.route": moe * forwards, "moe.experts": moe * forwards,
            "moe.combine": moe * forwards, "mamba.scan": mamba * forwards}
    assert {n: names.count(n) for n in SPANS} == want


@pytest.mark.parametrize("arch", ARCHS)
def test_step_s_holds_one_host_time_a_decode_step(arch):
    _, st, _ = _serve(arch)
    assert len(st["step_s"]) == st["decode_steps"] == NEW - 1
    assert all(s > 0 for s in st["step_s"])
    assert sum(st["step_s"]) <= st["decode_s"]
