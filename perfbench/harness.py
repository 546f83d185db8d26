"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the reference, and the result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The system under test is ``repro_torch.serve.engine.ServeEngine`` serving
the cell's traffic over weights the benchmark draws from the seed.  The
window is a closed loop of ``generate`` calls, one batch each, that closes
at the end of the first block of batches (one batch of each of the mix's
prompt lengths, :mod:`perfbench.traffic`) that ends after ``--seconds``,
so that every window holds each length equally often; every rate divides
all of its work by that whole span.  With ``--trace 1`` the window
is followed by ``trace_batches`` more batches under ``torch.profiler``,
whose trace the per-layer metrics read.  Then the program's state is
freed and the reference checks a sample of the window's requests
(:mod:`perfbench.check`).  The last line of standard output is the result
as JSON; the numbers compared, each beside its limit, are the last lines
of standard error and the result's last key.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from typing import Dict, List, Optional

from perfbench import check, spec, traffic, weights

#: top-level module names that no run may hold once its window has closed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
#: new tokens a warm-up request asks for: the prefill and a decode step,
#: every shape a batch of its prompt length runs (the decode steps'
#: shapes do not change with the step: the cache is sized once)
WARMUP_NEW_TOKENS = 2


class Run:
    """What a run measured, for the metric readers (``metrics/*.py``)."""

    def __init__(self, config: dict):
        self.config = config
        self.setup_s = 0.0
        self.window_s = 0.0
        self.batches: List[Dict] = []      # the window's, in order
        self.peak_window_bytes: Optional[int] = None
        self.trace = None                  # perfbench.trace.Trace
        self.traced_s = 0.0
        self.trace_read_s = 0.0            # the profiler's stop and export
        self.traced_batches: List[Dict] = []
        self.calls: Dict[str, list] = {}   # kernel op -> recorded calls


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is one of
    :data:`FORBIDDEN_MODULES`."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN_MODULES})


def _serve_batch(eng, b: traffic.Batch, base_rid: int,
                 new_tokens: int = None) -> Dict:
    """One ``generate`` call over batch ``b`` (its requests asking for
    ``new_tokens``, by default the mix's); its stats, the host time of the
    call and each request's served tokens."""
    from repro_torch.serve import Request

    reqs = [Request(rid=base_rid + i, prompt=b.prompts[i],
                    max_new_tokens=new_tokens or b.new_tokens)
            for i in range(len(b.prompts))]
    n_stats = len(eng.stats)
    t0 = time.perf_counter()
    out = eng.generate(reqs)
    wall = time.perf_counter() - t0
    stats = eng.stats[n_stats:]
    if len(stats) != 1:
        raise RuntimeError(f"a batch of one length ran as {len(stats)} "
                           f"groups")
    st = dict(stats[0])
    return {**st, "index": b.index, "wall_s": wall, "end": t0 + wall,
            "tokens": [out[r.rid] for r in reqs]}


class _Recorder:
    """Wrappers of the port's kernel ops at their call sites, installed
    while the traced batches run: for each kernel-op file
    (:func:`perfbench.spec.kernel_ops`), the attribute ``ATTR`` of
    ``repro_torch.kernels.ops`` (which ``ops`` calls by that name) records
    each call by the file's ``record`` under its ``OP``."""

    def __init__(self):
        self.calls = collections.defaultdict(list)

    def __enter__(self):
        from repro_torch.kernels import ops

        self.ops = ops
        self.saved = []
        for f in spec.kernel_ops():
            inner = getattr(ops, f.ATTR)
            self.saved.append((f.ATTR, inner))
            setattr(ops, f.ATTR, self._wrap(f, inner))
        return self

    def _wrap(self, f, inner):
        calls = self.calls[f.OP]

        def op(*args, **kwargs):
            calls.append(f.record(*args, **kwargs))
            return inner(*args, **kwargs)
        return op

    def __exit__(self, *exc):
        for attr, inner in reversed(self.saved):
            setattr(self.ops, attr, inner)


def _traced(eng, mix, vocab, seed, start, run: Run, torch) -> None:
    """``trace_batches`` batches after the window under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from perfbench.trace import Trace

    torch.cuda.synchronize()
    with _Recorder() as rec, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(int(mix.get("trace_batches", 1))):
            b = traffic.batch(mix, vocab, seed, start + i)
            run.traced_batches.append(
                _serve_batch(eng, b, (start + i) * mix["batch"]))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        run.traced_s = t1 - t0
    run.calls = dict(rec.calls)
    run.trace = Trace.from_profiler(prof)
    run.trace_read_s = time.perf_counter() - t1


def _served_ok(tokens: list, n: int, vocab: int) -> bool:
    return len(tokens) == n and all(
        isinstance(t, int) and 0 <= t < vocab for t in tokens)


def execute(cell: Dict, seed: int, seconds: float, trace: int, device,
            t_process: float) -> Dict:
    """One run of ``cell`` (:func:`perfbench.spec.cell`) on ``device``;
    returns the result's fields, ``checks`` last."""
    import torch

    from repro_torch.models.config import ModelConfig
    from repro_torch.serve import ServeConfig, ServeEngine

    device = torch.device(device)
    on_card = device.type == "cuda"
    conf, mix, limits = cell["config"], cell["mix"], cell["limits"]
    run = Run(conf)
    cfg = ModelConfig(**conf["port"])
    weights.check_layers(cfg, conf["layers"])
    vocab, new = cfg.vocab, int(mix["new_tokens"])

    # -- set-up: weights, engine, one batch at each prompt length --------
    marks = {"imports_s": time.perf_counter() - t_process}
    tree, ref_w = weights.draw(cfg, seed, device, conf["layers"])
    if on_card:
        torch.cuda.synchronize()
    marks["weights_s"] = time.perf_counter() - t_process
    eng = ServeEngine(cfg, tree, ServeConfig(
        max_batch=int(mix["batch"]), max_len=traffic.max_len(mix),
        cache_dtype=getattr(torch, mix["cache_dtype"])))
    del tree
    for b in traffic.warmup_batches(mix, vocab, seed):
        _serve_batch(eng, b, 0, min(new, WARMUP_NEW_TOKENS))
    if on_card:
        torch.cuda.synchronize()
        peak_setup = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    run.setup_s = time.perf_counter() - t_process
    marks["warm_s"] = run.setup_s

    # -- the window ------------------------------------------------------
    t_w = time.perf_counter()
    i, block = 0, len(mix["prompt_lens"])
    while True:
        b = traffic.batch(mix, vocab, seed, i)
        run.batches.append(_serve_batch(eng, b, i * mix["batch"]))
        i += 1
        if run.batches[-1]["end"] - t_w >= seconds and i % block == 0:
            break
    run.window_s = run.batches[-1]["end"] - t_w
    peak = None
    if on_card:
        run.peak_window_bytes = torch.cuda.max_memory_allocated(device)
        if trace:
            _traced(eng, mix, vocab, seed, i, run, torch)
        peak = max(peak_setup, torch.cuda.max_memory_allocated(device))

    # -- the check against the reference -----------------------------------
    del eng
    if on_card:
        torch.cuda.empty_cache()
    finished, missing = [], 0
    for bt in run.batches:
        for row, toks in enumerate(bt["tokens"]):
            if _served_ok(toks, new, vocab):
                finished.append((bt["index"], row, bt["prompt_len"]))
            else:
                missing += 1
    picked = traffic.sample(mix, seed, finished)
    served = {(bt["index"], row): toks for bt in run.batches
              for row, toks in enumerate(bt["tokens"])}
    requests = [(traffic.batch(mix, vocab, seed, bi).prompts[row],
                 served[(bi, row)]) for bi, row, _ in picked]
    t_ref = time.perf_counter()
    read = check.gaps(conf, ref_w, requests, device)
    ref_s = time.perf_counter() - t_ref
    limit = float(limits["mean_gap"])
    gap = check.mean_gap(read)
    over_call = max(bt["ttft_s"] + bt["decode_s"] - bt["wall_s"]
                    for bt in run.batches)
    checks = {
        "mean_gap": {"value": gap, "limit": limit},
        "missing_requests": {"value": missing, "limit": 0},
        "stats_over_call_s": {"value": over_call, "limit": 0.0},
    }
    compared = gap is not None and gap <= limit
    correct = compared and missing == 0 and over_call <= 0.0
    # the comparison is over the sample: where it fails, each sampled
    # request counts as failed
    failed = missing + (0 if compared else len(requests))

    # -- metrics -----------------------------------------------------------
    t_metrics = time.perf_counter()
    metrics = {}
    for name, unit in cell["metrics"][trace]:
        value = spec.reader(name)(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    # where a run's wall time goes, for the cost of a check
    phases = {"setup_s": run.setup_s, "window_s": run.window_s,
              "traced_s": run.traced_s, "trace_read_s": run.trace_read_s,
              "reference_s": ref_s,
              "metrics_s": time.perf_counter() - t_metrics}
    result = {"correct": correct,
              "attempted": sum(len(bt["tokens"]) for bt in run.batches),
              "failed": failed, "metrics": metrics}
    if on_card:
        result["device"] = {"platform": "gpu",
                            "kind": torch.cuda.get_device_name(device),
                            "count": 1, "memory_peak_bytes": peak}
        if trace and run.trace is not None:
            result["device"]["busy_s"] = run.trace.busy_s()
            result["device"]["window_s"] = run.traced_s
            result["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                                   "idle_gaps": run.trace.idle_gaps()}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": None}
    every = [g for r in read for g in r["gaps"]]
    result["gaps"] = {"tokens": len(every),
                      "max": max(every) if every else None,
                      "share_over_0": (sum(g > 0 for g in every) / len(every)
                                       if every else None),
                      "reference_s": ref_s}
    result["setup_marks"] = marks
    phases["total_s"] = time.perf_counter() - t_process
    result["phases"] = phases
    result["checks"] = checks
    return result


def _args(argv):
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_process: float = None) -> int:
    t_process = time.perf_counter() if t_process is None else t_process
    args = _args(argv)
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"error: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    seed = args.seed % (1 << 63)
    result = execute(cell, seed, args.seconds, args.trace, "cuda:0",
                     t_process)
    loaded = forbidden_modules()
    if loaded:
        print(f"error: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
