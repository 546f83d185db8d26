"""Pins that finding the mechanisms and kernel ops by their files moved no
number the benchmark reads.  ``pins.json`` beside this file was written by
the code before they were files (``python -m perfbench.tests.
test_perfbench_pins`` there): a digest of every drawn leaf and the
reference's logits at smoke widths, ``counts.batch_flops`` of each cell at
its published keys, ``roofline.work`` of every call shape the cells'
traced runs record, and the readings of the roofline, FLOP and launch
metrics on a trace made from those calls.  All held exactly."""

import hashlib
import json
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.models.config import ModelConfig

from perfbench import counts, harness, reference, roofline, spec, weights
from perfbench.tests import smoke_cells
from perfbench.trace import Trace

PINS = Path(__file__).resolve().parent / "pins.json"
ARCHS = ("deepseek-v2-236b", "jamba-v0.1-52b")
CELLS = ("deepseek_v2_4l.prefill_short", "jamba_8l.prefill_short",
         "deepseek_v2_4l.decode_long")
SEED = 2**31 + 9
#: the metrics read from the made-up trace
READ = ("b2_roofline", "b3_roofline", "b4_roofline", "serve_mfu",
        "launches_per_forward", "device_idle_share")
MAIN = (1, 1)


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{pre}/{k}" if pre else k)
    else:
        yield pre, tree


def digest(t: torch.Tensor) -> str:
    """The first 32 hex digits of the sha256 of ``t``'s dtype, shape and
    bytes."""
    t = t.detach().contiguous()
    h = hashlib.sha256(f"{t.dtype} {list(t.shape)}".encode())
    raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    h.update(raw.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:32]


def drawn(arch):
    conf = smoke_cells.config(arch)
    cfg = ModelConfig(**conf["port"])
    tree, w = weights.draw(cfg, SEED, "cpu")
    return conf, cfg, tree, w


def logits(conf, cfg, w):
    """(fp32, fp8) logits over 3 sequences of 28 tokens, 20 of prompt."""
    toks = torch.randint(0, cfg.vocab, (3, 28),
                         generator=torch.Generator().manual_seed(4))
    rows = list(range(19, 28))
    with torch.no_grad():
        return (reference.forward(conf, w, toks, 20, rows),
                reference.forward(conf, w, toks, 20, rows, quant="fp8"))


def _call(op, call):
    """A call as the recorder holds it, from its JSON form."""
    if op == "repro_torch::flash_attention":
        return (tuple(call[0]),) + tuple(call[1:])
    return tuple(call)


def fixture_run(cell: str, calls: dict):
    """A run of ``cell``'s configuration whose window and traced block are
    one batch at each prompt length of its mix, and whose trace holds,
    for each recorded call (``calls``: op -> [[call, count], ...]), the
    op's host span, one launch inside it and one kernel of a made-up
    duration, one after the other.  The durations are not a card's (some
    shares read above 100 %): the readings pin the arithmetic."""
    c = spec.cell(cell)
    mix = c["mix"]
    run = harness.Run(c["config"])
    run.batches = [{"batch": mix["batch"], "prompt_len": p,
                    "decode_steps": mix["new_tokens"] - 1}
                   for p in mix["prompt_lens"]]
    run.traced_batches = list(run.batches)
    run.window_s = 1.25 * len(mix["prompt_lens"])
    device, host, run.calls = [], [], {}
    ts, corr = 0.0, 0
    for op in sorted(calls):
        run.calls[op] = []
        for call, n in calls[op]:
            for _ in range(n):
                corr += 1
                dur = 5.0 + corr % 13
                host.append((op, "cpu_op", MAIN, ts, dur + 4.0, None))
                host.append(("cudaLaunchKernel", "cuda_runtime", MAIN,
                             ts + 1.0, 1.0, corr))
                device.append((f"kernel{corr % 5}", "kernel", ts + 2.0, dur,
                               corr))
                ts += dur + 6.0 + corr % 3
                run.calls[op].append(_call(op, call))
    run.trace = Trace(device, host)
    run.traced_s = ts * 1.5e-6
    return run


def readings(cell: str, calls: dict) -> dict:
    run = fixture_run(cell, calls)
    return {m: spec.reader(m)(run) for m in READ}


def pins(calls: dict) -> dict:
    """Every pinned number, from the code this runs on; ``calls``: cell ->
    op -> [[call, count], ...], the traced runs' recorded calls."""
    torch.set_num_threads(2)
    out = {"weights": {}, "logits": {}, "batch_flops": {}, "work": {},
           "readings": {}, "calls": calls}
    for arch in ARCHS:
        conf, cfg, tree, w = drawn(arch)
        out["weights"][arch] = {k: digest(t) for k, t in _flat(tree)}
        out["logits"][arch] = [digest(t) for t in logits(conf, cfg, w)]
    for cell in CELLS:
        c = spec.cell(cell)
        mix = c["mix"]
        out["batch_flops"][cell] = {
            str(p): counts.batch_flops(c["config"], mix["batch"], p,
                                       mix["new_tokens"] - 1)
            for p in mix["prompt_lens"]}
        out["readings"][cell] = readings(cell, calls[cell])
        for op, seen in calls[cell].items():
            for call, _ in seen:
                w, dt = roofline.work(op, _call(op, call))
                out["work"].setdefault(op, {})[json.dumps(call)] = [
                    w["flops"], w["bytes"], dt,
                    counts.least_seconds(w, dt)]
    return out


PINNED = json.loads(PINS.read_text()) if PINS.exists() else None


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_is_drawn_as_pinned(arch):
    _, _, tree, _ = drawn(arch)
    assert {k: digest(t) for k, t in _flat(tree)} == PINNED["weights"][arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_the_reference_logits_are_pinned_bit_for_bit(arch):
    conf, cfg, _, w = drawn(arch)
    assert [digest(t) for t in logits(conf, cfg, w)] == \
        PINNED["logits"][arch]


@pytest.mark.parametrize("cell", CELLS)
def test_batch_flops_are_pinned(cell):
    c = spec.cell(cell)
    mix = c["mix"]
    for p in mix["prompt_lens"]:
        assert counts.batch_flops(c["config"], mix["batch"], p,
                                  mix["new_tokens"] - 1) == \
            PINNED["batch_flops"][cell][str(p)]


@pytest.mark.parametrize("op", ["repro_torch::flash_attention",
                                "repro_torch::fused_swiglu",
                                "repro_torch::fused_rmsnorm"])
def test_roofline_work_at_the_recorded_shapes_is_pinned(op):
    assert PINNED["work"][op]
    for call, (flops, nbytes, dt, least) in PINNED["work"][op].items():
        w, got_dt = roofline.work(op, _call(op, json.loads(call)))
        assert (w["flops"], w["bytes"], got_dt) == (flops, nbytes, dt)
        assert counts.least_seconds(w, got_dt) == least


@pytest.mark.parametrize("cell", CELLS)
def test_readings_on_a_recorded_trace_are_pinned(cell):
    assert readings(cell, PINNED["calls"][cell]) == \
        PINNED["readings"][cell]


if __name__ == "__main__":
    # python -m perfbench.tests.test_perfbench_pins CALLS.json > pins.json
    print(json.dumps(pins(json.loads(Path(sys.argv[1]).read_text())),
                     indent=1))
