#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA GPU and check it.

Run from the root of a checkout, on a machine with an NVIDIA Hopper GPU
and the CUDA toolkit::

    python3 chip_smoke.py

It builds the port's CUDA kernel from ``src/repro_torch/csrc/``, holds it
bit for bit against its plain torch version on the card, reproduces the
JAX package's golden artifacts with the ``torch`` executor on the card,
and runs the planner at the paper's co-exploration settings on the real
ResNet-50 netlist through the CLI entry point, requiring the result to be
byte-equal to the ``vector`` backend's.  Each phase prints one JSON line;
the last line is ``{"ok": true, "device": {...}}``.  Any failed phase
raises and the script exits non-zero without that line.  Without a CUDA
GPU, or outside a checkout of the repository, it exits 2.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
GOLDEN_DIR = ROOT / "tests" / "golden"
WORK_DIR = ROOT / "build" / "chip_smoke"

GOLDEN_CASES = tuple(
    f"{w}.{s}" for w in ("netlib_resnet50", "synthetic_layered24",
                         "file_diamond") for s in ("ga", "greedy")
) + ("synthetic_layered24.ga_full", "synthetic_layered24.ga_noc")

# batch sizes of the kernel-against-plain phase: empty, one lane, both
# sides of a 256-thread block, a large generation, and a million lanes
SIZES = (0, 1, 255, 256, 257, 4096, 1 << 20)

# the paper's co-exploration setting (benchmarks/common.py: population
# 500, 50,000 samples) on the full ResNet-50 netlist
FULL_RUN = ("explore", "--workload", "resnet50", "--strategy", "ga",
            "--metric", "energy", "--alpha", "0.002", "--hw-mode", "shared",
            "--budget", "50000", "--opt", "population=500")

# H100 SXM, NVIDIA's data sheet: HBM3 rate, and the float32 rate outside
# the tensor cores (the kernel's one float64 division per lane is counted
# against it; the bytes bound is larger by orders of magnitude anyway)
HBM_BYTES_PER_S = 3.35e12
PEAK_SCALAR_OPS_PER_S = 67e12
# bytes the function must move per lane: 5 int64 + 2 one-byte masks in,
# 5 int64 + 4 one-byte masks out
LANE_BYTES = 86
# integer and float operations per lane in the kernel body (counted from
# the source: one division, one float64 division and ceil, compares,
# selects, two products)
LANE_OPS = 20

KERNEL_SOURCE = "src/repro_torch/csrc/finish_batch.cu"
KERNEL_REPLACES = "src/repro/kernels/finish_batch.py:95"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# -- lanes --------------------------------------------------------------------

def guard_lanes() -> np.ndarray:
    """``[7, m]`` int64 lanes on the engine's guard boundaries: ``fp`` and
    ``w_total`` up to ``2**31 - 1``, ``glb`` at 0, 1 and ``2**53 - 1``,
    ``share`` 1 to 4, both masks, plus exact multiples of ``glb``."""
    top31, top53 = (1 << 31) - 1, (1 << 53) - 1
    rows = []
    for fp, w_total, glb, share, single, shared, wbuf in itertools.product(
            (0, 1, 4095, 12288, 12289, top31), (0, 1000, top31),
            (0, 1, 4096, top31, top53), (1, 2, 3, 4), (0, 1), (0, 1),
            (0, top53)):
        rows.append((fp, w_total, single, glb, wbuf, shared, share))
    return np.array(rows, dtype=np.int64).T.copy()


def make_lanes(n: int, seed: int = 0) -> np.ndarray:
    """``[7, n]`` int64 lanes: seeded random lanes whose magnitudes spread
    over every scale the guards admit, with the guard-boundary lanes woven
    into the even positions."""
    rng = np.random.default_rng(seed)

    def log_uniform(bits):
        return (2.0 ** rng.uniform(0, bits, n)).astype(np.int64) - 1

    lanes = np.stack([
        log_uniform(31),                          # fp
        log_uniform(31),                          # w_total
        rng.integers(0, 2, n),                    # single
        log_uniform(40),                          # glb
        log_uniform(40),                          # wbuf
        rng.integers(0, 2, n),                    # shared
        rng.integers(1, 5, n),                    # share
    ]).astype(np.int64)
    guard = guard_lanes()
    even = np.arange(0, n, 2)
    lanes[:, even] = guard[:, even // 2 % guard.shape[1]]
    return np.ascontiguousarray(lanes)


# -- phases -------------------------------------------------------------------

def phase_device() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0]
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi_line,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.build("finish_batch")
    _build.load("finish_batch")
    emit({"phase": "build", "kernel": "finish_batch",
          "library": str(path.relative_to(ROOT)),
          "seconds": time.perf_counter() - t0})


def phase_kernel_vs_plain() -> float:
    """The kernel against its plain torch version on the same card
    tensors, bitwise, at every size in :data:`SIZES`."""
    import torch

    from repro_torch.kernels import finish_batch as fb

    max_err = 0
    for n in SIZES:
        lanes = torch.from_numpy(make_lanes(n, seed=n)).cuda()
        got = fb.finish_lanes(lanes)
        want = fb.finish_lanes_plain(lanes)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        err = int((got - want).abs().max()) if n else 0
        max_err = max(max_err, err)
        emit({"phase": "kernel_vs_plain", "n": n, "bitwise_equal": equal,
              "max_abs_err": err})
        if not equal:
            raise AssertionError(f"finish_batch kernel != plain at n={n}")
    empty = fb.finish_cost_batch(*(np.zeros(0, np.int64),) * 7,
                                 device="cuda")
    if len(empty) != 9 or any(len(a) for a in empty):
        raise AssertionError("an empty batch must give 9 empty arrays")
    return max_err


def _golden_spec(case: str):
    from repro_torch.bridge import spec_from_reference

    doc = json.loads((GOLDEN_DIR / f"{case}.json").read_text())
    return doc, spec_from_reference(json.dumps(doc["spec"]))


def phase_golden() -> None:
    """The JAX package's golden artifacts, reproduced with the torch
    executor on the card."""
    from repro_torch.api import build_workload, run
    from repro_torch.bridge import result_to_reference_dict
    from repro_torch.core import CachedEvaluator, TorchExecutor
    from repro_torch.kernels import finish_batch as fb
    from repro_torch.obs import Recorder, recording

    for case in GOLDEN_CASES:
        golden, spec = _golden_spec(case)
        g = build_workload(spec.workload)
        ev = CachedEvaluator(g, out_tile=spec.out_tile,
                             executor=TorchExecutor("cuda"))
        rec = Recorder()
        fb.launches = 0
        with recording(rec):
            res = run(spec, graph=g, ev=ev)
        launches = fb.launches
        batches = rec.counters.get("engine.array_batches", 0)
        equal = result_to_reference_dict(res) == golden
        emit({"phase": "golden", "case": case, "equal": equal,
              "launches": launches, "array_batches": batches})
        if not equal:
            raise AssertionError(f"golden {case} not reproduced on the card")
        # greedy costs one subgraph at a time and hands the kernel no batch
        if launches != batches or (launches == 0) != case.endswith("greedy"):
            raise AssertionError(
                f"golden {case}: {launches} launches for {batches} batches")


def _device_activity(prof) -> dict:
    """What ran on the card in a ``torch.profiler`` trace: the union of
    the intervals of every device event (kernels and copies), so that
    overlapping events count once, and the events of each kind."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, covered_to = 0.0, float("-inf")
    for start, end in sorted((e.time_range.start, e.time_range.end)
                             for e in events):
        if end > covered_to:
            busy_us += end - max(start, covered_to)
            covered_to = end
    kernel = [e for e in events if "finish_batch_kernel" in e.name]
    copies = [e for e in events if "Memcpy" in e.name]
    return {
        "device_events": len(events),
        "device_busy_ms": busy_us / 1e3,
        "traced_kernel_launches": len(kernel),
        "traced_kernel_ms": sum(e.time_range.elapsed_us()
                                for e in kernel) / 1e3,
        "traced_copies": len(copies),
        "traced_copy_ms": sum(e.time_range.elapsed_us()
                              for e in copies) / 1e3,
    }


def phase_full_run() -> dict:
    """The paper-scale ResNet-50 co-exploration through the CLI entry, on
    the torch backend under ``torch.profiler``, then the same spec on the
    vector backend."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import ExploreResult, cli
    from repro_torch.kernels import finish_batch as fb
    from repro_torch.obs import Recorder, recording

    WORK_DIR.mkdir(parents=True, exist_ok=True)
    spec_path = WORK_DIR / "full_spec.json"
    out_torch = WORK_DIR / "full_torch.json"
    out_vector = WORK_DIR / "full_vector.json"
    rec = Recorder()
    fb.launches = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with recording(rec):
            rc = cli.main(["--device", "cuda", *FULL_RUN, "--profile",
                           "--save-spec", str(spec_path), "--out",
                           str(out_torch)])
        wall = time.perf_counter() - t0
    launches = fb.launches
    activity = _device_activity(prof)
    if rc != 0:
        raise AssertionError(f"full run exited {rc}")
    t0 = time.perf_counter()
    rc = cli.main(["--device", "cuda", "explore", "--spec", str(spec_path),
                   "--eval-backend", "vector", "--out", str(out_vector)])
    wall_vector = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"vector run exited {rc}")
    # --profile attaches wall-clock timings to meta; everything else must
    # be byte-equal to the vector backend's artifact
    res = ExploreResult.from_json(out_torch.read_text())
    res.meta.pop("profile")
    byte_equal = res.to_json(indent=2) == out_vector.read_text()
    c = rec.counters
    batches = c.get("engine.array_batches", 0)
    kernel_ms = c.get("kernel.finish_batch.kernel_ms", 0.0)
    out = {
        "phase": "full_run", "args": list(FULL_RUN),
        "budget_cut": None,
        "wall_s": wall, "wall_vector_s": wall_vector,
        "distinct_evaluations": res.evaluations,
        "lookups": c.get("evaluator.lookups", 0),
        "kernel_launches": launches,
        "array_batches": batches,
        "scalar_fallback": c.get("engine.scalar_fallback", 0),
        "mean_batch_lanes": c.get("engine.array_lanes", 0) / max(batches, 1),
        "kernel_ms": kernel_ms,
        "kernel_share_of_wall": kernel_ms / 1e3 / wall,
        "h2d_ms": c.get("kernel.finish_batch.h2d_ms", 0.0),
        "d2h_ms": c.get("kernel.finish_batch.d2h_ms", 0.0),
        "structure_derive_s": c.get("evaluator.structure_derive_s", 0.0),
        "structure_misses": c.get("evaluator.structure_misses", 0),
        **activity,
        # None when the trace shows no device activity at all
        "device_idle_share": (1.0 - activity["device_busy_ms"] / 1e3 / wall
                              if activity["device_events"] else None),
        "cost": res.cost,
        "byte_equal_to_vector": byte_equal,
    }
    emit(out)
    if not byte_equal:
        raise AssertionError("torch and vector results differ")
    if launches == 0 or launches != batches:
        raise AssertionError(
            f"full run: {launches} launches for {batches} batches")
    return out


def _events_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` back-to-back
    calls on the current stream, after a warm-up, from CUDA events."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _profiled_kernel_ms(fn, reps: int):
    """Device time per launch of the CUDA kernel from ``torch.profiler``,
    or ``None`` when the profiler shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for evt in prof.key_averages():
        if "finish_batch_kernel" in evt.key:
            total_us += getattr(evt, "device_time_total",
                                getattr(evt, "cuda_time_total", 0.0))
    return total_us / 1e3 / reps if total_us > 0 else None


def phase_timing(n: int) -> dict:
    """The kernel and its plain version at ``n`` lanes on the card."""
    import torch

    from repro_torch.kernels import finish_batch as fb

    lanes = torch.from_numpy(make_lanes(n, seed=1)).cuda()
    reps = 2000 if n < 100_000 else 50
    ms = _events_ms(lambda: fb.finish_lanes(lanes), reps)
    plain_ms = _events_ms(lambda: fb.finish_lanes_plain(lanes), reps)
    device_ms = _profiled_kernel_ms(lambda: fb.finish_lanes(lanes),
                                    min(reps, 200))
    bytes_s = n * LANE_BYTES / HBM_BYTES_PER_S
    ops_s = n * LANE_OPS / PEAK_SCALAR_OPS_PER_S
    out = {"phase": "timing", "n": n, "ms": ms, "device_ms": device_ms,
           "plain_ms": plain_ms, "bound_ms": max(bytes_s, ops_s) * 1e3,
           "bound_by": "bytes" if bytes_s >= ops_s else "operations"}
    emit(out)
    return out


def main() -> int:
    if not (SRC / "repro_torch").is_dir() or not GOLDEN_DIR.is_dir():
        print("error: chip_smoke.py runs from the root of a checkout of the "
              "repository (src/repro_torch and tests/golden are missing)",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("error: chip_smoke.py needs a CUDA GPU and none is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    os.chdir(ROOT)  # the golden file: workload is a repo-relative path

    device = phase_device()
    phase_build()
    max_err = phase_kernel_vs_plain()
    phase_golden()
    full = phase_full_run()
    main_n = max(1, round(full["mean_batch_lanes"]))
    timing = phase_timing(main_n)
    phase_timing(1 << 20)

    launches = full["kernel_launches"]
    emit({"kernels": [{
        "name": "finish_batch",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "bitwise_equal": max_err == 0,
        "max_abs_err": max_err,
        "n": main_n,
        "ms": timing["ms"],
        "device_ms": timing["device_ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
    }]})
    print(device["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": device["name"],
                                 "count": device["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
