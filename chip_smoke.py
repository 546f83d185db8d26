#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA GPU and check it.

Run from the root of a checkout, on a machine with an NVIDIA Hopper GPU
and the CUDA toolkit::

    python3 chip_smoke.py

It builds the port's four CUDA kernels from ``src/repro_torch/csrc/`` (one
``nvcc`` each, all at once) and drives both paths of the port:

* the planner: the streaming-block kernel bit for bit against its plain
  torch version, on card tensors and as a planner batch from NumPy to
  NumPy (zero copy: the kernel reads and writes pinned host memory), the
  JAX package's golden artifacts reproduced with the
  ``torch`` executor on the card, and the planner at the paper's
  co-exploration settings on the real ResNet-50 netlist through the CLI
  entry point, byte-equal to the ``vector`` backend's result;
* LM serving: the RMSNorm, fused SwiGLU and flash-attention kernels against
  their plain versions in bf16 and fp32 at the serving shapes, at ragged
  ones and across each kernel's tile edges; serving at the full width of
  tinyllama-1.1b in bf16 with a bf16 cache (the weights and prompts
  ``python -m repro_torch.launch.serve`` makes) and ``launch.serve`` itself
  at its defaults (fp32 cache) on a short run, each with every kernel's
  launches held to the count the model's structure implies; an fp32
  forward and greedy decode on the card against the same on the CPU;
* the hybrid and MoE layers: one 8-layer slice of jamba-v0.1-52b at its
  published widths (Mamba, attention, 16 experts x d_ff 14,336) served in
  bf16 with a bf16 cache, every expert through the fused SwiGLU kernel,
  launches held to the structure; the jamba and arctic smoke configs in
  fp32 on the card against the CPU (logits, router choices, greedy
  tokens), and ``launch.serve`` on jamba's smoke config;
* MLA and the xLSTM mixers: deepseek-v2-236b at its published widths cut
  to 4 layers (MLA's 128 heads through the flash-attention kernel, q/k and
  v padded to 256 columns; 160 routed experts and 2 shared through the
  fused SwiGLU kernel) and xlstm-350m at full width and depth, each served
  as jamba is; both smoke configs in fp32 on the card against the CPU, and
  ``launch.serve`` on each.

Last it times every kernel beside its plain version, its bound and the
library call where one computes the same function; a call that moves
more than a few MB is also timed over enough input sets to exceed twice
the L2, so that it reads from device memory, and the planner's batch is
timed from NumPy to NumPy beside the host link's measured rate.

Each phase prints one JSON line; the last line is
``{"ok": true, "device": {...}}``.  Any failed phase raises and the script
exits non-zero without that line.  Without a CUDA GPU, or outside a
checkout of the repository, it exits 2.  ``--only PHASE,...`` runs a subset
(for development; the full run takes no arguments).
"""

from __future__ import annotations

import argparse
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

# the LM kernels: library name -> (entry in the kernels line, the TPU kernel
# it replaces, the names of its device kernels in a profiler trace)
LM_KERNELS = {
    "rmsnorm": ("rmsnorm", "src/repro/kernels/rmsnorm.py:13",
                ("rmsnorm_kernel",)),
    "fused_ffn": ("fused_swiglu", "src/repro/kernels/fused_ffn.py:31",
                  ("ffn_hidden", "ffn_out")),
    "flash_attention": ("flash_attention",
                        "src/repro/kernels/flash_attention.py:38",
                        ("flash_attn_",)),
}
# H100 SXM dense bf16 tensor-core rate, NVIDIA's data sheet
PEAK_BF16_OPS_PER_S = 989e12
# tests/test_kernels.py's tolerances, by dtype
LM_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# B4's kernel-against-plain cases, (M, d, x's storage offset in elements):
# the serving path's shapes (8 x 512 and 4 x 200 prefill, batch-8 decode)
# at tinyllama-1.1b's width, ragged ones, qk-norm's head widths, and both
# routes: 16-byte units (rows held in registers, or read twice past 2,048
# units a row) and single elements (d * itemsize % 16 != 0, or x one
# element off a 16-byte boundary)
RMS_CASES = ((4096, 2048, 0), (800, 2048, 0), (8, 2048, 0), (4095, 2048, 0),
             (3, 200, 0), (4096, 64, 0), (4096, 128, 0), (300, 256, 0),
             (8, 5632, 0), (4, 20000, 0), (5, 2047, 0), (800, 2048, 1),
             (8, 5632, 1), (4096, 4096, 0),
             # deepseek's (d 5120, q_norm 1536, kv_norm 512) and xlstm's
             # (d 1024, mLSTM out_norm 2048) at an 8 x 512 prefill and
             # batch-8 decode
             (4096, 5120, 0), (8, 5120, 0), (4096, 1536, 0), (8, 1536, 0),
             (4096, 512, 0), (8, 512, 0), (4096, 1024, 0), (8, 1024, 0))
# B3 at M on both sides of the small/large-M tile threshold (16) and of
# the large tiles' 128 rows, the prefill and decode shapes, and a ragged
# shape (no TMA: the small tiles at any M)
FFN_CASES = tuple((m, 2048, 5632) for m in (1, 4, 8, 16, 63, 64, 65, 129,
                                            800, 4096)) + ((77, 200, 300),)
# B3 at jamba-v0.1-52b's width (d 4096, d_ff 14,336), bf16: decode at
# batch 8, one expert's rows at an 8 x 512 prefill (B * C = 8 * 80) and a
# dense FFN's at that prefill
JAMBA_FFN_CASES = tuple((m, 4096, 14336) for m in (8, 640, 4096))
# B3 at deepseek-v2-236b's widths, bf16: an expert (d 5120, d_ff 1536) and
# the dense first layer (d_ff 12,288); one expert's rows at an 8 x 512
# prefill (B * C = 8 * 24), decode at batch 8 and the dense prefill's rows
DEEPSEEK_FFN_CASES = tuple((m, 5120, f) for f in (1536, 12288)
                           for m in (192, 8, 4096))
# B2 under MLA's contract, (B, H, S, q/k width, v width, dtype): q and k
# zero-padded from dh + rope to 256 columns (16 + 8 to 32 at the smoke
# widths), v from its width, scale 1/sqrt(q/k width); deepseek's 8 x 512
# prefill in bf16 and the smoke prefill in fp32
MLA_ATTN_CASES = ((8, 128, 512, 192, 128, "bfloat16"),
                  (1, 4, 64, 24, 16, "float32"))
# (B, H, Hkv, S, d, causal, window): the serving shapes and ragged ones
ATTN_CASES = ((8, 32, 4, 512, 64, True, 0), (4, 32, 4, 200, 64, True, 0),
              (8, 32, 8, 512, 128, True, 0),  # jamba's attention
              (2, 4, 4, 130, 32, True, 48), (1, 2, 2, 100, 128, False, 0),
              (1, 2, 1, 70, 256, True, 0), (2, 2, 2, 33, 16, True, 0))
# B2's tile edges (64 queries, 64 keys): every S, with and without a window
# (40 keys: its edge falls inside tiles), every head dim, and Hkv of 1, H/8
# and H query heads' worth, causal, at B 1, H 16
ATTN_SWEEP_S = (1, 63, 64, 65, 127, 128, 129, 200, 512, 1024)
ATTN_SWEEP = tuple((1, 16, hkv, s, d, True, w) for s in ATTN_SWEEP_S
                   for w in (0, 40) for d in (16, 32, 64, 128, 256)
                   for hkv in (1, 2, 16))

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
    """One ``nvcc`` per source, all started together; ptxas's register,
    shared-memory and spill lines for each kernel."""
    from repro_torch.kernels import _build

    names = ["finish_batch", *LM_KERNELS]
    t0 = time.perf_counter()
    paths = _build.build_all(names)
    for name in names:
        _build.load(name)
    emit({"phase": "build", "kernels": names,
          "libraries": [str(paths[n].relative_to(ROOT)) for n in names],
          "seconds": time.perf_counter() - t0,
          "ptxas": {n: [line.split("ptxas info    : ")[-1].strip()
                        for line in _build.ptxas_report(n).splitlines()
                        if "Used" in line or "spill" in line
                        or "Compiling" in line]
                    for n in names}})


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
    return max(max_err, _batches_vs_plain())


def _as_args(lanes: np.ndarray) -> tuple:
    """``[7, n]`` int64 lanes -> the seven arrays ``finish_cost_batch``
    takes (the masks as bool)."""
    fp, w_total, single, glb, wbuf, shared, share = lanes
    return (fp, w_total, single.astype(bool), glb, wbuf, shared.astype(bool),
            share)


def _batches_vs_plain() -> int:
    """``finish_cost_batch`` from NumPy to NumPy on the card (zero copy),
    bitwise against the plain version on the CPU: at one lane, the
    planner's batch size, either side of the staging buffers' first size
    (1,024 lanes; the next batch grows them), a million lanes and the
    guard-boundary lanes; and two successive batches' results do not
    share memory."""
    from repro_torch.kernels import finish_batch as fb

    cases = [(n, make_lanes(n, seed=n)) for n in (1, 185, 1024, 1025,
                                                 1 << 20)]
    cases.append(("guard", guard_lanes()))
    max_err = 0
    for n, lanes in cases:
        args = _as_args(lanes)
        want = fb.finish_cost_batch(*args, device="cpu")
        got = fb.finish_cost_batch(*args, device="cuda")
        equal = all(g.dtype == w.dtype and np.array_equal(g, w)
                    for g, w in zip(got, want))
        err = max(int(np.abs(g.astype(np.int64) - w.astype(np.int64))
                      .max()) for g, w in zip(got, want))
        max_err = max(max_err, err)
        emit({"phase": "kernel_vs_plain", "via": "finish_cost_batch",
              "n": n if n != "guard" else lanes.shape[1],
              "guard_lanes": n == "guard", "bitwise_equal": equal,
              "max_abs_err": err})
        if not equal:
            raise AssertionError(f"finish_cost_batch != plain at n={n}")
    first = fb.finish_cost_batch(*_as_args(make_lanes(185, seed=5)))
    second = fb.finish_cost_batch(*_as_args(make_lanes(185, seed=6)))
    if any(np.shares_memory(a, b) for a in first for b in second):
        raise AssertionError("two batches' results share memory")
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


def _device_activity(prof, kernel_names=("finish_batch_kernel",)) -> dict:
    """What ran on the card in a ``torch.profiler`` trace: the union of
    the intervals of every device event (kernels and copies), so that
    overlapping events count once, and the events of each kind (the
    port's kernels: names containing one of ``kernel_names``)."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, covered_to = 0.0, float("-inf")
    for start, end in sorted((e.time_range.start, e.time_range.end)
                             for e in events):
        if end > covered_to:
            busy_us += end - max(start, covered_to)
            covered_to = end
    kernel = [e for e in events if any(n in e.name for n in kernel_names)]
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
    # the zero-copy launches, the host link's crossing included
    zero_copy_ms = c.get("kernel.finish_batch.zero_copy_ms", 0.0)
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
        "zero_copy_ms": zero_copy_ms,
        "zero_copy_share_of_wall": zero_copy_ms / 1e3 / wall,
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


def _events_ms(fn, reps: int, sets=((),)) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` back-to-back
    calls on the current stream, after a warm-up, from CUDA events.  Call
    ``i`` takes the arguments ``sets[i % len(sets)]``; with more than one
    set, the last ``len(sets)`` outputs are kept alive, so that outputs
    rotate through fresh memory as the inputs do."""
    import torch

    keep = [None] * len(sets) if len(sets) > 1 else None
    for i in range(max(3, len(sets))):
        out = fn(*sets[i % len(sets)])
        if keep:
            keep[i % len(keep)] = out
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        out = fn(*sets[i % len(sets)])
        if keep:
            keep[i % len(keep)] = out
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _host_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the host clock, after a
    warm-up; for calls that end by waiting for the card."""
    for _ in range(3):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def _link_rates() -> dict:
    """Host-to-device and device-to-host rates of the host link in bytes/s,
    from one 256 MiB copy each way between pinned host memory and the card
    (CUDA events, after a warm-up copy)."""
    import torch

    nbytes = 256 << 20
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    rates = {}
    for name, dst, src in (("h2d", dev, host), ("d2h", host, dev)):
        dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(src, non_blocking=True)
        end.record()
        end.synchronize()
        rates[name] = nbytes / (start.elapsed_time(end) / 1e3)
    return rates


def phase_timing(n: int, link: dict) -> dict:
    """The kernel and its plain version at ``n`` lanes on the card; and the
    round trip of a batch, ``finish_cost_batch`` from NumPy to NumPy (zero
    copy), beside its bound: the bytes the function takes and gives
    (:data:`LANE_BYTES` a lane, 42 in and 44 out) over the host link's
    rates in ``link``."""
    import torch

    from repro_torch.kernels import finish_batch as fb

    lanes_np = make_lanes(n, seed=1)
    lanes = torch.from_numpy(lanes_np).cuda()
    reps = 2000 if n < 100_000 else 50
    ms = _events_ms(lambda: fb.finish_lanes(lanes), reps)
    plain_ms = _events_ms(lambda: fb.finish_lanes_plain(lanes), reps)
    device_ms = _profiled_ms(lambda: fb.finish_lanes(lanes), min(reps, 200),
                             ("finish_batch_kernel",))
    bytes_s = n * LANE_BYTES / HBM_BYTES_PER_S
    ops_s = n * LANE_OPS / PEAK_SCALAR_OPS_PER_S
    args = _as_args(lanes_np)
    roundtrip = _host_ms(lambda: fb.finish_cost_batch(*args),
                         2000 if n < 100_000 else 10)
    out = {"phase": "timing", "n": n, "ms": ms, "device_ms": device_ms,
           "plain_ms": plain_ms, "bound_ms": max(bytes_s, ops_s) * 1e3,
           "bound_by": "bytes" if bytes_s >= ops_s else "operations",
           "roundtrip_ms": roundtrip,
           "roundtrip_bound_ms": (42 * n / link["h2d"]
                                  + 44 * n / link["d2h"]) * 1e3,
           "link_bytes_per_s": link}
    emit(out)
    return out


# -- LM serving ---------------------------------------------------------------

# the serve phase's main runs: what python -m repro_torch.launch.serve makes
# for tinyllama-1.1b at full width (22 layers, d 2048, 32 heads / 4 KV heads,
# d_ff 5632, vocab 32000; bf16 compute, random weights from seed 0, max
# batch 8, 32 new tokens) served with a bf16 cache, the configuration
# PERF.md describes: 8 requests of 512 tokens, then 4 of 200 (a length no
# tile divides).  (requests, prompt length)
SERVE_ARCH, SERVE_SEED, SERVE_MAX_BATCH, SERVE_NEW_TOKENS = \
    "tinyllama-1.1b", 0, 8, 32
SERVE_RUNS = ((8, 512), (4, 200))
# and launch.serve.main itself at its defaults (the reference's fp32
# cache) on a short run
SERVE_CLI_ARGS = ("--device", "cuda", "--arch", "tinyllama-1.1b",
                  "--requests", "2", "--prompt-len", "64", "--new-tokens",
                  "8")
# serve_vs_cpu: logits of the fp32 forward on the card (kernels) and on
# the CPU (plain versions).  Both are fp32; they differ in summation order
# over depths up to 5,632 through 22 layers, O(1e-5) on logits of unit
# scale, so 1e-3 absolute + 1e-3 relative separates that from any fault
SERVE_VS_CPU_TOL = 1e-3
# serve_hybrid: jamba-v0.1-52b at its published widths (d 4096, 32 / 8 KV
# heads, d_head 128, 16 experts top-2 at d_ff 14,336, Mamba expand 2,
# d_state 16, d_conv 4, vocab 65,536) cut to one 8-layer slice of its 32
# layers (at full depth its 52 B parameters, ~104 GB in bf16, do not fit
# one 80 GB card): 7 Mamba layers and 1 attention layer, 4 MoE and 4 dense
# FFNs.  bf16 with a bf16 cache, random weights from seed 0 drawn on the
# card, served as SERVE_RUNS
HYBRID_ARCH, HYBRID_LAYERS = "jamba-v0.1-52b", 8
# hybrid_vs_cpu: the smoke configs of the hybrid and MoE archs in fp32, as
# serve_vs_cpu; then launch.serve.main at its defaults on jamba's
HYBRID_VS_CPU_ARCHS = ("jamba-v0.1-52b", "arctic-480b")
# serve_mla: deepseek-v2-236b at its published widths (d 5120, 128 heads,
# q_lora 1536, kv_lora 512, rope 64, v 128; 160 experts top-6 at d_ff 1536,
# 2 shared; first layer dense at d_ff 12,288; vocab 102,400) cut to 4 of
# its 60 layers, the model's whole layout (a dense prefix layer and the
# period-1 MoE body); at full depth its 236 B parameters, ~471 GB in bf16,
# do not fit one 80 GB card.  serve_xlstm: xlstm-350m at full width and
# depth (24 layers, d 1024, 4 heads, 18 mLSTM and 6 sLSTM).  Both bf16
# with a bf16 cache, random weights from seed 0 drawn on the card, served
# as SERVE_RUNS
MLA_ARCH, MLA_LAYERS = "deepseek-v2-236b", 4
XLSTM_ARCH = "xlstm-350m"
# mla_xlstm_vs_cpu: their smoke configs in fp32, as hybrid_vs_cpu; then
# launch.serve.main at its defaults on each
MLA_XLSTM_VS_CPU_ARCHS = (MLA_ARCH, XLSTM_ARCH)


def _lm_counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import rmsnorm as rn

    return {"rmsnorm": rn, "fused_ffn": ff, "flash_attention": fa}


def _check_tokens(what, tokens, n, new_tokens, vocab) -> None:
    if sorted(tokens) != list(range(n)) or any(
            len(t) != new_tokens or not all(0 <= x < vocab for x in t)
            for t in tokens.values()):
        raise AssertionError(f"{what}: not {new_tokens} in-vocab tokens for "
                             f"each of {n} requests")


def _serve(cfg, values, reqs, scfg) -> tuple:
    """``reqs`` served by ``ServeEngine`` over ``values`` at ``scfg`` with a
    bf16 cache; its requests' tokens and its groups' stats."""
    import dataclasses

    import torch

    from repro_torch.launch import serve
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(cfg, values, dataclasses.replace(
        scfg, cache_dtype=torch.bfloat16))
    tokens = eng.generate(reqs)
    _check_tokens(f"{cfg.name} {len(reqs)} x {len(reqs[0].prompt)}", tokens,
                  len(reqs), SERVE_NEW_TOKENS, cfg.vocab)
    return tokens, serve.group_stats(eng)


def _serve_bf16(n: int, prompt_len: int) -> tuple:
    """The requests, weights and serving config ``launch.serve.main`` makes
    for ``n`` prompts of ``prompt_len`` tokens, served with a bf16 cache;
    its requests' tokens and its groups' stats."""
    from repro_torch.launch import serve

    cfg, values, reqs, scfg = serve.make_run(
        SERVE_ARCH, False, n, prompt_len, SERVE_NEW_TOKENS, SERVE_MAX_BATCH,
        SERVE_SEED, "cuda")
    return _serve(cfg, values, reqs, scfg)


def _serve_cli(args, n, new_tokens, vocab) -> tuple:
    """One ``repro_torch.launch.serve.main`` call at ``args``, which serves
    ``n`` requests of ``new_tokens`` tokens; its requests' tokens and its
    ``group:`` lines."""
    import contextlib
    import io

    from repro_torch.launch import serve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(list(args))
    if rc != 0:
        raise AssertionError(f"serve {args} exited {rc}")
    tokens, groups = {}, []
    for line in buf.getvalue().splitlines():
        if line.startswith("req "):
            rid, toks = line[4:].split(": ", 1)
            tokens[int(rid)] = json.loads(toks)
        elif line.startswith("group: "):
            groups.append(json.loads(line[len("group: "):]))
    _check_tokens(f"serve {args}", tokens, n, new_tokens, vocab)
    return tokens, groups


def _per_forward(cfg) -> dict:
    """Launches of each kernel in one forward of ``cfg`` (attention and
    MLA: in a prefill of more than one token; decode attends over the
    cache in plain torch): per layer one norm before the mixer, one before
    the FFN if it has one, 2 more for qk-norm, MLA's ``kv_norm`` and
    ``q_norm`` (with a q LoRA), mLSTM's and sLSTM's ``out_norm``; the
    final norm; the fused SwiGLU once for a dense FFN, once for each
    expert of a MoE (every expert, every call), once for its shared
    experts and once for Arctic's dense residual FFN."""
    from repro_torch.models.config import (ATTN, ATTN_LOCAL, ATTN_MLA,
                                           FFN_DENSE, FFN_MOE,
                                           FFN_MOE_RESIDUAL, FFN_NONE,
                                           MLSTM, SLSTM)

    specs = cfg.block_specs()
    moe = cfg.n_experts + (1 if cfg.n_shared_experts else 0)
    ffn = {FFN_DENSE: 1, FFN_MOE: moe, FFN_MOE_RESIDUAL: moe + 1,
           FFN_NONE: 0}
    attn = sum(s.mixer in (ATTN, ATTN_LOCAL) for s in specs)
    mla = sum(s.mixer == ATTN_MLA for s in specs)
    lstm = sum(s.mixer in (MLSTM, SLSTM) for s in specs)
    return {"rmsnorm": sum(1 + (s.ffn != FFN_NONE) for s in specs) + 1
            + 2 * attn * cfg.qk_norm + mla * (1 + bool(cfg.q_lora_rank))
            + lstm,
            "fused_ffn": sum(ffn[s.ffn] for s in specs),
            "flash_attention": attn + mla}


def _structural(cfg, groups) -> dict:
    """Launches ``cfg``'s structure implies for these serving groups: one
    prefill and ``decode_steps`` decode forwards a group."""
    per = _per_forward(cfg)
    forwards = sum(1 + g["decode_steps"] for g in groups)
    return {"rmsnorm": per["rmsnorm"] * forwards,
            "fused_ffn": per["fused_ffn"] * forwards,
            "flash_attention": per["flash_attention"] * len(groups)}


def _trace_tops(prof, n: int = 12) -> dict:
    """The device kernels with the most device time and the host ops with
    the most self time in a ``torch.profiler`` trace: (name, calls,
    milliseconds) each."""
    rows = prof.key_averages()

    def ms(evt, *attrs):
        for a in attrs:
            if hasattr(evt, a):
                return getattr(evt, a) / 1e3
        return 0.0

    dev = sorted(((e.key[:80], e.count, ms(e, "self_device_time_total",
                                              "self_cuda_time_total"))
                  for e in rows), key=lambda r: -r[2])
    host = sorted(((e.key[:80], e.count, ms(e, "self_cpu_time_total"))
                   for e in rows), key=lambda r: -r[2])
    return {"top_device_ms": [r for r in dev[:n] if r[2] > 0],
            "top_host_self_ms": host[:n]}


def _traced(fn) -> tuple:
    """``fn()`` under ``torch.profiler``: its result, and the trace's wall
    time, device activity and idle share, each LM kernel's traced launches
    (counted by its first device kernel) and the heaviest device kernels
    and host ops."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = [n for lib in LM_KERNELS.values() for n in lib[2]]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        wall = time.perf_counter() - t0
    activity = _device_activity(prof, tuple(names))
    by_kernel = {lib: 0 for lib in LM_KERNELS}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for lib, (_, _, knames) in LM_KERNELS.items():
                by_kernel[lib] += knames[0] in e.name
    return result, {
        "traced_wall_s": wall, "traced_launches": by_kernel, **activity,
        "device_idle_share": (1.0 - activity["device_busy_ms"] / 1e3 / wall
                              if activity["device_events"] else None),
        **_trace_tops(prof)}


def phase_serve() -> dict:
    """The serving path at full width with a bf16 cache: both runs
    untraced, with every kernel's launch count set to 0 before and read
    after and held to the structural count; both again, warm, for their
    timings; then the 8 x 512 run under ``torch.profiler`` for the card's
    busy time and the heaviest kernels and host ops, with greedy tokens
    equal to its first run's.  Last, ``launch.serve.main`` at its defaults
    (fp32 cache) on a short run, its launches held to the structure too."""
    import torch

    from repro_torch.configs import get_config

    cfg = get_config(SERVE_ARCH)
    counters = _lm_counters()
    for mod in counters.values():
        mod.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runs = [_serve_bf16(*r) for r in SERVE_RUNS]
    wall = time.perf_counter() - t0
    launches = {lib: mod.launches for lib, mod in counters.items()}
    groups = [g for _, gs in runs for g in gs]
    expected = _structural(cfg, groups)
    for g in groups:
        emit({"phase": "serve", "pass": "first", "group": g})
    # the same runs again, warm (kernels loaded, allocator primed)
    for _, gs in (_serve_bf16(*r) for r in SERVE_RUNS):
        for g in gs:
            emit({"phase": "serve", "pass": "warm", "group": g})

    # the trace covers the main cell (8 x 512) only: its events are what
    # the profiler can post-process in seconds
    traced, trace = _traced(lambda: _serve_bf16(*SERVE_RUNS[0]))
    for g in traced[1]:
        emit({"phase": "serve", "pass": "traced", "group": g})
    same_tokens = runs[0][0] == traced[0]

    for mod in counters.values():
        mod.launches = 0
    cli_tokens, cli_groups = _serve_cli(SERVE_CLI_ARGS, 2, 8, cfg.vocab)
    cli_launches = {lib: mod.launches for lib, mod in counters.items()}
    cli = {"args": list(SERVE_CLI_ARGS), "cache_dtype": "float32",
           "groups": cli_groups, "launches": cli_launches,
           "expected_launches": _structural(cfg, cli_groups)}
    out = {
        "phase": "serve", "arch": SERVE_ARCH, "seed": SERVE_SEED,
        "max_batch": SERVE_MAX_BATCH, "new_tokens": SERVE_NEW_TOKENS,
        "cache_dtype": "bfloat16", "runs": [list(r) for r in SERVE_RUNS],
        "wall_s": wall, "forwards": sum(1 + g["decode_steps"]
                                        for g in groups),
        "launches": launches, "expected_launches": expected,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "traced_run": list(SERVE_RUNS[0]), **trace,
        "tokens_equal_traced_untraced": same_tokens,
        "cli": cli,
    }
    emit(out)
    if launches != expected:
        raise AssertionError(f"serve launches {launches} != structural "
                             f"{expected}")
    if not same_tokens:
        raise AssertionError("the traced serve run gave other tokens")
    if cli_launches != cli["expected_launches"]:
        raise AssertionError(f"serve CLI launches {cli_launches} != "
                             f"structural {cli['expected_launches']}")
    return out


def phase_serve_vs_cpu() -> dict:
    """A 64-token prompt at full tinyllama-1.1b width in fp32 compute, on
    the card through the kernels and on the CPU through their plain
    versions, with the same weights: the uncached forward's logits within
    :data:`SERVE_VS_CPU_TOL`, and 8 greedy tokens of the serving engine
    equal."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm_apply, lm_init, param_values
    from repro_torch.models.layers import tree_map
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("tinyllama-1.1b").with_(compute_dtype="float32")
    values = param_values(lm_init(cfg, torch.Generator().manual_seed(0),
                                  "cpu"))
    on_card = tree_map(lambda t: t.to("cuda"), values)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, 64)
    tokens = torch.from_numpy(prompt[None, :].astype(np.int64))
    counters = _lm_counters()
    for mod in counters.values():
        mod.launches = 0
    got = lm_apply(on_card, cfg, tokens.cuda())[0].cpu()
    launches = {lib: mod.launches for lib, mod in counters.items()}
    want = lm_apply(values, cfg, tokens)[0]
    err = float((got - want).abs().max())
    close = bool(torch.isfinite(got).all()) and torch.allclose(
        got, want, rtol=SERVE_VS_CPU_TOL, atol=SERVE_VS_CPU_TOL)

    def greedy(vals):
        eng = ServeEngine(cfg, vals, ServeConfig(max_batch=1, max_len=80))
        return eng.generate([Request(rid=0, prompt=prompt.astype(np.int32),
                                     max_new_tokens=8)])[0]

    card_tokens, cpu_tokens = greedy(on_card), greedy(values)
    out = {"phase": "serve_vs_cpu", "compute_dtype": "float32",
           "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "logits_shape": list(got.shape), "max_abs_err": err,
           "max_abs_logit": float(want.abs().max()),
           "tol": SERVE_VS_CPU_TOL, "close": close,
           "launches_forward": launches,
           "card_tokens": card_tokens, "cpu_tokens": cpu_tokens}
    emit(out)
    if not close or card_tokens != cpu_tokens:
        raise AssertionError("the card's fp32 forward disagrees with the "
                             "CPU's")
    one_prefill = _per_forward(cfg)
    if launches != one_prefill:
        raise AssertionError(f"the card's forward made {launches} launches, "
                             f"not {one_prefill}")
    return out


def _serve_hybrid(cfg, values, n: int, prompt_len: int) -> tuple:
    """``n`` prompts of ``prompt_len`` tokens, made as ``launch.serve``
    makes them, served over ``values`` as :func:`_serve_bf16` serves them."""
    from repro_torch.launch import serve
    from repro_torch.serve import ServeConfig

    reqs = serve.make_requests(cfg, n, prompt_len, SERVE_NEW_TOKENS,
                               SERVE_SEED)
    return _serve(cfg, values, reqs, ServeConfig(
        max_batch=SERVE_MAX_BATCH, max_len=prompt_len + SERVE_NEW_TOKENS + 8))


def _serve_slice(phase: str, cfg, device: dict) -> dict:
    """``cfg`` at full width (random bf16 weights from seed 0 drawn on the
    card), served as ``serve`` serves tinyllama: both runs of
    :data:`SERVE_RUNS` with every kernel's launch count set to 0 before
    and read after and held to the structure, both again warm with the
    same greedy tokens, then the 8 x 512 run under ``torch.profiler``."""
    import dataclasses

    import torch

    from repro_torch.models import lm_init, param_values
    from repro_torch.models.layers import tree_map

    t0 = time.perf_counter()
    values = param_values(lm_init(
        cfg, torch.Generator(device="cuda").manual_seed(SERVE_SEED), "cuda"))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = 0

    def count(t):
        nonlocal n_params
        n_params += t.numel()

    tree_map(count, values)
    weights_gb = torch.cuda.memory_allocated() / 1e9

    counters = _lm_counters()
    for mod in counters.values():
        mod.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runs = [_serve_hybrid(cfg, values, *r) for r in SERVE_RUNS]
    wall = time.perf_counter() - t0
    launches = {lib: mod.launches for lib, mod in counters.items()}
    groups = [g for _, gs in runs for g in gs]
    expected = _structural(cfg, groups)
    for g in groups:
        emit({"phase": phase, "pass": "first", "group": g})
    warm = [_serve_hybrid(cfg, values, *r) for r in SERVE_RUNS]
    for _, gs in warm:
        for g in gs:
            emit({"phase": phase, "pass": "warm", "group": g})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    same_tokens = [t for t, _ in runs] == [t for t, _ in warm]
    traced, trace = _traced(
        lambda: _serve_hybrid(cfg, values, *SERVE_RUNS[0]))
    for g in traced[1]:
        emit({"phase": phase, "pass": "traced", "group": g})
    del values
    torch.cuda.empty_cache()
    specs = cfg.block_specs()
    out = {
        "phase": phase, "device": device["nvidia_smi"],
        "arch": cfg.name, "n_layers": cfg.n_layers,
        "layers": [f"{s.mixer}+{s.ffn}" for s in specs],
        "config": dataclasses.asdict(cfg),
        "params": n_params, "param_count": cfg.param_count(),
        "weights_gb": weights_gb, "init_s": init_s,
        "seed": SERVE_SEED, "max_batch": SERVE_MAX_BATCH,
        "new_tokens": SERVE_NEW_TOKENS, "cache_dtype": "bfloat16",
        "runs": [list(r) for r in SERVE_RUNS], "wall_s": wall,
        "forwards": sum(1 + g["decode_steps"] for g in groups),
        "launches": launches, "expected_launches": expected,
        "warm": [{k: g[k] for k in ("batch", "prompt_len", "ttft_s",
                                    "prefill_s", "decode_tokens_per_s")}
                 for _, gs in warm for g in gs],
        "peak_memory_gb": peak_gb,
        "tokens_equal_first_warm": same_tokens,
        "tokens_equal_traced_first": traced[0] == runs[0][0],
        "traced_run": list(SERVE_RUNS[0]), **trace,
    }
    emit(out)
    if launches != expected:
        raise AssertionError(f"{phase} launches {launches} != "
                             f"structural {expected}")
    if not same_tokens or not out["tokens_equal_traced_first"]:
        raise AssertionError(f"{phase}: the passes gave other tokens")
    return out


def phase_serve_hybrid(device: dict) -> dict:
    """jamba-v0.1-52b's 8-layer slice at full width (:data:`HYBRID_ARCH`)
    through :func:`_serve_slice`."""
    from repro_torch.configs import get_config

    return _serve_slice("serve_hybrid", get_config(HYBRID_ARCH).with_(
        n_layers=HYBRID_LAYERS), device)


def phase_serve_mla(device: dict) -> dict:
    """deepseek-v2-236b's 4 layers at full width (:data:`MLA_ARCH`)
    through :func:`_serve_slice`."""
    from repro_torch.configs import get_config

    return _serve_slice("serve_mla", get_config(MLA_ARCH).with_(
        n_layers=MLA_LAYERS), device)


def phase_serve_xlstm(device: dict) -> dict:
    """xlstm-350m at full width and depth through :func:`_serve_slice`."""
    from repro_torch.configs import get_config

    return _serve_slice("serve_xlstm", get_config(XLSTM_ARCH), device)


class _RouterChoices:
    """While active, records at every MoE call of the model the experts
    each token chooses (sorted) and its gate margin (the k-th gate less
    the (k+1)-th), so that two runs' routing can be compared."""

    def __enter__(self):
        import torch

        from repro_torch.models import blocks

        self.calls, self._inner = [], blocks.moe_apply

        def recording(params, cfg, x, act="silu"):
            gates = torch.softmax(x.float() @ params["router"].float(), -1)
            top = torch.topk(gates, cfg.top_k + 1, dim=-1)
            k = cfg.top_k
            self.calls.append((
                top.indices[..., :k].sort(-1).values.cpu(),
                (top.values[..., k - 1] - top.values[..., k]).cpu()))
            return self._inner(params, cfg, x, act)

        blocks.moe_apply = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.models import blocks

        blocks.moe_apply = self._inner


def _hybrid_vs_cpu_case(arch: str, phase: str = "hybrid_vs_cpu") -> dict:
    """``arch``'s smoke config in fp32 from ``launch.serve.make_run`` (one
    64-token prompt, the weights drawn on the CPU and copied to the card):
    the uncached forward's logits on the card within
    :data:`SERVE_VS_CPU_TOL` of the CPU's, every MoE call routing every
    token to the same experts, its launches those of one forward, and the
    engine's 8 greedy tokens equal.  Raises on any difference, printing
    the tokens routed otherwise with their gate margins."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import lm_apply
    from repro_torch.models.layers import tree_map
    from repro_torch.serve import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, values, reqs, scfg = serve.make_run(arch, True, 1, 64, 8, 1,
                                             SERVE_SEED, "cpu")
    on_card = tree_map(lambda t: t.to("cuda"), values)
    tokens = torch.from_numpy(reqs[0].prompt[None, :].astype(np.int64))
    counters = _lm_counters()
    for mod in counters.values():
        mod.launches = 0
    with _RouterChoices() as card:
        got = lm_apply(on_card, cfg, tokens.cuda())[0].cpu()
    launches = {lib: mod.launches for lib, mod in counters.items()}
    with _RouterChoices() as cpu:
        want = lm_apply(values, cfg, tokens)[0]
    rerouted = []
    for i, ((ce, cm), (we, wm)) in enumerate(zip(card.calls, cpu.calls)):
        for b, s in (ce != we).any(-1).nonzero().tolist():
            rerouted.append({"moe_call": i, "batch": b, "token": s,
                             "card": ce[b, s].tolist(),
                             "cpu": we[b, s].tolist(),
                             "margin_card": float(cm[b, s]),
                             "margin_cpu": float(wm[b, s])})
    err = float((got - want).abs().max())
    close = bool(torch.isfinite(got).all()) and torch.allclose(
        got, want, rtol=SERVE_VS_CPU_TOL, atol=SERVE_VS_CPU_TOL)

    def greedy(vals):
        eng = ServeEngine(cfg, vals, scfg)
        return eng.generate([serve.Request(rid=0, prompt=reqs[0].prompt,
                                           max_new_tokens=8)])[0]

    card_tokens, cpu_tokens = greedy(on_card), greedy(values)
    out = {"phase": phase, "arch": arch, "compute_dtype":
           cfg.compute_dtype, "layers": [f"{s.mixer}+{s.ffn}"
                                         for s in cfg.block_specs()],
           "logits_shape": list(got.shape), "max_abs_err": err,
           "max_abs_logit": float(want.abs().max()), "tol":
           SERVE_VS_CPU_TOL, "close": close, "moe_calls": len(card.calls),
           "min_gate_margin": min((float(m.min()) for _, m in cpu.calls),
                                  default=None),
           "rerouted": rerouted, "launches_forward": launches,
           "expected_launches": _per_forward(cfg),
           "card_tokens": card_tokens, "cpu_tokens": cpu_tokens}
    emit(out)
    if rerouted or len(card.calls) != len(cpu.calls):
        raise AssertionError(f"{arch}: the card routed {len(rerouted)} "
                             f"token choices otherwise than the CPU")
    if not close or card_tokens != cpu_tokens:
        raise AssertionError(f"{arch}: the card's fp32 forward disagrees "
                             f"with the CPU's")
    if launches != out["expected_launches"]:
        raise AssertionError(f"{arch}: the card's forward made {launches} "
                             f"launches, not {out['expected_launches']}")
    return out


def phase_hybrid_vs_cpu() -> dict:
    """:func:`_hybrid_vs_cpu_case` for each of :data:`HYBRID_VS_CPU_ARCHS`;
    then ``launch.serve.main`` at its defaults on jamba's smoke config
    (the reference's fp32 cache), its launches held to the structure."""
    cases = [_hybrid_vs_cpu_case(arch) for arch in HYBRID_VS_CPU_ARCHS]
    return {"cases": cases, "cli": _smoke_cli("hybrid_vs_cpu", HYBRID_ARCH)}


def _smoke_cli(phase: str, arch: str) -> dict:
    """``launch.serve.main`` at its defaults on ``arch``'s smoke config on
    the card (the reference's fp32 cache: B2 and B3 take their fp32
    routes), its launches held to the structure."""
    from repro_torch.configs import get_config

    args = ("--device", "cuda", "--arch", arch, "--smoke")
    counters = _lm_counters()
    for mod in counters.values():
        mod.launches = 0
    cfg = get_config(arch, smoke=True)
    _, groups = _serve_cli(args, 6, 8, cfg.vocab)
    launches = {lib: mod.launches for lib, mod in counters.items()}
    cli = {"phase": phase, "args": list(args), "groups": groups,
           "launches": launches,
           "expected_launches": _structural(cfg, groups)}
    emit(cli)
    if launches != cli["expected_launches"]:
        raise AssertionError(f"serve {args}: launches {launches} != "
                             f"structural {cli['expected_launches']}")
    return cli


def phase_mla_xlstm_vs_cpu() -> dict:
    """:func:`_hybrid_vs_cpu_case` for deepseek's and xlstm's smoke configs
    (MLA's prefill through B2 padded to 32 columns in fp32), then
    ``launch.serve`` at its defaults on each."""
    cases = [_hybrid_vs_cpu_case(arch, "mla_xlstm_vs_cpu")
             for arch in MLA_XLSTM_VS_CPU_ARCHS]
    return {"cases": cases, "cli": [_smoke_cli("mla_xlstm_vs_cpu", arch)
                                    for arch in MLA_XLSTM_VS_CPU_ARCHS]}


# -- LM kernels ---------------------------------------------------------------

def _randn(shape, dtype, seed, scale=1.0):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def _rms_inputs(m, d, dtype, seed, offset=0):
    """x ``[M, d]`` (``offset`` elements into its storage) and scale
    ``[d]``."""
    import torch

    x = torch.empty(m * d + offset, dtype=dtype, device="cuda")[offset:]
    x = x.view(m, d).copy_(_randn((m, d), dtype, seed))
    return x, _randn((d,), dtype, seed + 1)


def _ffn_inputs(m, d, f, dtype, seed):
    return (_randn((m, d), dtype, seed),
            _randn((d, f), dtype, seed + 1, d ** -0.5),
            _randn((d, f), dtype, seed + 2, d ** -0.5),
            _randn((f, d), dtype, seed + 3, f ** -0.5))


def _attn_inputs(b, h, hkv, s, d, dtype, seed):
    """q as the model holds it, ``[B, S, H, d]``, handed over as a
    ``[B, H, S, d]`` view; k, v likewise with ``Hkv`` heads."""
    return (_randn((b, s, h, d), dtype, seed).transpose(1, 2),
            _randn((b, s, hkv, d), dtype, seed + 1).transpose(1, 2),
            _randn((b, s, hkv, d), dtype, seed + 2).transpose(1, 2))


def _mla_attn_inputs(b, h, s, dqk, dv, dtype, seed):
    """MLA's B2 inputs: q, k ``[B, S, H, dqk]`` and v ``[B, S, H, dv]`` as
    the model holds them, zero-padded to the kernel's width and handed
    over as ``[B, H, S, width]`` views, then the unpadded q, k, v as
    ``[B, H, S, d]`` views; and the scale ``1/sqrt(dqk)``."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import HEAD_DIMS

    width = next(w for w in HEAD_DIMS if w >= max(dqk, dv))
    raw = [_randn((b, s, h, d), dtype, seed + i)
           for i, d in enumerate((dqk, dqk, dv))]
    padded = [F.pad(t, (0, width - t.shape[-1])).transpose(1, 2)
              for t in raw]
    return (*padded, *(t.transpose(1, 2) for t in raw)), dqk ** -0.5


def _lm_calls():
    """(kernel library, case, kernel call, plain call) for every case of
    the kernel-against-plain phase, in both dtypes."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import rmsnorm as rn

    for i, (b, h, s_len, dqk, dv, tname) in enumerate(MLA_ATTN_CASES):
        dtype = getattr(torch, tname)
        args, scale = _mla_attn_inputs(b, h, s_len, dqk, dv, dtype, 90 + i)
        yield ("flash_attention",
               {"b": b, "h": h, "hkv": h, "s": s_len, "d": args[0].shape[-1],
                "mla": {"qk": dqk, "v": dv}, "scale": scale, "causal": True,
                "window": 0}, dtype,
               lambda a=args[:3], sc=scale: fa.flash_attention(*a, scale=sc),
               lambda a=args[:3], sc=scale: fa.attention_plain(*a, scale=sc))
    for i, (m, d, f) in enumerate(DEEPSEEK_FFN_CASES):
        args = _ffn_inputs(m, d, f, torch.bfloat16, 100 + 4 * i)
        yield ("fused_ffn", {"m": m, "d": d, "f": f}, torch.bfloat16,
               lambda a=args: ff.fused_swiglu(*a),
               lambda a=args: ff.swiglu_plain(*a))
    for dtype in (torch.bfloat16, torch.float32):
        for i, (m, d, off) in enumerate(RMS_CASES):
            args = _rms_inputs(m, d, dtype, 10 + i, off)
            vec = rn.vector_route(args[0].data_ptr(), args[1].data_ptr(), 0,
                                  d, dtype.itemsize)
            yield ("rmsnorm", {"m": m, "d": d, "offset": off,
                               "route": "vector" if vec else "scalar"},
                   dtype,
                   lambda a=args: rn.fused_rmsnorm(*a),
                   lambda a=args: rn.rmsnorm_plain(*a))
        ffn_cases = FFN_CASES + (JAMBA_FFN_CASES if dtype == torch.bfloat16
                                 else ())
        for i, (m, d, f) in enumerate(ffn_cases):
            args = _ffn_inputs(m, d, f, dtype, 20 + 4 * i)
            yield ("fused_ffn", {"m": m, "d": d, "f": f}, dtype,
                   lambda a=args: ff.fused_swiglu(*a),
                   lambda a=args: ff.swiglu_plain(*a))
        for i, (b, h, hkv, s, d, causal, window) in enumerate(
                ATTN_CASES + ATTN_SWEEP):
            args = _attn_inputs(b, h, hkv, s, d, dtype, 40 + 3 * i)
            kw = {"causal": causal, "window": window}
            yield ("flash_attention",
                   {"b": b, "h": h, "hkv": hkv, "s": s, "d": d, **kw,
                    "sweep": i >= len(ATTN_CASES)}, dtype,
                   lambda a=args, kw=kw: fa.flash_attention(*a, **kw),
                   lambda a=args, kw=kw: fa.attention_plain(*a, **kw))


def phase_lm_kernels_vs_plain() -> dict:
    """Each LM kernel against its plain torch version on the same card
    tensors: at the serving path's shapes (tinyllama's, jamba's,
    deepseek's and xlstm's; B3 at jamba's and deepseek's widths and B2
    under MLA's padded contract at deepseek's in bf16 only, B2 at the MLA
    smoke shape in fp32 only) and at ragged ones, in bf16
    (tolerance 2e-2) and fp32 (2e-5, TF32 off), the tolerances of
    ``tests/test_kernels.py``.  Returns the largest absolute error of each
    kernel, by dtype."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "lm_kernels_vs_plain", "allow_tf32": {
        "matmul": torch.backends.cuda.matmul.allow_tf32,
        "cudnn": torch.backends.cudnn.allow_tf32}})
    errs: dict = {}
    failed = []
    sweep: dict = {}  # (dtype, d) -> [cases, max error] of ATTN_SWEEP
    for name, case, dtype, kernel, plain in _lm_calls():
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        tname = str(dtype).removeprefix("torch.")
        tol = LM_TOL[tname]
        finite = bool(torch.isfinite(got).all())
        err = float((got.float() - want.float()).abs().max())
        ok = finite and got.shape == want.shape and torch.allclose(
            got.float(), want.float(), rtol=tol, atol=tol)
        key = (name, tname)
        errs[key] = max(errs.get(key, 0.0), err)
        if case.pop("sweep", False) and ok:
            agg = sweep.setdefault((tname, case["d"]), [0, 0.0])
            agg[0] += 1
            agg[1] = max(agg[1], err)
        else:
            emit({"phase": "lm_kernels_vs_plain", "kernel": name, **case,
                  "dtype": tname, "tol": tol, "max_abs_err": err,
                  "finite": finite, "ok": ok})
        if not ok:
            failed.append((name, case, tname))
    for (tname, d), (n, err) in sorted(sweep.items()):
        emit({"phase": "lm_kernels_vs_plain", "kernel": "flash_attention",
              "sweep": {"s": ATTN_SWEEP_S, "window": [0, 40],
                        "hkv": [1, 2, 16], "h": 16}, "d": d, "dtype": tname,
              "cases_ok": n, "max_abs_err": err})
    if failed:
        raise AssertionError(f"LM kernels disagree with their plain "
                             f"versions: {failed}")
    return errs


def _profiled_ms(fn, reps: int, names=("",), sets=((),)) -> "float | None":
    """Device time per call of the device kernels whose names contain one
    of ``names`` (every device kernel by default), from ``torch.profiler``:
    each kernel's mean duration times its launches per call.  (The trace
    can miss a few launches of a run, so the sum over the run divided by
    ``reps`` would undercount.)  Arguments and outputs rotate over ``sets``
    as in :func:`_events_ms`.  ``None`` when the profiler shows no device
    time for them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    keep = [None] * len(sets) if len(sets) > 1 else None
    for i in range(len(sets)):
        out = fn(*sets[i])
        if keep:
            keep[i] = out
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            out = fn(*sets[i % len(sets)])
            if keep:
                keep[i % len(keep)] = out
        torch.cuda.synchronize()
    per_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and any(n in e.name
                                                    for n in names):
            c = per_name.setdefault(e.name, [0, 0.0])
            c[0] += 1
            c[1] += e.time_range.elapsed_us()
    total_us = sum(us / n * max(1, round(n / reps))
                   for n, us in per_name.values())
    return total_us / 1e3 if total_us > 0 else None


# the H100's L2 cache; a timed row whose call moves at least COLD_MIN_BYTES
# is also timed on operands that are not L2-resident
L2_BYTES = 50 << 20
COLD_MIN_BYTES = 4 << 20


def _timing_row(lib, shape, make, kernel, plain, library, nbytes, ops, reps,
                dtype="bfloat16", composite=None, extra=None) -> dict:
    """Times of one kernel at one shape: between CUDA events back to back,
    device time from the profiler, its plain version, the library call
    (events, and its kernels' device time) and a composite of library calls
    (a yardstick where no single call computes the function); the bound
    from the bytes the function must move and its operations at the tensor
    cores' bf16 rate (fp32: the rate outside the tensor cores).

    ``make(i)`` builds the ``i``-th set of inputs, which ``kernel``,
    ``plain``, ``library`` and ``composite`` take as arguments.  Where a
    call moves at least :data:`COLD_MIN_BYTES`, the kernel, library and
    composite are timed over enough input sets (their outputs kept as
    long) to exceed twice the L2, so that every call reads its operands
    from device memory; those figures are the row's ``ms``,
    ``device_ms``, ``library_ms``, ``library_device_ms`` and
    ``composite_ms``, and the back-to-back figures on one set are kept as
    the same names with ``_hot`` (the only figures of a smaller row).
    ``extra`` is merged into the row."""
    names = LM_KERNELS[lib][2]

    def times(sets):
        return {
            "ms": _events_ms(kernel, reps, sets),
            "device_ms": _profiled_ms(kernel, reps, names, sets),
            "library_ms": _events_ms(library, reps, sets) if library
            else None,
            "library_device_ms": _profiled_ms(library, reps, sets=sets)
            if library else None,
            "composite_ms": _events_ms(composite, reps, sets) if composite
            else None,
        }

    first = make(0)
    hot = times((first,))
    cold_sets = 0
    if nbytes >= COLD_MIN_BYTES:
        cold_sets = -(-2 * L2_BYTES // nbytes) + 1
        cold = times((first,) + tuple(make(i) for i in range(1, cold_sets)))
    else:
        cold = hot
    plain_ms = _events_ms(plain, max(reps // 4, 3), (first,))
    bound_ms, bound_by = _bound(nbytes, ops, dtype)
    row = {"phase": "lm_timing", "kernel": lib, **shape, "dtype": dtype,
           **cold, "plain_ms": plain_ms,
           "l2_cold": cold_sets > 0, "cold_sets": cold_sets,
           **{f"{k}_hot": v for k, v in hot.items()},
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes": nbytes, "ops": ops, **(extra or {})}
    emit(row)
    return row


def _bound(nbytes, ops, dtype="bfloat16") -> tuple:
    """The least time in ms for a call moving ``nbytes`` and doing ``ops``
    operations: the larger of the bytes over the memory rate and the
    operations over the peak rate of ``dtype`` (bf16: the tensor cores';
    fp32: the rate outside them); and which of the two it is."""
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s = ops / (PEAK_BF16_OPS_PER_S if dtype == "bfloat16"
                   else PEAK_SCALAR_OPS_PER_S)
    return (max(bytes_s, ops_s) * 1e3,
            "bytes" if bytes_s >= ops_s else "operations")


def _sdpa_backends(q, k, v, scale) -> dict:
    """Which backends of ``F.scaled_dot_product_attention`` take causal
    attention over ``q``, ``k``, ``v``, and which of them the default call
    took: those whose output equals the default call's bit for bit."""
    import warnings

    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def call():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              scale=scale)

    default = call()
    runs, same = [], []
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with warnings.catch_warnings(), sdpa_kernel([backend]):
                warnings.simplefilter("ignore")
                out = call()
        except RuntimeError:
            continue
        runs.append(backend.name)
        if torch.equal(out, default):
            same.append(backend.name)
    return {"sdpa_backends": runs, "sdpa_default_equals": same}


def _mla_timing_rows() -> dict:
    """B2, B3 and B4 at deepseek-v2-236b's and xlstm-350m's shapes
    (``serve_mla``, ``serve_xlstm``).  B2 under MLA's contract
    (:data:`MLA_ATTN_CASES`): the kernel on the padded q/k/v, its library
    call ``F.scaled_dot_product_attention`` on the unpadded ones (with the
    backends that take them, :func:`_sdpa_backends`), the bound from the
    unpadded work (q/k 192 and v 128 wide; the padded work's bound beside
    it).  B3 at an expert's and the dense layer's widths
    (:data:`DEEPSEEK_FFN_CASES`), with the composite; B4 at the new norm
    widths over an 8 x 512 prefill, with ``F.rms_norm``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import rmsnorm as rn

    bf16, rows = torch.bfloat16, {}
    rows["flash_attention"] = []
    for b, h, s_len, dqk, dv, tname in MLA_ATTN_CASES:
        dtype = getattr(torch, tname)
        first, scale = _mla_attn_inputs(b, h, s_len, dqk, dv, dtype, 111)
        width = first[0].shape[-1]
        pairs = b * h * s_len * (s_len + 1) // 2  # causal
        nbytes = b * h * s_len * 2 * (dqk + dv) * dtype.itemsize
        padded_bytes = b * h * s_len * 4 * width * dtype.itemsize

        def sdpa(qp, kp, vp, q, k, v, scale=scale):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  scale=scale)

        rows["flash_attention"].append(_timing_row(
            "flash_attention",
            {"b": b, "h": h, "hkv": h, "s": s_len, "d": width,
             "causal": True, "mla": {"qk": dqk, "v": dv}},
            lambda i, b=b, h=h, s_len=s_len, dqk=dqk, dv=dv, dtype=dtype:
            _mla_attn_inputs(b, h, s_len, dqk, dv, dtype, 111 + 6 * i)[0],
            lambda qp, kp, vp, *_, scale=scale: fa.flash_attention(
                qp, kp, vp, scale=scale),
            lambda qp, kp, vp, *_, scale=scale: fa.attention_plain(
                qp, kp, vp, scale=scale),
            sdpa, nbytes=nbytes, ops=2 * (dqk + dv) * pairs,
            reps=20 if b > 1 else 200, dtype=tname,
            extra={**_sdpa_backends(*first[3:], scale),
                   "padded_bound_ms": _bound(
                       padded_bytes, 4 * width * pairs, tname)[0]}))
        del first

    def composite(x, wg, wi, wo):
        return (F.silu(x @ wg) * (x @ wi)) @ wo

    rows["fused_ffn"] = [_timing_row(
        "fused_ffn", {"m": m, "d": d, "f": f},
        lambda i, m=m, d=d, f=f: _ffn_inputs(m, d, f, bf16, 131 + 4 * i),
        ff.fused_swiglu, ff.swiglu_plain, None,
        nbytes=(2 * m * d + 3 * d * f) * 2, ops=6 * m * d * f,
        reps=20 if m > 8 else 100, composite=composite)
        for m, d, f in DEEPSEEK_FFN_CASES]
    rows["rmsnorm"] = [_timing_row(
        "rmsnorm", {"m": 4096, "d": d},
        lambda i, d=d: _rms_inputs(4096, d, bf16, 151 + 2 * i),
        rn.fused_rmsnorm, rn.rmsnorm_plain,
        lambda x, sc, d=d: F.rms_norm(x, (d,), sc, 1e-5),
        nbytes=(2 * 4096 * d + d) * 2, ops=0, reps=200)
        for d in (5120, 1536, 512, 1024)]
    return rows


def phase_lm_timing() -> dict:
    """B2, B3 and B4 at the serving path's shapes in bf16: prefill of 8 x 512
    and 4 x 200 tokens and decode at batch 8 and 4, at tinyllama-1.1b's
    width; B3 also in fp32 (the route ``launch.serve`` takes at its default
    fp32 cache).  The library calls (``F.scaled_dot_product_attention`` with
    GQA, ``F.rms_norm``) and B3's composite (three bf16 ``torch.matmul``s
    and ``F.silu(g) * u``) are timed here only; the port never calls them.
    Then the same at jamba-v0.1-52b's shapes (d 4096, d_ff 14,336, Hkv 8,
    d 128), and at deepseek-v2-236b's and xlstm-350m's
    (:func:`_mla_timing_rows`).  Returns the 8 x 512 prefill row of each
    kernel, with B3's and B4's decode rows, and each kernel's jamba rows
    (``<lib>_jamba``) and deepseek / xlstm rows (``<lib>_mla_xlstm``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import rmsnorm as rn

    bf16, rows = torch.bfloat16, {}
    for m in (4096, 8):
        row = _timing_row(
            "rmsnorm", {"m": m, "d": 2048},
            lambda i, m=m: _rms_inputs(m, 2048, bf16, 1 + 2 * i),
            rn.fused_rmsnorm, rn.rmsnorm_plain,
            lambda x, s: F.rms_norm(x, (2048,), s, 1e-5),
            nbytes=(2 * m * 2048 + 2048) * 2, ops=0, reps=200)
        rows.setdefault("rmsnorm", row)
        if m == 8:
            rows["rmsnorm_decode"] = row
    d, f = 2048, 5632

    def composite(x, wg, wi, wo):
        return (F.silu(x @ wg) * (x @ wi)) @ wo

    for dtype in (bf16, torch.float32):
        tname = str(dtype).removeprefix("torch.")
        for m in ((4096, 800, 8, 4) if dtype == bf16 else (4096, 8)):
            row = _timing_row(
                "fused_ffn", {"m": m, "d": d, "f": f},
                lambda i, m=m, dtype=dtype: _ffn_inputs(m, d, f, dtype,
                                                        2 + 4 * i),
                ff.fused_swiglu, ff.swiglu_plain, None,
                nbytes=(2 * m * d + 3 * d * f) * dtype.itemsize,
                ops=6 * m * d * f, reps=(20 if m > 8 else 200)
                if dtype == bf16 else (3 if m > 8 else 20),
                dtype=tname, composite=composite if dtype == bf16 else None)
            if dtype == bf16:
                rows.setdefault("fused_ffn", row)
                if m == 8:
                    rows["fused_ffn_decode"] = row
    for b, s_len in ((8, 512), (4, 200)):
        h, hkv, hd = 32, 4, 64
        live_pairs = b * h * s_len * (s_len + 1) // 2  # causal
        row = _timing_row(
            "flash_attention",
            {"b": b, "h": h, "hkv": hkv, "s": s_len, "d": hd, "causal": True},
            lambda i, b=b, s_len=s_len: _attn_inputs(b, h, hkv, s_len, hd,
                                                     bf16, 3 + 3 * i),
            fa.flash_attention, fa.attention_plain,
            lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True),
            nbytes=(2 * b * h + 2 * b * hkv) * s_len * hd * 2,
            ops=4 * hd * live_pairs, reps=100)
        rows.setdefault("flash_attention", row)

    # jamba-v0.1-52b's shapes (serve_hybrid), bf16: B4 at d 4096 over an
    # 8 x 512 prefill; B3 at d 4096 x d_ff 14,336 for a dense FFN at that
    # prefill, one expert's 8 x 80 rows there and decode at batch 8; B2 at
    # Hkv 8, d 128
    jd, jf = 4096, 14336
    rows["rmsnorm_jamba"] = [_timing_row(
        "rmsnorm", {"m": 4096, "d": jd},
        lambda i: _rms_inputs(4096, jd, bf16, 61 + 2 * i),
        rn.fused_rmsnorm, rn.rmsnorm_plain,
        lambda x, s: F.rms_norm(x, (jd,), s, 1e-5),
        nbytes=(2 * 4096 * jd + jd) * 2, ops=0, reps=200)]
    rows["fused_ffn_jamba"] = [_timing_row(
        "fused_ffn", {"m": m, "d": jd, "f": jf},
        lambda i, m=m: _ffn_inputs(m, jd, jf, bf16, 63 + 4 * i),
        ff.fused_swiglu, ff.swiglu_plain, None,
        nbytes=(2 * m * jd + 3 * jd * jf) * 2, ops=6 * m * jd * jf,
        reps=20 if m > 8 else 100, composite=composite)
        for m in (4096, 640, 8)]
    b, s_len, h, hkv, hd = 8, 512, 32, 8, 128
    rows["flash_attention_jamba"] = [_timing_row(
        "flash_attention",
        {"b": b, "h": h, "hkv": hkv, "s": s_len, "d": hd, "causal": True},
        lambda i: _attn_inputs(b, h, hkv, s_len, hd, bf16, 67 + 3 * i),
        fa.flash_attention, fa.attention_plain,
        lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True),
        nbytes=(2 * b * h + 2 * b * hkv) * s_len * hd * 2,
        ops=4 * hd * b * h * s_len * (s_len + 1) // 2, reps=100)]
    for lib, new in _mla_timing_rows().items():
        rows[f"{lib}_mla_xlstm"] = new
    return rows


PHASES = ("kernel_vs_plain", "golden", "full_run", "timing",
          "lm_kernels_vs_plain", "serve", "serve_vs_cpu", "serve_hybrid",
          "hybrid_vs_cpu", "serve_mla", "serve_xlstm", "mla_xlstm_vs_cpu",
          "lm_timing")
# the phases that serve at full width, whose launches the kernels line sums
SERVE_PHASES = ("serve", "serve_hybrid", "serve_mla", "serve_xlstm")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=None, metavar="PHASE,...",
                    help=f"run only these phases after the build, and print "
                         f"no kernels or ok line (phases: {', '.join(PHASES)})")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None
    if only and not only <= set(PHASES):
        ap.error(f"unknown phase(s): {sorted(only - set(PHASES))}")
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

    def run(name):
        return only is None or name in only

    device = phase_device()
    phase_build()
    max_err = phase_kernel_vs_plain() if run("kernel_vs_plain") else None
    if run("golden"):
        phase_golden()
    full = phase_full_run() if run("full_run") else None
    if run("timing"):
        main_n = max(1, round(full["mean_batch_lanes"])) if full else 185
        link = _link_rates()
        timing = phase_timing(main_n, link)
        large = phase_timing(1 << 20, link)
    lm_errs = phase_lm_kernels_vs_plain() if run("lm_kernels_vs_plain") \
        else None
    serve = phase_serve() if run("serve") else None
    if run("serve_vs_cpu"):
        phase_serve_vs_cpu()
    served = {"serve": serve}
    if run("serve_hybrid"):
        served["serve_hybrid"] = phase_serve_hybrid(device)
    if run("hybrid_vs_cpu"):
        phase_hybrid_vs_cpu()
    if run("serve_mla"):
        served["serve_mla"] = phase_serve_mla(device)
    if run("serve_xlstm"):
        served["serve_xlstm"] = phase_serve_xlstm(device)
    if run("mla_xlstm_vs_cpu"):
        phase_mla_xlstm_vs_cpu()
    lm_rows = phase_lm_timing() if run("lm_timing") else None
    if only is not None:
        print(f"ran only {sorted(only)}: no kernels or ok line", flush=True)
        return 0

    kernels = [{
        "name": "finish_batch",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": full["kernel_launches"],
        "bitwise_equal": max_err == 0,
        "max_abs_err": max_err,
        "n": main_n,
        "ms": timing["ms"],
        "device_ms": timing["device_ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
        "roundtrip": {t["n"]: {k: t[k] for k in (
            "roundtrip_ms", "roundtrip_bound_ms")} for t in (timing, large)},
        "link_bytes_per_s": timing["link_bytes_per_s"],
    }]
    for lib, (name, replaces, _) in LM_KERNELS.items():
        row = lm_rows[lib]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/csrc/{lib}.cu",
            "replaces": replaces,
            "launches": sum(served[p]["launches"][lib]
                            for p in SERVE_PHASES),
            "launches_by_path": {p: served[p]["launches"][lib]
                                 for p in SERVE_PHASES},
            "max_abs_err": lm_errs[(lib, "bfloat16")],
            "max_abs_err_fp32": lm_errs[(lib, "float32")],
            "shape": {k: v for k, v in row.items()
                      if k in ("m", "d", "f", "b", "h", "hkv", "s")},
            "ms": row["ms"],
            "device_ms": row["device_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library_device_ms": row["library_device_ms"],
            "composite_ms": row["composite_ms"],
            "l2_cold": row["l2_cold"],
            "hot": {k: row[f"{k}_hot"] for k in (
                "ms", "device_ms", "library_ms", "library_device_ms",
                "composite_ms")},
        })
        kernels[-1]["jamba"] = [{k: r[k] for k in (
            "m", "d", "f", "b", "h", "hkv", "s", "ms", "device_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_device_ms", "composite_ms", "l2_cold") if k in r}
            for r in lm_rows[f"{lib}_jamba"]]
        kernels[-1]["mla_xlstm"] = [{k: r[k] for k in (
            "m", "d", "f", "b", "h", "hkv", "s", "mla", "dtype", "ms",
            "device_ms", "plain_ms", "bound_ms", "bound_by",
            "padded_bound_ms", "library_ms", "library_device_ms",
            "sdpa_backends", "sdpa_default_equals", "composite_ms",
            "l2_cold") if k in r}
            for r in lm_rows[f"{lib}_mla_xlstm"]]
        if f"{lib}_decode" in lm_rows:
            dec = lm_rows[f"{lib}_decode"]
            kernels[-1]["decode"] = {k: dec[k] for k in (
                "m", "ms", "device_ms", "plain_ms", "library_ms",
                "library_device_ms", "composite_ms", "bound_ms",
                "bound_by")}
    emit({"kernels": kernels})
    print(device["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": device["name"],
                                 "count": device["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
