#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA GPU and check it.

Run from the root of a checkout, on a machine with an NVIDIA Hopper GPU
and the CUDA toolkit::

    python3 chip_smoke.py

It builds the port's five CUDA kernels from ``src/repro_torch/csrc/`` (one
``nvcc`` each, all at once) and drives both paths of the port:

* the planner: the streaming-block kernel bit for bit against its plain
  torch version, on card tensors and as a planner batch from NumPy to
  NumPy (zero copy: the kernel reads and writes pinned host memory), the
  JAX package's ten golden artifacts (the ``tpu:`` ones included)
  reproduced with the ``torch`` executor on the card, the planner at the
  paper's co-exploration settings on the real ResNet-50 netlist through
  the CLI entry point, byte-equal to the ``vector`` backend's result, and
  its plan run through the traffic simulator (``trace --plan``); the HTTP
  plan server on the card (two identical requests at once, one search, a
  transformer block, a store hit) and a zoo built, verified and rebuilt,
  every search byte-equal to ``vector``'s and launching the kernel once a
  batch;
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
  to 4 layers (MLA's 128 heads through the flash-attention kernel at their
  own widths, q/k 192 and v 128 columns, every call recorded; its decode
  steps in latent space through the MLA decode kernel, held like the
  others to the structure and against its plain version at the benchmark
  cells' shapes; 160 routed experts and 2 shared through the fused SwiGLU
  kernel) and xlstm-350m at
  full width and depth, each served as jamba is; both smoke configs in
  fp32 on the card against the CPU, and ``launch.serve`` on each;
* whisper-base at its published widths through ``EncDecEngine`` (8 rows of
  1,500 frames: the encoder's attention through the flash-attention
  kernel non-causally, once per encoder layer), and its fp32 smoke config
  on the card against the CPU;
* tinyllama-1.1b served at the reference's default fp32 cache (every
  prefill's attention on the flash-attention kernel's fp32 route, the FFNs
  on the fused SwiGLU's), launches held to the structure, its tokens equal
  to the CPU's on short prompts; gemma3-4b whole at its published widths
  (head width 256, a 1,024-key window on 5 of every 6 layers) served with
  a bf16 cache, 2,048-token prompts included, every attention call on the
  kernel's d-256 TMA + wgmma route; a 2-layer full-width gemma3-4b fp32
  forward on the card against the CPU;
* training: each kernel's autograd Function, its backward formulas
  against autograd through the plain version; tinyllama-1.1b trained whole
  through ``launch.train`` (every parameter's gradient checked, launches
  held to the structure under remat and two microbatches, a
  fault-injected restart that must replay the uninterrupted run's losses
  bit for bit, a full-width checkpoint that must restore bit for bit);
  one smoke train step of tinyllama, jamba and xlstm on the card against
  the CPU;
* the H100 planner: ``python -m repro_torch plan-h100`` over the ten
  configs, its GA batches through the streaming-block kernel, each plan
  equal to the ``vector`` backend's on the CPU, beside one tinyllama
  layer's forward at the planned tokens;
* the examples: ``examples/{quickstart,cocco_plan_search,serve_lm,
  train_tinylm}_torch.py`` through their ``main`` on the card at their
  defaults (the ~100M trainer for 300 steps, its injected failure and
  restart included), each held to its run on the CPU, and
  ``scripts/smoke_serve_plans_torch.py --device cuda``;
* the sharded train step: ``launch.train --model-parallel 1`` on a (1, 1)
  mesh of ``DTensor``s under a one-rank NCCL group, the kernels through
  ``local_map``, bit for bit the same 3 steps without a mesh, and int8
  error-feedback compression of its gradients equal to the CPU's;
* the dry run: ``python -m repro_torch.launch.dryrun`` on fake 256- and
  512-rank worlds with B2-B4 in the trace as torch ops, and tinyllama's
  train step traced on fake and on real card tensors on a (1, 1) mesh,
  the two counts equal and the real launches equal to the traced calls.

Last it times every kernel beside its plain version, its bound and the
library call where one computes the same function (and each backward
formula beside autograd through the plain version and the library call
or composite); a call that moves
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
    f"{w}.{s}" for w in ("netlib_resnet50", "tpu_gemma3-4b_L0",
                         "synthetic_layered24", "file_diamond")
    for s in ("ga", "greedy")
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
    # no TPU kernel: the JAX package decodes MLA in plain jnp, expanding
    # the cache; the kernel and its combine of the splits' partial sums
    "mla_decode": ("mla_decode", None,
                   ("mla_decode_kernel", "mla_combine_kernel")),
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
             (4096, 512, 0), (8, 512, 0), (4096, 1024, 0), (8, 1024, 0),
             # the examples: the ~100M trainer's microbatch (2 x 256 rows
             # at d 768) and serve_lm's smoke prefill and decode rows
             (512, 768, 0), (32, 64, 0), (24, 64, 0), (4, 64, 0),
             (2, 64, 0), (32, 128, 0), (4, 128, 0))
# B3 at M on both sides of the small/large-M tile threshold (16) and of
# the large tiles' 128 rows, the prefill and decode shapes, and a ragged
# shape (no TMA: the small tiles at any M)
FFN_CASES = tuple((m, 2048, 5632) for m in (1, 4, 8, 16, 63, 64, 65, 129,
                                            800, 4096)) + ((77, 200, 300),
    # the examples: the ~100M trainer's microbatch and serve_lm's smoke
    # prefill (4 x 8 rows) and decode (4 rows)
    (512, 768, 2048), (32, 64, 128), (4, 64, 128))
# B3 at jamba-v0.1-52b's width (d 4096, d_ff 14,336), bf16: decode at
# batch 8, one expert's rows at an 8 x 512 prefill (B * C = 8 * 80) and a
# dense FFN's at that prefill
JAMBA_FFN_CASES = tuple((m, 4096, 14336) for m in (8, 640, 4096))
# B3 at deepseek-v2-236b's widths, bf16: an expert (d 5120, d_ff 1536) and
# the dense first layer (d_ff 12,288); one expert's rows at an 8 x 512
# prefill (B * C = 8 * 24), decode at batch 8 and the dense prefill's rows
DEEPSEEK_FFN_CASES = tuple((m, 5120, f) for f in (1536, 12288)
                           for m in (192, 8, 4096))
# B2 under MLA's contract, (B, H, S, q/k width, v width, dtype), scale
# 1/sqrt(q/k width): deepseek's 8 x 512 prefill in bf16 and the smoke
# prefill in fp32, then ragged lengths at (192, 128) in both dtypes.  Each
# case runs as mla_apply runs it: unpadded where the kernel is built for
# the pair (deepseek's 192 and 128), else q, k and v zero-padded to one
# width that covers both (the smoke widths' 16 + 8 and 16 to 32); the
# first case also padded to 256 columns (the d-256 route, which MLA took
# before the kernel took two widths)
MLA_ATTN_CASES = ((8, 128, 512, 192, 128, "bfloat16"),
                  (1, 4, 64, 24, 16, "float32"),
                  (2, 16, 200, 192, 128, "bfloat16"),
                  (2, 16, 130, 192, 128, "bfloat16"),
                  (1, 8, 200, 192, 128, "float32"),
                  (2, 4, 130, 192, 128, "float32"))
# MLA's latent decode (mla_decode) at the deepseek cells' decode steps,
# (B, T): perfbench's decode_long (batch 16 over a 2,184-slot cache) and
# prefill_short's two prompt lengths (batch 8 over 1,032 and 2,056 slots),
# 128 heads, each row live to its own position (some past the cache's
# end: the cache full, its last slot rewritten)
MLA_DECODE_CASES = ((16, 2184), (8, 1032), (8, 2056))
# mla_decode against its plain version on those inputs (logits of std ~3.5:
# a few slots take most of a row's weight, outputs of magnitude ~1): one
# bf16 unit of the output (up to 2**-7 of it) over the plain version's
# rounding, and the weights rounded to bf16 before their product with the
# values (~2e-3 where the values cancel); a mask one slot off or a split's
# combine weight 1 % off lies above it
MLA_DECODE_TOL = {"rtol": 1e-2, "atol": 5e-3}
# B3's fp32 route besides FFN_CASES: both sides of its switch from the
# streaming kernels to the tiled ones (M 16 | 17), above it at a split K,
# and d and f that are not multiples of 4 (4-byte copies and element
# loads) on both designs; every fp32 case is also called twice and must
# repeat bit for bit (products split along K sum in split order)
FFN_F32_CASES = ((17, 2048, 5632), (32, 2048, 5632), (3, 202, 302),
                 (16, 770, 2046), (77, 202, 302), (300, 130, 258))
# (B, H, Hkv, S, d, causal, window): the serving shapes and ragged ones
ATTN_CASES = ((8, 32, 4, 512, 64, True, 0), (4, 32, 4, 200, 64, True, 0),
              (8, 32, 8, 512, 128, True, 0),  # jamba's attention
              (2, 4, 4, 130, 32, True, 48), (1, 2, 2, 100, 128, False, 0),
              (1, 2, 1, 70, 256, True, 0), (2, 2, 2, 33, 16, True, 0),
              (8, 8, 8, 1500, 64, False, 0),  # whisper's encoder
              # the examples: the ~100M trainer's microbatch (GQA 12 / 4),
              # serve_lm's tinyllama smoke prefill and whisper smoke encoder
              (2, 12, 4, 256, 64, True, 0), (4, 4, 2, 8, 16, True, 0),
              (2, 4, 2, 12, 16, False, 0),
              # gemma3-4b's prefill (serve_gemma's 4 x 2,048): its global
              # layers and its local ones (a 1,024-key window), d 256
              (4, 8, 4, 2048, 256, True, 0), (4, 8, 4, 2048, 256, True, 1024))
# B2's tile edges (64 queries, 64 keys): every S, with and without a window
# (40 keys: its edge falls inside tiles), every head dim, and Hkv of 1, H/8
# and H query heads' worth, causal, at B 1, H 16
ATTN_SWEEP_S = (1, 63, 64, 65, 127, 128, 129, 200, 512, 1024)
ATTN_SWEEP = tuple((1, 16, hkv, s, d, True, w) for s in ATTN_SWEEP_S
                   for w in (0, 40) for d in (16, 32, 64, 128, 256)
                   for hkv in (1, 2, 16)) + tuple(
    # non-causal (whisper's encoder) on the TMA + wgmma route's head dims
    (1, 16, hkv, s, d, False, 0) for s in ATTN_SWEEP_S for d in (64, 128)
    for hkv in (1, 16))

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


def phase_golden() -> int:
    """The JAX package's golden artifacts, reproduced with the torch
    executor on the card; returns the kernel's launches."""
    from repro_torch.api import build_workload, run
    from repro_torch.bridge import result_to_reference_dict
    from repro_torch.core import CachedEvaluator, TorchExecutor
    from repro_torch.kernels import finish_batch as fb
    from repro_torch.obs import Recorder, recording

    total = 0
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
        total += launches
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
    return total


# kineto's categories of the device's events and of the host's, as
# torch.profiler's chrome trace names them
DEVICE_EVENT_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_EVENT_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
                   "python_function")


def _trace_events(prof) -> tuple:
    """The device's events of a ``torch.profiler`` trace, (name, start µs,
    duration µs) each, and the host's, (name, (process, thread), start µs,
    duration µs) each, read from its chrome trace: kineto writes that
    without the Python post-processing that ``prof.events()`` does (~70 µs
    of host time an event)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    device, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") in DEVICE_EVENT_CATS:
            device.append((e["name"], float(e["ts"]), float(e["dur"])))
        elif e.get("cat") in HOST_EVENT_CATS:
            host.append((e["name"], (e.get("pid"), e.get("tid")),
                         float(e["ts"]), float(e["dur"])))
    return device, host


def _device_activity(device, kernel_names=("finish_batch_kernel",)) -> dict:
    """What ran on the card in a trace's ``device`` events
    (:func:`_trace_events`): the union of their intervals (kernels and
    copies), so that overlapping events count once, and the events of each
    kind (the port's kernels: names containing one of ``kernel_names``)."""
    busy_us, covered_to = 0.0, float("-inf")
    for start, end in sorted((ts, ts + dur) for _, ts, dur in device):
        if end > covered_to:
            busy_us += end - max(start, covered_to)
            covered_to = end
    kernel = [dur for name, _, dur in device
              if any(n in name for n in kernel_names)]
    copies = [dur for name, _, dur in device if "Memcpy" in name]
    return {
        "device_events": len(device),
        "device_busy_ms": busy_us / 1e3,
        "traced_kernel_launches": len(kernel),
        "traced_kernel_ms": sum(kernel) / 1e3,
        "traced_copies": len(copies),
        "traced_copy_ms": sum(copies) / 1e3,
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
    activity = _device_activity(_trace_events(prof)[0])
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


# -- the planner's services ---------------------------------------------------

# the plan server's traffic: the paper's energy co-exploration of ResNet-50
# (alpha 0.002, shared buffers, population 500) at a tenth of full_run's
# samples, asked twice at once, then a transformer block by greedy, then the
# first spec again
PLAN_SERVER_GA = dict(workload="netlib:resnet50", strategy="ga",
                      metric="energy", alpha=0.002, hw_mode="shared",
                      budget=5_000, population=500)
PLAN_SERVER_GREEDY = "tpu:tinyllama-1.1b:0?tokens=4096"
# the zoo's grid: both objectives and both strategies of the zoo's defaults
# on one netlist and one transformer block, at the zoo's default budget
ZOO_ARGS = ("--workloads", f"netlib:resnet50,{PLAN_SERVER_GREEDY}",
            "--budget", "2000")


def _quiet(fn, *args):
    """``fn(*args)`` with its standard output captured; returns both."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def phase_planner_trace(full: dict) -> dict:
    """``trace --plan`` on ``full_run``'s result from the card and on the
    ``vector`` backend's: both cross-validate, and their traces are
    byte-equal."""
    from repro_torch.api import cli
    from repro_torch.kernels import finish_batch as fb

    out = {"phase": "planner_trace", "plan": full["args"]}
    traces = {}
    fb.launches = 0
    for name in ("torch", "vector"):
        path = WORK_DIR / f"full_trace_{name}.json"
        t0 = time.perf_counter()
        rc, text = _quiet(cli.main, [
            "--device", "cuda", "trace", "--plan",
            str(WORK_DIR / f"full_{name}.json"), "--out", str(path)])
        out[f"host_s_{name}"] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"trace --plan ({name}) exited {rc}:\n{text}")
        traces[name] = path.read_text()
    out["kernel_launches"] = fb.launches
    doc = json.loads(traces["torch"])
    out.update({
        "trace_bytes": len(traces["torch"]),
        "steps": len(doc["steps"]), "subgraphs": len(doc["subgraphs"]),
        "cycles": doc["totals"]["cycles"],
        "dram_bytes": doc["totals"]["dram_bytes"],
        "validation_ok": doc["meta"]["validation"]["ok"],
        "bandwidth_gb_s": {k: doc["profile"][k] / 1e9 for k in (
            "peak", "p99", "p95", "p50", "sustained")},
        "byte_equal_to_vector": traces["torch"] == traces["vector"],
    })
    emit(out)
    if not out["validation_ok"] or not out["byte_equal_to_vector"]:
        raise AssertionError("planner_trace: the trace does not cross-"
                             "validate or differs from vector's")
    return out


def _plan_server_specs():
    from repro_torch.api import ExploreSpec, GAOptions
    from repro_torch.core import HWSpace, Objective

    ga = PLAN_SERVER_GA
    return (ExploreSpec(workload=ga["workload"], strategy=ga["strategy"],
                        objective=Objective(metric=ga["metric"],
                                            alpha=ga["alpha"]),
                        hw=HWSpace(mode=ga["hw_mode"]),
                        sample_budget=ga["budget"], seed=0,
                        options=GAOptions(population=ga["population"])),
            ExploreSpec(workload=PLAN_SERVER_GREEDY, strategy="greedy"))


def _vector_batches(specs, store_dir):
    """Each spec searched on the ``vector`` backend into a fresh store:
    its results, and the batches of the searches (the batching is the
    ``torch`` backend's)."""
    import shutil

    from repro_torch.api import ResultStore, run
    from repro_torch.obs import Recorder, recording

    shutil.rmtree(store_dir, ignore_errors=True)
    store = ResultStore(store_dir)
    rec = Recorder()
    with recording(rec):
        results = [run(s, store=store, eval_backend="vector",
                       device="cuda") for s in specs]
    return results, rec.counters.get("engine.array_batches", 0)


def _artifact_bytes(root: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(root.glob("*.json"))}


def phase_plan_server() -> dict:
    """The port's HTTP plan server on the card: two identical GA requests
    at once (one search, one dedup join), a greedy request on a
    transformer block, then the first spec again (a store hit); every
    searched result byte-equal to the ``vector`` backend's."""
    import shutil
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import ResultStore
    from repro_torch.kernels import finish_batch as fb
    from repro_torch.serve import PlanService, request_plan, serve_in_thread
    from repro_torch.serve.plans import fetch_metrics, fetch_stats

    store_dir = WORK_DIR / "plan_store"
    shutil.rmtree(store_dir, ignore_errors=True)
    ga, greedy = _plan_server_specs()
    svc = PlanService(ResultStore(store_dir), workers=2, device="cuda")
    server = serve_in_thread(svc)
    latencies, docs = [], []

    def ask(spec, label):
        t0 = time.perf_counter()
        doc = request_plan(server.url, spec)
        latencies.append({"request": label, "served_from":
                          doc["served_from"], "deduped": doc["deduped"],
                          "client_ms": (time.perf_counter() - t0) * 1e3,
                          "server_ms": doc["latency_ms"]})
        docs.append((spec, doc))

    try:
        fb.launches = 0
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            barrier = threading.Barrier(2)

            def first(i):
                barrier.wait()
                ask(ga, f"resnet50_ga_{i}")

            threads = [threading.Thread(target=first, args=(i,))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            if any(t.is_alive() for t in threads):
                raise AssertionError("plan_server: a request did not finish")
            ask(greedy, "tinyllama_block_greedy")
            ask(ga, "resnet50_ga_again")
            wall = time.perf_counter() - t0
        launches = fb.launches
        stats = fetch_stats(server.url)
        metrics = fetch_metrics(server.url)
    finally:
        server.close()
    activity = _device_activity(_trace_events(prof)[0])
    (vec_ga, vec_greedy), batches = _vector_batches(
        (ga, greedy), WORK_DIR / "plan_store_vector")
    want = {id(ga): json.loads(vec_ga.to_json()),
            id(greedy): json.loads(vec_greedy.to_json())}
    results_equal = all(doc["ok"] and doc["result"] == want[id(spec)]
                        for spec, doc in docs)
    store_equal = _artifact_bytes(store_dir) == \
        _artifact_bytes(WORK_DIR / "plan_store_vector")
    samples = {}
    for line in metrics.splitlines():
        if line and not line.startswith("#"):
            key, raw = line.rsplit(" ", 1)
            samples[key] = float(raw)
    server_doc = stats["server"]
    counts = {k: server_doc[k] for k in ("requests", "searches",
                                         "dedup_joins", "store_hits",
                                         "errors")}
    out = {"phase": "plan_server", "workers": 2, "device": "cuda",
           "requests": latencies, "wall_s": wall, "counts": counts,
           "metrics_samples": len(samples),
           "kernel_launches": launches, "array_batches": batches,
           **activity,
           "device_idle_share": (1.0 - activity["device_busy_ms"] / 1e3
                                 / wall if activity["device_events"]
                                 else None),
           "results_byte_equal_to_vector": results_equal,
           "store_byte_equal_to_vector": store_equal}
    emit(out)
    if not (results_equal and store_equal):
        raise AssertionError("plan_server: a result differs from vector's")
    if counts != {"requests": 4, "searches": 2, "dedup_joins": 1,
                  "store_hits": 1, "errors": 0}:
        raise AssertionError(f"plan_server: /stats counts {counts}")
    if samples.get("repro_plan_requests_total") != 4:
        raise AssertionError("plan_server: /metrics does not parse")
    if launches == 0 or launches != batches:
        raise AssertionError(
            f"plan_server: {launches} launches for {batches} batches")
    return out


def phase_zoo() -> dict:
    """``zoo build`` of a two-workload grid on the card, ``zoo verify``
    and ``zoo ls``; a second build replays every spec."""
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import cli
    from repro_torch.kernels import finish_batch as fb
    from repro_torch.obs import Recorder, recording

    zoo_dir = WORK_DIR / "zoo"
    shutil.rmtree(zoo_dir, ignore_errors=True)
    where = ("--zoo-dir", str(zoo_dir))
    rec = Recorder()
    fb.launches = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with recording(rec):
            rc, build_text = _quiet(cli.main, [
                "--device", "cuda", "zoo", "build", *where, *ZOO_ARGS])
        build_s = time.perf_counter() - t0
    launches = fb.launches
    activity = _device_activity(_trace_events(prof)[0])
    if rc != 0:
        raise AssertionError(f"zoo build exited {rc}:\n{build_text}")
    t0 = time.perf_counter()
    rc_verify, verify_text = _quiet(cli.main, ["zoo", "verify", *where])
    verify_s = time.perf_counter() - t0
    rc_ls, ls_text = _quiet(cli.main, ["zoo", "ls", "--json", *where,
                                       *ZOO_ARGS])
    fb.launches = 0
    t0 = time.perf_counter()
    rc_again, again_text = _quiet(cli.main, [
        "--device", "cuda", "zoo", "build", *where, *ZOO_ARGS])
    again_s = time.perf_counter() - t0
    ls = json.loads(ls_text) if rc_ls == 0 else {}
    batches = rec.counters.get("engine.array_batches", 0)
    out = {"phase": "zoo", "args": list(ZOO_ARGS),
           "build_s": build_s, "verify_s": verify_s, "rebuild_s": again_s,
           "summary": build_text.strip().splitlines()[-1],
           "verify": verify_text.strip().splitlines()[-1],
           "rebuild": again_text.strip().splitlines()[-1],
           "archived": ls.get("archived"), "grid": len(ls.get("rows", [])),
           "kernel_launches": launches, "array_batches": batches,
           "rebuild_launches": fb.launches, **activity,
           "device_idle_share": (1.0 - activity["device_busy_ms"] / 1e3
                                 / build_s if activity["device_events"]
                                 else None)}
    emit(out)
    if rc_verify != 0 or "verified clean" not in out["verify"]:
        raise AssertionError("zoo verify found problems")
    if (out["archived"], out["grid"]) != (8, 8):
        raise AssertionError(f"zoo ls: {out['archived']}/{out['grid']}")
    if rc_again != 0 or "0 built, 8 already archived, 0 failed" not in \
            out["rebuild"] or fb.launches:
        raise AssertionError("a second zoo build searched again")
    if launches == 0 or launches != batches:
        raise AssertionError(f"zoo: {launches} launches for {batches} "
                             f"batches")
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
# serve_gemma: gemma3-4b (hf:google/gemma-3) whole at its published widths
# (34 layers, d 2560, 8 heads / 4 KV heads of d_head 256, qk-norm, a
# 1,024-key window on 5 of every 6 layers, GeLU FFN 10,240, vocab 262,144,
# tied embeddings; ~3.9 B parameters, 7.8 GB in bf16): bf16 weights from
# seed 0 drawn on the card, a bf16 cache, served as SERVE_RUNS and then 4
# prompts of 2,048 tokens, whose prefill the window cuts in the local
# layers (their ring holds 1,024 keys, so they attend over the in-flight
# ones); every B2 call at (256, 256); the 2,048-token run traced
GEMMA_ARCH, GEMMA_WINDOW = "gemma3-4b", 1024
GEMMA_RUNS = SERVE_RUNS + ((4, 2048),)
# gemma_vs_cpu: gemma3-4b at full width cut to 2 layers with
# local_global_period 2 (layer 0 windowed, 1,024 keys; layer 1 global), fp32
# compute, one 1,100-token prompt (past the window), card against CPU from
# the same weights as serve_vs_cpu: logits within SERVE_VS_CPU_TOL, 8
# greedy tokens equal
GEMMA_VS_CPU_LAYERS, GEMMA_VS_CPU_PROMPT = 2, 1100
# serve_fp32_cache: tinyllama-1.1b as launch.serve makes it, served at the
# reference's default ServeConfig() cache (fp32), as SERVE_RUNS: the fp32
# cache promotes every prefill's q, k and v to fp32 (B2's fp32 route) and
# the residual stream after the first attention layer (B3's fp32 route);
# then 2 prompts of 64 tokens on the card and on the CPU from the card's
# weights (the CPU's bf16 products at 8 x 512 would take minutes), tokens
# equal
FP32_CACHE_CPU_RUN = (2, 64)


# serve_whisper: whisper-base (arXiv:2212.04356) at its published widths
# (6 encoder + 6 decoder layers, d 512, 8 heads = 8 KV heads, d_head 64,
# GeLU FFN 2,048, vocab 51,865, tied embeddings, 1,500 frames a row), bf16
# compute with a bf16 cache, random weights from seed 0 drawn on the card,
# 8 rows of 1,500 frames drawn from the seed with NumPy (as launch.serve
# draws its frames), 32 new tokens; first, warm and traced passes
WHISPER_ARCH, WHISPER_BATCH, WHISPER_NEW_TOKENS = "whisper-base", 8, 32
# whisper_vs_cpu: its fp32 smoke config, card against CPU: the encoder's
# output and the logits within SERVE_VS_CPU_TOL, the tokens equal
# train: tinyllama-1.1b whole (22 layers, d 2048) through launch.train.run:
# fp32 parameters and AdamW state, bf16 compute, remat "full", SyntheticLM
# batches of 8 x 512 in 2 microbatches, lr 3e-3, warmup 2, 6 steps; then
# again with a checkpoint directory, a save every 3 steps and a failure
# injected at step 4 (restored from step 3)
TRAIN_ARGS = ("--device", "cuda", "--arch", "tinyllama-1.1b", "--steps",
              "6", "--batch", "8", "--seq", "512", "--microbatches", "2",
              "--lr", "3e-3", "--warmup", "2", "--seed", "0",
              "--log-every", "1")
TRAIN_SAVE_EVERY, TRAIN_FAIL_AT = 3, 4
TRAIN_FAIL_ARGS = ("--save-every", str(TRAIN_SAVE_EVERY), "--fail-at",
                   str(TRAIN_FAIL_AT))
# train_vs_cpu: one step of these smoke configs in fp32, card against CPU:
# the loss within 1e-5, every gradient within 1e-4 of the CPU's relative
# to its norm (the backward sums in other orders through every layer), the
# same experts chosen
TRAIN_VS_CPU_ARCHS = ("tinyllama-1.1b", "jamba-v0.1-52b", "xlstm-350m")
TRAIN_VS_CPU_LOSS_TOL, TRAIN_VS_CPU_GRAD_TOL = 1e-5, 1e-4
# the kernels' autograd Functions: backward against autograd through the
# plain versions on the card, (shape, dtype): the train step's shapes
# (tinyllama-1.1b, a microbatch of 4 x 512; B2 with GQA 32 / 4 heads),
# whisper's encoder attention (non-causal, S 1,500) and norm (d 512 over
# 8 x 1,500 rows), and small fp32 ones
BACKWARD_CASES = (
    ("flash_attention", (4, 32, 4, 512, 64, True), "bfloat16"),
    ("flash_attention", (8, 8, 8, 1500, 64, False), "bfloat16"),
    ("flash_attention", (1, 4, 2, 100, 64, True), "float32"),
    ("flash_attention", (2, 4, 4, 150, 32, False), "float32"),
    ("fused_ffn", (2048, 2048, 5632), "bfloat16"),
    ("fused_ffn", (77, 256, 512), "float32"),
    ("rmsnorm", (2048, 2048), "bfloat16"),
    ("rmsnorm", (12000, 512), "bfloat16"),
    ("rmsnorm", (300, 512), "float32"),
    # the ~100M trainer of the examples, a microbatch of 2 x 256
    ("flash_attention", (2, 12, 4, 256, 64, True), "float32"),
    ("fused_ffn", (512, 768, 2048), "float32"),
    ("rmsnorm", (512, 768), "float32"),
)


def _lm_counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import mla_decode as md
    from repro_torch.kernels import rmsnorm as rn

    return {"rmsnorm": rn, "fused_ffn": ff, "flash_attention": fa,
            "mla_decode": md}


def _check_tokens(what, tokens, n, new_tokens, vocab) -> None:
    if sorted(tokens) != list(range(n)) or any(
            len(t) != new_tokens or not all(0 <= x < vocab for x in t)
            for t in tokens.values()):
        raise AssertionError(f"{what}: not {new_tokens} in-vocab tokens for "
                             f"each of {n} requests")


def _serve(cfg, values, reqs, scfg) -> tuple:
    """``reqs`` served by ``ServeEngine`` over ``values`` at ``scfg``; its
    requests' tokens and its groups' stats."""
    from repro_torch.launch import serve
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(cfg, values, scfg)
    tokens = eng.generate(reqs)
    _check_tokens(f"{cfg.name} {len(reqs)} x {len(reqs[0].prompt)}", tokens,
                  len(reqs), SERVE_NEW_TOKENS, cfg.vocab)
    return tokens, serve.group_stats(eng)


def _serve_bf16(n: int, prompt_len: int) -> tuple:
    """The requests, weights and serving config ``launch.serve.main`` makes
    for ``n`` prompts of ``prompt_len`` tokens, served with a bf16 cache;
    its requests' tokens and its groups' stats."""
    import dataclasses

    import torch

    from repro_torch.launch import serve

    cfg, values, reqs, scfg = serve.make_run(
        SERVE_ARCH, False, n, prompt_len, SERVE_NEW_TOKENS, SERVE_MAX_BATCH,
        SERVE_SEED, "cuda")
    return _serve(cfg, values, reqs,
                  dataclasses.replace(scfg, cache_dtype=torch.bfloat16))


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


def _per_layer(cfg, spec) -> dict:
    """Launches of each kernel in one layer of ``spec`` in a forward of
    ``cfg`` (attention and MLA: in a prefill of more than one token;
    decode attends over the cache in plain torch, or MLA's through
    ``mla_decode``, :func:`_latent_decodes`): one norm before the
    mixer, one before the FFN if it has one, 2 more for qk-norm, MLA's
    ``kv_norm`` and ``q_norm`` (with a q LoRA), mLSTM's and sLSTM's
    ``out_norm``; the fused SwiGLU once for a dense FFN, once for each
    expert of a MoE (every expert, every call), once for its shared
    experts and once for Arctic's dense residual FFN (none where the FFN
    is GeLU, gemma3's: plain torch); attention once."""
    from repro_torch.models.config import (ATTN, ATTN_LOCAL, ATTN_MLA,
                                           FFN_DENSE, FFN_MOE,
                                           FFN_MOE_RESIDUAL, FFN_NONE,
                                           MLSTM, SLSTM)

    moe = cfg.n_experts + (1 if cfg.n_shared_experts else 0)
    ffn = {FFN_DENSE: 1, FFN_MOE: moe, FFN_MOE_RESIDUAL: moe + 1,
           FFN_NONE: 0}
    swiglu = cfg.act == "silu"
    attn = spec.mixer in (ATTN, ATTN_LOCAL)
    mla = spec.mixer == ATTN_MLA
    return {"rmsnorm": 1 + (spec.ffn != FFN_NONE) + 2 * attn * cfg.qk_norm
            + mla * (1 + bool(cfg.q_lora_rank))
            + (spec.mixer in (MLSTM, SLSTM)),
            "fused_ffn": ffn[spec.ffn] * swiglu,
            "flash_attention": attn + mla}


def _per_forward(cfg, scanned_times: int = 1) -> dict:
    """Launches of each kernel in one forward of ``cfg``: its layers' (the
    scanned periods' ``scanned_times`` over: 2 in a train step under
    remat, whose backward recomputes them) and the final norm's."""
    pre, p, reps, _ = cfg.layout()
    out = {"rmsnorm": 1, "fused_ffn": 0, "flash_attention": 0,
           "mla_decode": 0}
    for li, spec in enumerate(cfg.block_specs()):
        times = scanned_times if pre <= li < pre + p * reps else 1
        for lib, n in _per_layer(cfg, spec).items():
            out[lib] += times * n
    return out


def _structural(cfg, groups, cache_dtype: str) -> dict:
    """Launches ``cfg``'s structure implies for these serving groups over a
    cache of ``cache_dtype``: one prefill and ``decode_steps`` decode
    forwards a group."""
    per = _per_forward(cfg)
    forwards = sum(1 + g["decode_steps"] for g in groups)
    return {"rmsnorm": per["rmsnorm"] * forwards,
            "fused_ffn": per["fused_ffn"] * forwards,
            "flash_attention": per["flash_attention"] * len(groups),
            "mla_decode": _latent_decodes(cfg, groups, cache_dtype)}


def _latent_decodes(cfg, groups, cache_dtype: str) -> int:
    """Launches of ``mla_decode`` these serving groups imply: once an MLA
    layer in each decode forward where the latent route takes it (a bf16
    cache at ``LATENT_WIDTHS``)."""
    from repro_torch.kernels.mla_decode import LATENT_WIDTHS
    from repro_torch.models.config import ATTN_MLA

    if cache_dtype != "bfloat16" or (
            cfg.kv_lora_rank, cfg.rope_head_dim) not in LATENT_WIDTHS:
        return 0
    return sum(s.mixer == ATTN_MLA for s in cfg.block_specs()) * sum(
        g["decode_steps"] for g in groups)


def _trace_tops(device, host, n: int = 12) -> dict:
    """The device kernels with the most device time and the host ops with
    the most self time (their time less that of the host events nested in
    them on their thread) in a trace's events (:func:`_trace_events`):
    (name, calls, milliseconds) each."""
    import collections

    dev = collections.defaultdict(lambda: [0, 0.0])
    for name, _, dur in device:
        dev[name[:80]][0] += 1
        dev[name[:80]][1] += dur / 1e3
    calls, self_us = collections.Counter(), collections.Counter()
    threads = collections.defaultdict(list)
    for name, thread, ts, dur in host:
        threads[thread].append((ts, -dur, name[:80]))
    for evs in threads.values():
        evs.sort()
        stack = []  # [end, duration, name, time of the events nested in it]
        for ts, neg, name in evs:
            while stack and stack[-1][0] <= ts:
                _, dur, top, nested = stack.pop()
                self_us[top] += dur - nested
            if stack:
                stack[-1][3] -= neg
            stack.append([ts - neg, -neg, name, 0.0])
            calls[name] += 1
        for _, dur, top, nested in stack:
            self_us[top] += dur - nested
    return {"top_device_ms": sorted(([k, c, ms] for k, (c, ms) in dev.items()
                                     if ms > 0), key=lambda r: -r[2])[:n],
            "top_host_self_ms": sorted(([k, calls[k], us / 1e3]
                                        for k, us in self_us.items()),
                                       key=lambda r: -r[2])[:n]}


def _traced(fn) -> tuple:
    """``fn()`` under ``torch.profiler``: its result, and the trace's wall
    time, device activity and idle share, each LM kernel's traced launches
    (counted by its first device kernel) and device ms (all its device
    kernels), and the heaviest device kernels and host ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    names = [n for lib in LM_KERNELS.values() for n in lib[2]]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        wall = time.perf_counter() - t0
    device, host = _trace_events(prof)
    activity = _device_activity(device, tuple(names))
    by_kernel = {lib: 0 for lib in LM_KERNELS}
    ms_by_kernel = {lib: 0.0 for lib in LM_KERNELS}
    for name, _, dur in device:
        for lib, (_, _, knames) in LM_KERNELS.items():
            by_kernel[lib] += knames[0] in name
            if any(n in name for n in knames):
                ms_by_kernel[lib] += dur / 1e3
    return result, {
        "traced_wall_s": wall, "traced_launches": by_kernel,
        "traced_kernel_ms_by_lib": ms_by_kernel, **activity,
        "device_idle_share": (1.0 - activity["device_busy_ms"] / 1e3 / wall
                              if activity["device_events"] else None),
        **_trace_tops(device, host)}


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
    expected = _structural(cfg, groups, "bfloat16")
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
           "expected_launches": _structural(cfg, cli_groups, "float32")}
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


def _serve_hybrid(cfg, values, n: int, prompt_len: int,
                  cache_dtype: str = "bfloat16") -> tuple:
    """``n`` prompts of ``prompt_len`` tokens, made as ``launch.serve``
    makes them, served over ``values`` as :func:`_serve_bf16` serves them,
    with a cache of ``cache_dtype``."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.serve import ServeConfig

    reqs = serve.make_requests(cfg, n, prompt_len, SERVE_NEW_TOKENS,
                               SERVE_SEED)
    return _serve(cfg, values, reqs, ServeConfig(
        max_batch=SERVE_MAX_BATCH, max_len=prompt_len + SERVE_NEW_TOKENS + 8,
        cache_dtype=getattr(torch, cache_dtype)))


def _recording_b2_b3(b2, b3):
    """Wrappers of B2's and B3's ops that count each call's (dtype, q's
    shape, Hkv, v's width, window) into ``b2`` and (dtype, M) into ``b3``,
    installed in ``ops`` (the models' call sites); returns a function that
    restores them."""
    from repro_torch.kernels import ops

    inner_b2, inner_b3 = ops.flash_attention_op, ops.fused_swiglu_op

    def rec_b2(q, k, v, causal, window, scale):
        b2[(str(q.dtype).removeprefix("torch."), tuple(q.shape),
            k.shape[1], v.shape[-1], window)] += 1
        return inner_b2(q, k, v, causal, window, scale)

    def rec_b3(x, wg, wi, wo):
        b3[(str(x.dtype).removeprefix("torch."), x.shape[0])] += 1
        return inner_b3(x, wg, wi, wo)

    ops.flash_attention_op, ops.fused_swiglu_op = rec_b2, rec_b3

    def restore():
        ops.flash_attention_op, ops.fused_swiglu_op = inner_b2, inner_b3

    return restore


def _b2_call(dtype: str, shape, hkv: int, dv: int) -> str:
    """One B2 call as :func:`_serve_slice` records it: dtype, q's shape,
    the KV heads and v's width."""
    return f"{dtype} {list(shape)} hkv {hkv} dv {dv}"


def _serve_slice(phase: str, cfg, device: dict, b2_widths=None,
                 runs=SERVE_RUNS, traced_run: int = 0, values=None,
                 cache_dtype: str = "bfloat16") -> dict:
    """``cfg`` at full width (``values``, or random bf16 weights from seed 0
    drawn on the card), served as ``serve`` serves tinyllama with a cache
    of ``cache_dtype``: the ``runs`` (by default both of
    :data:`SERVE_RUNS`) with every kernel's launch count set to 0 before
    and read after and held to the structure, every B2 call (dtype, shape,
    (q/k, v) widths, window) and B3 call (dtype, M) recorded there (the
    widths held to ``b2_widths`` where given), all again warm with the
    same greedy tokens, then run ``traced_run`` under ``torch.profiler``."""
    import collections
    import dataclasses

    import torch

    from repro_torch.models import lm_init, param_values
    from repro_torch.models.layers import tree_map

    init_s = None
    if values is None:
        t0 = time.perf_counter()
        values = param_values(lm_init(cfg, torch.Generator(
            device="cuda").manual_seed(SERVE_SEED), "cuda"))
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
    b2, b3 = collections.Counter(), collections.Counter()
    torch.cuda.reset_peak_memory_stats()
    restore = _recording_b2_b3(b2, b3)
    t0 = time.perf_counter()
    try:
        first = [_serve_hybrid(cfg, values, *r, cache_dtype) for r in runs]
    finally:
        restore()
    wall = time.perf_counter() - t0
    widths, windows = collections.Counter(), collections.Counter()
    calls = collections.Counter()
    for (dt, shape, hkv, dv, window), n in b2.items():
        widths[f"{shape[-1]}x{dv}"] += n
        windows[window] += n
        calls[_b2_call(dt, shape, hkv, dv)] += n
    launches = {lib: mod.launches for lib, mod in counters.items()}
    groups = [g for _, gs in first for g in gs]
    expected = _structural(cfg, groups, cache_dtype)
    for g in groups:
        emit({"phase": phase, "pass": "first", "group": g})
    warm = [_serve_hybrid(cfg, values, *r, cache_dtype) for r in runs]
    for _, gs in warm:
        for g in gs:
            emit({"phase": phase, "pass": "warm", "group": g})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    same_tokens = [t for t, _ in first] == [t for t, _ in warm]
    traced, trace = _traced(lambda: _serve_hybrid(
        cfg, values, *runs[traced_run], cache_dtype))
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
        "new_tokens": SERVE_NEW_TOKENS, "cache_dtype": cache_dtype,
        "runs": [list(r) for r in runs], "wall_s": wall,
        "forwards": sum(1 + g["decode_steps"] for g in groups),
        "launches": launches, "expected_launches": expected,
        "b2_widths": dict(widths), "b2_windows": dict(windows),
        "b2_calls": dict(calls),
        "b3_calls": {f"{dt} M {m}": n for (dt, m), n in b3.items()},
        "warm": [{k: g[k] for k in ("batch", "prompt_len", "ttft_s",
                                    "prefill_s", "decode_tokens_per_s")}
                 for _, gs in warm for g in gs],
        "peak_memory_gb": peak_gb,
        "tokens_equal_first_warm": same_tokens,
        "tokens_equal_traced_first": traced[0] == first[traced_run][0],
        "traced_run": list(runs[traced_run]), **trace,
    }
    emit(out)
    if launches != expected:
        raise AssertionError(f"{phase} launches {launches} != "
                             f"structural {expected}")
    if b2_widths is not None and dict(widths) != {
            b2_widths: launches["flash_attention"]}:
        raise AssertionError(f"{phase}: B2 took the widths {dict(widths)}, "
                             f"not {b2_widths} at each of its "
                             f"{launches['flash_attention']} launches")
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
    through :func:`_serve_slice`, every B2 call at MLA's own widths, q/k
    192 and v 128 columns, unpadded."""
    from repro_torch.configs import get_config

    return _serve_slice("serve_mla", get_config(MLA_ARCH).with_(
        n_layers=MLA_LAYERS), device, b2_widths="192x128")


def phase_serve_xlstm(device: dict) -> dict:
    """xlstm-350m at full width and depth through :func:`_serve_slice`."""
    from repro_torch.configs import get_config

    return _serve_slice("serve_xlstm", get_config(XLSTM_ARCH), device)


def phase_serve_gemma(device: dict) -> dict:
    """gemma3-4b whole at full width (:data:`GEMMA_ARCH`, bf16 weights)
    through :func:`_serve_slice` on :data:`GEMMA_RUNS`, every B2 call at
    (256, 256), the windowed layers' calls with gemma's 1,024-key window
    and the global ones' with none, the 4 x 2,048 run traced."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import ATTN_LOCAL

    cfg = get_config(GEMMA_ARCH).with_(param_dtype="bfloat16")
    out = _serve_slice("serve_gemma", cfg, device, b2_widths="256x256",
                       runs=GEMMA_RUNS, traced_run=len(GEMMA_RUNS) - 1)
    local = sum(s.mixer == ATTN_LOCAL for s in cfg.block_specs())
    prefills = out["launches"]["flash_attention"] // cfg.n_layers
    want = {cfg.sliding_window: local * prefills,
            0: (cfg.n_layers - local) * prefills}
    if out["b2_windows"] != want:
        raise AssertionError(f"serve_gemma: B2's windows {out['b2_windows']}"
                             f" are not {want}")
    return out


def phase_serve_fp32_cache(device: dict) -> dict:
    """tinyllama-1.1b whole, as ``launch.serve`` makes it (bf16 compute,
    random weights from seed 0 on the card), through :func:`_serve_slice`
    at the reference's default cache (fp32), the 8 x 512 run traced:
    every prefill's B2 call on fp32 q, k, v (the fp32 route)
    at (8, 32, 4, 512, 64) and (4, 32, 4, 200, 64), B3 in fp32 at M 4,096
    and 800 in the prefills (the residual stream is fp32 after the first
    attention layer); last :data:`FP32_CACHE_CPU_RUN` on the card and on
    the CPU from the card's weights, tokens equal."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models.layers import tree_map

    cfg, values, _, _ = serve.make_run(
        SERVE_ARCH, False, 1, 8, SERVE_NEW_TOKENS, SERVE_MAX_BATCH,
        SERVE_SEED, "cuda")
    out = _serve_slice("serve_fp32_cache", cfg, device, values=values,
                       cache_dtype="float32")
    card_short = _serve_hybrid(cfg, values, *FP32_CACHE_CPU_RUN,
                               "float32")[0]
    on_cpu = tree_map(lambda t: t.cpu(), values)
    del values
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu_short = _serve_hybrid(cfg, on_cpu, *FP32_CACHE_CPU_RUN,
                              "float32")[0]
    cpu = {"phase": "serve_fp32_cache", "device": device["nvidia_smi"],
           "cpu_run": list(FP32_CACHE_CPU_RUN),
           "cpu_s": time.perf_counter() - t0,
           "tokens_equal_cpu": card_short == cpu_short}
    emit(cpu)
    want_b2 = {_b2_call("float32", (n, cfg.n_heads, plen, cfg.head_dim),
                        cfg.n_kv_heads, cfg.head_dim): cfg.n_layers
               for n, plen in SERVE_RUNS}
    if out["b2_calls"] != want_b2:
        raise AssertionError(f"serve_fp32_cache: B2 calls {out['b2_calls']},"
                             f" not {want_b2}")
    prefill_b3 = {f"float32 M {n * plen}": cfg.n_layers
                  for n, plen in SERVE_RUNS}
    if any(out["b3_calls"].get(k) != v for k, v in prefill_b3.items()):
        raise AssertionError(f"serve_fp32_cache: B3 calls {out['b3_calls']}"
                             f" lack the fp32 prefills {prefill_b3}")
    if not cpu["tokens_equal_cpu"]:
        raise AssertionError("serve_fp32_cache: the card's tokens differ "
                             "from the CPU's")
    return {**out, **cpu}


def phase_gemma_vs_cpu() -> dict:
    """gemma3-4b at full width cut to :data:`GEMMA_VS_CPU_LAYERS` layers
    (``local_global_period`` 2: a windowed layer and a global one) in fp32,
    on the card through the kernels (B2 at d 256 on its fp32 route, the
    window cutting the 1,100-token prompt's keys) and on the CPU through
    their plain versions, from the same weights: the uncached forward's
    logits within :data:`SERVE_VS_CPU_TOL`, its launches one forward's,
    and 8 greedy tokens of the serving engine (the default fp32 cache)
    equal."""
    import collections

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm_apply, lm_init, param_values
    from repro_torch.models.layers import tree_map
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(GEMMA_ARCH).with_(
        n_layers=GEMMA_VS_CPU_LAYERS, local_global_period=2,
        compute_dtype="float32")
    values = param_values(lm_init(cfg, torch.Generator().manual_seed(0),
                                  "cpu"))
    on_card = tree_map(lambda t: t.to("cuda"), values)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab,
                                               GEMMA_VS_CPU_PROMPT)
    tokens = torch.from_numpy(prompt[None, :].astype(np.int64))
    counters = _lm_counters()
    for mod in counters.values():
        mod.launches = 0
    b2, b3 = collections.Counter(), collections.Counter()
    restore = _recording_b2_b3(b2, b3)
    try:
        got = lm_apply(on_card, cfg, tokens.cuda())[0].cpu()
    finally:
        restore()
    launches = {lib: mod.launches for lib, mod in counters.items()}
    want = lm_apply(values, cfg, tokens)[0]
    err = float((got - want).abs().max())
    max_logit = float(want.abs().max())
    close = bool(torch.isfinite(got).all()) and torch.allclose(
        got, want, rtol=SERVE_VS_CPU_TOL, atol=SERVE_VS_CPU_TOL)
    del got, want

    def greedy(vals):
        eng = ServeEngine(cfg, vals, ServeConfig(
            max_batch=1, max_len=GEMMA_VS_CPU_PROMPT + 16))
        return eng.generate([Request(rid=0, prompt=prompt.astype(np.int32),
                                     max_new_tokens=8)])[0]

    card_tokens, cpu_tokens = greedy(on_card), greedy(values)
    del on_card
    torch.cuda.empty_cache()
    out = {"phase": "gemma_vs_cpu", "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "d_head": cfg.head_dim,
           "window": cfg.sliding_window, "prompt_len": GEMMA_VS_CPU_PROMPT,
           "compute_dtype": "float32", "max_abs_err": err,
           "max_abs_logit": max_logit, "tol": SERVE_VS_CPU_TOL,
           "close": close,
           "launches_forward": launches,
           "b2_calls": {f"{dt} {list(shape)} window {w}": n
                        for (dt, shape, _, _, w), n in b2.items()},
           "card_tokens": card_tokens, "cpu_tokens": cpu_tokens}
    emit(out)
    if not close or card_tokens != cpu_tokens:
        raise AssertionError("gemma_vs_cpu: the card's fp32 forward "
                             "disagrees with the CPU's")
    if launches != _per_forward(cfg) or sum(b2.values()) != cfg.n_layers:
        raise AssertionError(f"gemma_vs_cpu: {launches} launches, "
                             f"not {_per_forward(cfg)}")
    return out


class _RouterChoices:
    """While active, records at every MoE call of the model the experts
    each token chooses (sorted) and its gate margin (the k-th gate less
    the (k+1)-th), so that two runs' routing can be compared."""

    def __enter__(self):
        import torch

        from repro_torch.models import blocks

        self.calls, self._inner = [], blocks.moe_apply

        def recording(params, cfg, x, act="silu"):
            with torch.no_grad():
                gates = torch.softmax(
                    x.float() @ params["router"].float(), -1)
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
           "expected_launches": _structural(cfg, groups, "float32")}
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


# -- whisper and training -----------------------------------------------------

# the device these phases run on (a rehearsal of their control flow may
# point it at the CPU; the script itself always runs on the card)
CARD = "cuda"

def _whisper_launches(cfg, steps: int) -> dict:
    """Launches of one ``transcribe`` of ``steps`` tokens: the encoder once
    (B2 at every layer, non-causal; B4 before its mixer and FFN and
    ``enc_norm``), then per step the decoder's B4 before self-attention,
    cross-attention and the FFN at each layer and the final norm (one
    token a step: its self-attention is plain; the FFN is GeLU: no B3)."""
    enc = _per_layer(cfg, cfg.block_specs()[0])
    return {"flash_attention": cfg.n_enc_layers * enc["flash_attention"],
            "fused_ffn": 0, "mla_decode": 0,
            "rmsnorm": cfg.n_enc_layers * enc["rmsnorm"] + 1
            + steps * (3 * cfg.n_layers + 1)}


def _transcribe(eng, frames) -> tuple:
    tokens = eng.transcribe(frames, max_new_tokens=WHISPER_NEW_TOKENS)
    st = dict(eng.stats[-1])
    st["decode_tokens_per_s"] = (st["batch"] * st["decode_steps"]
                                 / st["decode_s"])
    return tokens, st


def phase_serve_whisper(device: dict) -> dict:
    """whisper-base at full width (:data:`WHISPER_ARCH`) through
    ``EncDecEngine``: a first pass with every kernel's launch count set to
    0 before and read after and held to the structure, every B2 call
    recorded (non-causal, S 1,500, once per encoder layer), a warm pass
    and a traced one, all three with the same tokens."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import lm_init, param_values
    from repro_torch.serve import EncDecEngine, ServeConfig

    cfg = get_config(WHISPER_ARCH)
    t0 = time.perf_counter()
    values = param_values(lm_init(
        cfg, torch.Generator(device=CARD).manual_seed(SERVE_SEED), CARD))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    frames = serve.make_frames(cfg, WHISPER_BATCH, SERVE_SEED,
                               frames=cfg.n_frontend_tokens)
    eng = EncDecEngine(cfg, values, ServeConfig(
        max_batch=WHISPER_BATCH, max_len=WHISPER_NEW_TOKENS + 8,
        cache_dtype=torch.bfloat16))
    del values
    counters = _lm_counters()
    for mod in counters.values():
        mod.launches = 0
    calls, inner = [], ops.flash_attention_op

    def recording(q, k, v, causal, window, scale):
        calls.append((tuple(q.shape), causal))
        return inner(q, k, v, causal, window, scale)

    torch.cuda.reset_peak_memory_stats()
    ops.flash_attention_op = recording
    try:
        first, first_st = _transcribe(eng, frames)
    finally:
        ops.flash_attention_op = inner
    launches = {lib: mod.launches for lib, mod in counters.items()}
    expected = _whisper_launches(cfg, WHISPER_NEW_TOKENS)
    warm, warm_st = _transcribe(eng, frames)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    (traced, traced_st), trace = _traced(lambda: _transcribe(eng, frames))
    for name, st in (("first", first_st), ("warm", warm_st),
                     ("traced", traced_st)):
        emit({"phase": "serve_whisper", "pass": name, "group": st})
    enc_call = ((WHISPER_BATCH, cfg.n_heads, cfg.n_frontend_tokens,
                 cfg.head_dim), False)
    out = {
        "phase": "serve_whisper", "device": device["nvidia_smi"],
        "arch": cfg.name, "n_enc_layers": cfg.n_enc_layers,
        "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "frames": cfg.n_frontend_tokens, "batch": WHISPER_BATCH,
        "new_tokens": WHISPER_NEW_TOKENS, "cache_dtype": "bfloat16",
        "seed": SERVE_SEED, "init_s": init_s,
        "launches": launches, "expected_launches": expected,
        "b2_calls": [[list(shape), causal] for shape, causal in calls],
        "warm": {k: warm_st[k] for k in ("ttft_s", "decode_s",
                                         "decode_tokens_per_s")},
        "peak_memory_gb": peak_gb,
        "tokens_equal_first_warm_traced": first == warm == traced,
        **trace,
    }
    emit(out)
    _check_tokens("serve_whisper", dict(enumerate(first)), WHISPER_BATCH,
                  WHISPER_NEW_TOKENS, cfg.vocab)
    if launches != expected:
        raise AssertionError(f"serve_whisper launches {launches} != "
                             f"structural {expected}")
    if calls != [enc_call] * cfg.n_enc_layers:
        raise AssertionError(f"serve_whisper: B2 calls {calls}, not "
                             f"{cfg.n_enc_layers} x {enc_call}")
    if not out["tokens_equal_first_warm_traced"]:
        raise AssertionError("serve_whisper: the passes gave other tokens")
    return out


def phase_whisper_vs_cpu() -> dict:
    """whisper's fp32 smoke config (weights drawn on the CPU from seed 0,
    copied to the card), two rows of 16 frames as ``launch.serve`` draws
    them and 6 tokens: the encoder's output and the uncached forward's
    logits on the card within :data:`SERVE_VS_CPU_TOL` of the CPU's, its
    launches those of the structure (B2 at every encoder layer and, over
    6 fresh tokens, every decoder layer), and ``transcribe``'s 8 tokens
    equal."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import encdec_apply, lm_init, param_values
    from repro_torch.models.layers import tree_map
    from repro_torch.serve import EncDecEngine, ServeConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(WHISPER_ARCH, smoke=True)
    values = param_values(lm_init(
        cfg, torch.Generator().manual_seed(SERVE_SEED), "cpu"))
    on_card = tree_map(lambda t: t.to(CARD), values)
    frames = serve.make_frames(cfg, 2, SERVE_SEED)
    tokens = np.random.default_rng(SERVE_SEED).integers(0, cfg.vocab, (2, 6))
    f_cpu, t_cpu = torch.from_numpy(frames), torch.from_numpy(tokens)
    counters = _lm_counters()
    for mod in counters.values():
        mod.launches = 0
    got_logits, _, got_enc, _ = encdec_apply(on_card, cfg, f_cpu.to(CARD),
                                             t_cpu.to(CARD))
    launches = {lib: mod.launches for lib, mod in counters.items()}
    want_logits, _, want_enc, _ = encdec_apply(values, cfg, f_cpu, t_cpu)
    errs = {"enc_out": float((got_enc.cpu() - want_enc).abs().max()),
            "logits": float((got_logits.cpu() - want_logits).abs().max())}
    close = all(bool(torch.isfinite(g).all()) and torch.allclose(
        g.cpu(), w, rtol=SERVE_VS_CPU_TOL, atol=SERVE_VS_CPU_TOL)
        for g, w in ((got_enc, want_enc), (got_logits, want_logits)))
    dec = _per_layer(cfg, cfg.block_specs()[0])
    expected = {"flash_attention": (cfg.n_enc_layers + cfg.n_layers)
                * dec["flash_attention"], "fused_ffn": 0, "mla_decode": 0,
                "rmsnorm": cfg.n_enc_layers * dec["rmsnorm"] + 1
                + 3 * cfg.n_layers + 1}

    def transcribe(vals):
        return EncDecEngine(cfg, vals, ServeConfig(max_len=16)).transcribe(
            frames, max_new_tokens=8)

    card_tokens, cpu_tokens = transcribe(on_card), transcribe(values)
    out = {"phase": "whisper_vs_cpu", "compute_dtype": cfg.compute_dtype,
           "max_abs_err": errs, "tol": SERVE_VS_CPU_TOL, "close": close,
           "max_abs_logit": float(want_logits.abs().max()),
           "launches_forward": launches, "expected_launches": expected,
           "card_tokens": card_tokens, "cpu_tokens": cpu_tokens}
    emit(out)
    if not close or card_tokens != cpu_tokens:
        raise AssertionError("whisper: the card's fp32 forward disagrees "
                             "with the CPU's")
    if launches != expected:
        raise AssertionError(f"whisper: the card's forward made {launches} "
                             f"launches, not {expected}")
    return out


def _quiet_train(args) -> tuple:
    """``launch.train.run(args)`` with its log lines captured: its result
    and those lines."""
    import contextlib
    import io

    from repro_torch.launch import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = train.run(args)
    return out, buf.getvalue().splitlines()


def phase_train(device: dict) -> dict:
    """tinyllama-1.1b trained whole on the card through
    ``launch.train.run`` (:data:`TRAIN_ARGS`): first every parameter's
    gradient at the initial state on step 0's first microbatch (finite and
    non-zero: a kernel whose output had no ``grad_fn`` would leave the
    leaves behind it at zero), with that microbatch's launches held to the
    structure (the scanned layers twice: remat); the 6-step run with every
    kernel's launches held to 6 steps x 2 microbatches of that; one more
    step traced; then the run with a checkpoint every 3 steps and a
    failure at step 4, whose replayed steps must give the uninterrupted
    run's losses bit for bit, and whose final checkpoint must load back
    equal to the state it saved."""
    import shutil

    import torch

    from repro_torch.checkpoint import keypath_items, load_checkpoint
    from repro_torch.checkpoint.io import to_numpy
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.launch import train
    from repro_torch.models import lm_init, param_values
    from repro_torch.train import AdamWConfig, loss_and_grads, \
        make_train_step

    args = train.parser().parse_args(TRAIN_ARGS)
    cfg = get_config(args.arch, smoke=args.smoke)
    counters = _lm_counters()
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed))
    per_mb = _per_forward(cfg, scanned_times=2)

    # every parameter's gradient, on the first microbatch of step 0
    values = param_values(lm_init(
        cfg, torch.Generator(device=CARD).manual_seed(args.seed), CARD))
    mb = {k: v[:args.batch // args.microbatches]
          for k, v in to_device(data.batch_at(0), CARD).items()}
    for mod in counters.values():
        mod.launches = 0
    _, _, grads = loss_and_grads(cfg, values, mb)
    torch.cuda.synchronize()
    mb_launches = {lib: mod.launches for lib, mod in counters.items()}
    grad_check = {name: (bool(torch.isfinite(g).all()),
                         float(g.float().norm()))
                  for name, g in keypath_items(grads)}
    missing = [n for n, (finite, norm) in grad_check.items()
               if not finite or norm == 0.0]
    del values, grads, mb
    torch.cuda.empty_cache()

    # the uninterrupted run
    for mod in counters.values():
        mod.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plain, plain_log = _quiet_train(args)
    plain_wall = time.perf_counter() - t0
    launches = {lib: mod.launches for lib, mod in counters.items()}
    expected = {lib: n * args.microbatches * args.steps
                for lib, n in per_mb.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    warm_s = plain["step_s"][2:]
    step_s = sum(warm_s) / len(warm_s)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                          total_steps=args.steps, state_dtype=cfg.opt_dtype)
    step_fn = make_train_step(cfg, opt_cfg, args.microbatches)
    state = plain.pop("state")
    extra = to_device(data.batch_at(args.steps), CARD)

    def one_step():
        out = step_fn(state["params"], state["opt"], extra)
        torch.cuda.synchronize()
        return float(out[2]["loss"])

    _, trace = _traced(one_step)
    del state, step_fn
    torch.cuda.empty_cache()

    # the run with a checkpoint and a failure at TRAIN_FAIL_AT
    ckpt = WORK_DIR / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    WORK_DIR.mkdir(parents=True, exist_ok=True)
    disk_free_gb = shutil.disk_usage(WORK_DIR).free / 1e9
    t0 = time.perf_counter()
    failed, failed_log = _quiet_train(train.parser().parse_args(
        TRAIN_ARGS + ("--ckpt-dir", str(ckpt)) + TRAIN_FAIL_ARGS))
    failed_wall = time.perf_counter() - t0
    # restored from the last save before the failure
    restored_at = TRAIN_FAIL_AT // TRAIN_SAVE_EVERY * TRAIN_SAVE_EVERY
    replayed = failed["losses"][-(args.steps - restored_at):]
    replay_equal = replayed == plain["losses"][restored_at:] and \
        failed["losses"][:TRAIN_FAIL_AT] == plain["losses"][:TRAIN_FAIL_AT]
    ckpt_bytes = sum(f.stat().st_size for f in ckpt.rglob("*")
                     if f.is_file())
    t0 = time.perf_counter()
    restored, meta = load_checkpoint(str(ckpt), template=failed["state"])
    load_s = time.perf_counter() - t0
    differ = [name for (name, got), (_, want) in zip(
        keypath_items(restored), keypath_items(failed["state"]))
        if not np.array_equal(got, to_numpy(want))]
    n_leaves = len(keypath_items(restored))
    del restored, failed["state"]
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()

    tokens = args.batch * args.seq
    out = {
        "phase": "train", "device": device["nvidia_smi"], "arch": cfg.name,
        "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "params": sum(int(np.prod(leaf["shape"])) for name, leaf in
                      meta["leaves"].items() if name.startswith("['params']")),
        "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
        "opt_dtype": cfg.opt_dtype, "remat": cfg.remat,
        "args": list(TRAIN_ARGS), "fail_args": list(TRAIN_FAIL_ARGS),
        "grad_leaves": len(grad_check), "grads_missing": missing,
        "grad_norms": {n: v[1] for n, v in grad_check.items()},
        "microbatch_launches": mb_launches, "expected_microbatch": per_mb,
        "launches": launches, "expected_launches": expected,
        "losses": plain["losses"], "wall_s": plain_wall,
        "step_s": plain["step_s"], "warm_step_s": step_s,
        "tokens_per_s": tokens / step_s, "peak_memory_gb": peak_gb,
        "traced_step": trace,
        "failed_run": {"losses": failed["losses"], "wall_s": failed_wall,
                       "log": [line for line in failed_log
                               if "fault" in line or "resumed" in line]},
        "replay_bitwise_equal": replay_equal,
        "checkpoint": {"step": meta["step"], "leaves": n_leaves,
                       "bytes": ckpt_bytes, "load_s": load_s,
                       "disk_free_gb_before": disk_free_gb,
                       "leaves_differing": differ},
    }
    emit(out)
    if missing:
        raise AssertionError(f"train: no finite non-zero gradient for "
                             f"{missing}")
    if mb_launches != per_mb or launches != expected:
        raise AssertionError(f"train launches {mb_launches} / {launches} "
                             f"!= structural {per_mb} / {expected}")
    if not replay_equal:
        raise AssertionError("train: the restarted run's losses differ from "
                             "the uninterrupted run's")
    if differ or meta["step"] != args.steps:
        raise AssertionError(f"train: the checkpoint restored {differ} "
                             f"otherwise")
    if not all(np.isfinite(loss) for _, loss in plain["losses"]):
        raise AssertionError("train: a loss is not finite")
    return out


def _train_vs_cpu_case(arch: str) -> dict:
    """One step's loss and gradients of ``arch``'s fp32 smoke config
    (weights drawn on the CPU from seed 0, copied to the card; step 0 of
    the synthetic stream at 4 x 64) on the card against the CPU, the
    routing of every MoE call compared first, the card's launches those of
    one microbatch under remat."""
    import torch

    from repro_torch.checkpoint import keypath_items
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.models import lm_init, param_values
    from repro_torch.models.layers import tree_map
    from repro_torch.train import loss_and_grads

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, smoke=True)
    values = param_values(lm_init(
        cfg, torch.Generator().manual_seed(SERVE_SEED), "cpu"))
    on_card = tree_map(lambda t: t.to(CARD), values)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                   global_batch=4, seed=0)).batch_at(0)
    counters = _lm_counters()
    for mod in counters.values():
        mod.launches = 0
    with _RouterChoices() as card:
        loss_card, _, g_card = loss_and_grads(cfg, on_card,
                                              to_device(batch, CARD))
    launches = {lib: mod.launches for lib, mod in counters.items()}
    with _RouterChoices() as cpu:
        loss_cpu, _, g_cpu = loss_and_grads(cfg, values,
                                            to_device(batch, "cpu"))
    rerouted = sum(int((ce != we).any(-1).sum())
                   for (ce, _), (we, _) in zip(card.calls, cpu.calls))
    rel = {}
    for (name, gc), (_, gp) in zip(keypath_items(g_card),
                                   keypath_items(g_cpu)):
        rel[name] = float((gc.cpu() - gp).norm()
                          / gp.norm().clamp_min(1e-30))
    loss_err = abs(float(loss_card) - float(loss_cpu))
    out = {"phase": "train_vs_cpu", "arch": arch,
           "layers": [f"{s.mixer}+{s.ffn}" for s in cfg.block_specs()],
           "loss_card": float(loss_card), "loss_cpu": float(loss_cpu),
           "loss_abs_err": loss_err, "loss_tol": TRAIN_VS_CPU_LOSS_TOL,
           "grad_rel_err_max": max(rel.values()),
           "grad_rel_err_worst": max(rel, key=rel.get),
           "grad_tol": TRAIN_VS_CPU_GRAD_TOL, "grad_leaves": len(rel),
           "moe_calls": len(card.calls), "rerouted": rerouted,
           "min_gate_margin": min((float(m.min()) for _, m in cpu.calls),
                                  default=None),
           "launches": launches,
           "expected_launches": _per_forward(cfg, scanned_times=2)}
    emit(out)
    if rerouted or len(card.calls) != len(cpu.calls):
        raise AssertionError(f"{arch}: the card routed {rerouted} token "
                             f"choices otherwise than the CPU")
    if loss_err > TRAIN_VS_CPU_LOSS_TOL * max(1.0, abs(float(loss_cpu))) \
            or out["grad_rel_err_max"] > TRAIN_VS_CPU_GRAD_TOL:
        raise AssertionError(f"{arch}: the card's train step disagrees with "
                             f"the CPU's")
    if launches != out["expected_launches"]:
        raise AssertionError(f"{arch}: the card's step made {launches} "
                             f"launches, not {out['expected_launches']}")
    return out


def phase_train_vs_cpu() -> dict:
    """:func:`_train_vs_cpu_case` for each of :data:`TRAIN_VS_CPU_ARCHS`."""
    return {"cases": [_train_vs_cpu_case(a) for a in TRAIN_VS_CPU_ARCHS]}


# -- the H100 planner ---------------------------------------------------------

# plan_h100: `python -m repro_torch plan-h100` at its defaults (all ten
# configs, 2,000 samples, 8,192 tokens, seed 0) on the card; every plan
# held to the same search on the vector backend on the CPU
PLAN_H100_ARGS = ("--device", "cuda", "plan-h100")
PLAN_H100_TOKENS = 8192
PLAN_FIELDS = ("fusion_groups", "hbm_bytes", "hbm_bytes_unfused",
               "glb_budget", "block_m", "layer_idx")


def _layer_forward_device_ms(tokens: int) -> dict:
    """One tinyllama-1.1b layer's forward (layer 0 at full width, bf16
    parameters from seed 0, one sequence of ``tokens``) on the card: the
    profiler's device time of a warm call."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import blocks, param_values

    cfg = get_config("tinyllama-1.1b")
    spec = cfg.block_specs()[0]
    gen = torch.Generator(device=CARD).manual_seed(0)
    vals = param_values(blocks.block_init(gen, cfg, spec, torch.bfloat16,
                                          CARD))
    x = (torch.randn((1, tokens, cfg.d_model), generator=gen,
                     device=CARD) * 0.5).to(torch.bfloat16)
    pos = torch.arange(tokens, device=CARD)[None]

    def fwd():
        with torch.no_grad():
            out = blocks.block_apply(vals, cfg, spec, x, pos, fresh=True)[0]
        torch.cuda.synchronize()
        return out

    fwd()
    _, trace = _traced(fwd)
    return {"device_busy_ms": trace["device_busy_ms"],
            "traced_wall_s": trace["traced_wall_s"],
            "top_device_ms": trace["top_device_ms"][:6]}


def phase_plan_h100() -> dict:
    """Cocco as the H100's execution planner through the CLI entry point:
    ten plans on the card (B1 once a GA generation), each equal to the
    vector backend's on the CPU; beside tinyllama's, its modeled HBM
    bytes over the card's rate and the device time of one layer's forward
    at the same tokens (for PERF.md, not a gate)."""
    import contextlib
    import io

    from repro_torch.api import cli
    from repro_torch.configs import get_config
    from repro_torch.core import h100_adapter
    from repro_torch.kernels import finish_batch as fb
    from repro_torch.obs import Recorder, recording

    plans = []
    inner = cli.plan_h100

    def keep(*a, **kw):
        plans.append(inner(*a, **kw))
        return plans[-1]

    rec, buf = Recorder(), io.StringIO()
    fb.launches = 0
    cli.plan_h100 = keep
    try:
        t0 = time.perf_counter()
        with recording(rec), contextlib.redirect_stdout(buf):
            rc = cli.main(list(PLAN_H100_ARGS))
        wall = time.perf_counter() - t0
    finally:
        cli.plan_h100 = inner
    launches = fb.launches
    batches = rec.counters.get("engine.array_batches", 0)
    lines = buf.getvalue().splitlines()
    differ = []
    t0 = time.perf_counter()
    for plan in plans:
        want = h100_adapter.plan_architecture(
            get_config(plan.arch), tokens_local=PLAN_H100_TOKENS,
            sample_budget=2_000, seed=0, device="cpu",
            eval_backend="vector")
        if any(getattr(plan, f) != getattr(want, f) for f in PLAN_FIELDS):
            differ.append(plan.arch)
    wall_vector = time.perf_counter() - t0
    tiny = next(p for p in plans if p.arch == "tinyllama-1.1b")
    out = {"phase": "plan_h100", "args": list(PLAN_H100_ARGS), "rc": rc,
           "summaries": lines, "wall_s": wall, "wall_vector_s": wall_vector,
           "kernel_launches": launches, "array_batches": batches,
           "plans": {p.arch: {"glb_budget": p.glb_budget,
                              "traffic_saving": p.traffic_saving,
                              "hbm_bytes": p.hbm_bytes,
                              "hbm_bytes_unfused": p.hbm_bytes_unfused,
                              "block_m": p.block_m,
                              "groups": len(p.fusion_groups)}
                     for p in plans},
           "differ_from_vector": differ,
           "tinyllama_l0": {
               "modeled_hbm_bytes": tiny.hbm_bytes,
               "modeled_hbm_ms": tiny.hbm_bytes / HBM_BYTES_PER_S * 1e3,
               "modeled_unfused_ms": (tiny.hbm_bytes_unfused
                                      / HBM_BYTES_PER_S * 1e3),
               "tp_degree_in_graph": 16,
               "layer_forward": _layer_forward_device_ms(PLAN_H100_TOKENS)}}
    emit(out)
    if rc != 0 or len(lines) != 10 or len(plans) != 10:
        raise AssertionError(f"plan-h100 exited {rc} with {len(lines)} "
                             f"summaries")
    if differ:
        raise AssertionError(f"plan-h100: {differ} differ from the vector "
                             f"backend's plans")
    if launches == 0 or launches != batches:
        raise AssertionError(f"plan-h100: {launches} launches for "
                             f"{batches} batches")
    return out


# -- the examples --------------------------------------------------------------

# examples: the port's four examples through their main([...]) on the card
# at their own defaults (quickstart: ResNet-50 at 4,000 samples, population
# 60; the plan search: the ten configs at 2,000 samples; serve_lm: the fp32
# smoke configs of tinyllama-1.1b and xlstm-350m, 4 x 8 prompt tokens and 6
# new ones, and whisper-base's, 2 x 12 frames; train_tinylm: the ~100M fp32
# config, 4 x 256 tokens in 2 microbatches, 300 steps, a checkpoint every
# 50 and a failure injected at step 60), each held to the same on the CPU:
# quickstart and the plan search byte for byte, serve_lm with the plan
# latency masked, and the trainer's first EXAMPLE_CPU_STEPS losses within
# the train_vs_cpu tolerance of the example's run for that many steps on
# the CPU (through launch.train.run: the example's own check that the loss
# fell does not hold after so few warmup steps).  The CPU runs take the
# card's weights and initial parameters (drawn from seed 0 by a CUDA
# generator, whose draws a CPU generator does not give); then
# scripts/smoke_serve_plans_torch.py --device cuda in a subprocess
EXAMPLE_CPU_STEPS = 5
SMOKE_SCRIPT_TIMEOUT = 300  # seconds
PLAN_LATENCY = r" in \d+\.\dms$"


def _load_example(name: str):
    """``examples/<name>.py`` imported as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_example(mod, argv, counters) -> dict:
    """``mod.main(argv)`` with its output captured and every kernel's count
    from 0: its output, wall s and launches by kernel; raises unless it
    exits 0."""
    import torch

    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    rc, text = _quiet(mod.main, list(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"examples: {mod.__name__} {argv} exited "
                             f"{rc}:\n{text}")
    return {"text": text, "wall_s": wall,
            "launches": {lib: c.launches for lib, c in counters.items()}}


def _train_example(mod, argv, counters) -> tuple:
    """The train example at ``argv`` in a fresh directory (its ``runs/``
    checkpoints removed after): :func:`_run_example`'s record,
    ``launch.train.run``'s result and the arguments the example gave it."""
    import shutil
    import tempfile

    from repro_torch.launch import train

    runs, inner = [], train.run

    def keep(args):
        runs.append((inner(args), args))
        return runs[-1][0]

    WORK_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="train_example_", dir=WORK_DIR)
    train.run = keep
    try:
        os.chdir(tmp)
        rec = _run_example(mod, argv, counters)
    finally:
        train.run = inner
        os.chdir(ROOT)
        shutil.rmtree(tmp, ignore_errors=True)
    return (rec, *runs[0])


def _smoke_script() -> dict:
    """``scripts/smoke_serve_plans_torch.py --device cuda`` in its own
    process group, killed whole at :data:`SMOKE_SCRIPT_TIMEOUT`."""
    import signal

    cmd = [sys.executable, str(ROOT / "scripts" /
                               "smoke_serve_plans_torch.py"),
           "--device", "cuda"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        text = proc.communicate(timeout=SMOKE_SCRIPT_TIMEOUT)[0]
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        text = proc.communicate()[0]
    wall = time.perf_counter() - t0
    ok = [line for line in text.splitlines() if line.startswith("smoke OK")]
    out = {"rc": proc.returncode, "wall_s": wall,
           "result": ok[0] if ok else None}
    if proc.returncode != 0 or not ok:
        raise AssertionError(f"examples: {' '.join(cmd[1:])} exited "
                             f"{proc.returncode}:\n{text[-4000:]}")
    return out


def _example_step_trace(cfg, a, state) -> dict:
    """One more step of the train example on the card from its final
    ``state``, with the example's arguments ``a`` (its ``run_args``),
    under ``torch.profiler``: :func:`_traced`'s record, with each LM
    kernel's share of the device's busy time."""
    import torch

    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.train import AdamWConfig, make_train_step

    opt_cfg = AdamWConfig(lr=a.lr, warmup_steps=a.warmup,
                          total_steps=a.steps, state_dtype=cfg.opt_dtype)
    step_fn = make_train_step(cfg, opt_cfg, microbatches=a.microbatches)
    batch = to_device(SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=a.seq, global_batch=a.batch,
        seed=a.seed)).batch_at(a.steps), CARD)

    def one_step():
        out = step_fn(state["params"], state["opt"], batch)
        torch.cuda.synchronize()
        return float(out[2]["loss"])

    one_step()
    _, trace = _traced(one_step)
    busy = trace["device_busy_ms"]
    trace["kernel_share_of_busy"] = {
        lib: ms / busy if busy else None
        for lib, ms in trace["traced_kernel_ms_by_lib"].items()}
    return trace


def phase_examples(device: dict) -> dict:
    """The port's four examples on the card at their defaults, each held
    to its run on the CPU, then the plan server's smoke script on the
    card; B1-B4 each launched by the examples."""
    import re

    import torch

    from repro_torch.kernels import finish_batch as fb
    from repro_torch.launch import train
    from repro_torch.models.layers import tree_map
    from repro_torch.train import AdamWConfig, adamw_init

    torch.backends.cuda.matmul.allow_tf32 = False
    counters = {"finish_batch": fb, **_lm_counters()}
    card, cpu = ["--device", "cuda"], ["--device", "cpu"]
    out = {"phase": "examples", "device": device["nvidia_smi"]}
    launches = {lib: 0 for lib in counters}
    failed = []

    def record(name, on_card, on_cpu, equal, **extra):
        out[name] = {"wall_s": on_card["wall_s"],
                     "wall_cpu_s": on_cpu["wall_s"],
                     "launches": on_card["launches"],
                     "equal_to_cpu": equal, **extra}
        for lib, n in on_card["launches"].items():
            launches[lib] += n
        if not equal:
            failed.append(name)

    for name in ("quickstart_torch", "cocco_plan_search_torch"):
        mod = _load_example(name)
        on_card = _run_example(mod, card, counters)
        on_cpu = _run_example(mod, cpu, counters)
        record(name, on_card, on_cpu, on_card["text"] == on_cpu["text"],
               lines=on_card["text"].splitlines())

    # the CPU run serves the card's weights: a CUDA generator's draws are
    # not a CPU generator's
    mod = _load_example("serve_lm_torch")
    on_card = _run_example(mod, card, counters)
    drawn = mod.weights
    mod.weights = lambda arch, _: tree_map(torch.Tensor.cpu,
                                           drawn(arch, CARD))
    on_cpu = _run_example(mod, cpu, counters)
    masked = [re.sub(PLAN_LATENCY, " in …ms", r["text"], flags=re.M)
              for r in (on_card, on_cpu)]
    record("serve_lm_torch", on_card, on_cpu,
           masked[0] == masked[1] and masked[0].count(" -> [") == 10,
           lines=on_card["text"].splitlines())

    mod = _load_example("train_tinylm_torch")
    torch.cuda.reset_peak_memory_stats()
    on_card, run_card, card_args = _train_example(mod, card, counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the example's run on the CPU, without checkpoints, from the card
    # run's initial parameters
    args = mod.run_args(EXAMPLE_CPU_STEPS, False, "cpu")
    args.ckpt_dir = None
    start = tree_map(torch.Tensor.cpu, train.build_state(
        mod.SMALL, AdamWConfig(), CARD, args.seed)[0])
    build_state = train.build_state
    train.build_state = lambda cfg, opt_cfg, *_, **__: (
        start, adamw_init(start, opt_cfg))
    t0 = time.perf_counter()
    try:
        with mod.smoke_config(mod.SMALL):
            run_cpu, _ = _quiet(train.run, args)
    finally:
        train.build_state = build_state
    on_cpu = {"wall_s": time.perf_counter() - t0}
    card_first = [loss for _, loss in run_card["losses"][:EXAMPLE_CPU_STEPS]]
    cpu_losses = [loss for _, loss in run_cpu["losses"]]
    errs = [abs(a - b) for a, b in zip(card_first, cpu_losses)]
    close = len(cpu_losses) == EXAMPLE_CPU_STEPS and all(
        e <= TRAIN_VS_CPU_LOSS_TOL * max(1.0, abs(b))
        for e, b in zip(errs, cpu_losses))
    # no remat: one forward a microbatch, 2 microbatches a step
    expected = {lib: n * 2 * len(run_card["losses"])
                for lib, n in _per_forward(mod.SMALL).items()}
    warm = run_card["step_s"][2:]
    step_s = sum(warm) / len(warm)
    log = on_card["text"].splitlines()
    restarted = "[fault-injection] restarted from 50" in log
    trace = _example_step_trace(mod.SMALL, card_args, run_card.pop("state"))
    run_cpu.pop("state")
    torch.cuda.empty_cache()
    record("train_tinylm_torch", on_card, on_cpu, close and restarted,
           params=mod.SMALL.param_count(),
           steps_run=len(run_card["losses"]), warm_step_s=step_s,
           tokens_per_s=card_args.batch * card_args.seq / step_s, peak_memory_gb=peak_gb,
           first_loss=run_card["first_loss"],
           last_loss=run_card["last_loss"], restarted_from_50=restarted,
           card_losses=card_first, cpu_losses=cpu_losses,
           max_loss_abs_err=max(errs, default=None),
           loss_tol=TRAIN_VS_CPU_LOSS_TOL, last_line=log[-1],
           expected_launches=expected, traced_step=trace)
    out["smoke_serve_plans_torch"] = _smoke_script()
    out["launches"] = launches
    emit(out)
    if failed:
        raise AssertionError(f"examples: {failed} disagree with the CPU")
    # the latent MLA decode has no path here: no example decodes MLA at
    # its widths (the smoke configs' are narrower)
    idle = [lib for lib, n in launches.items()
            if n == 0 and lib != "mla_decode"]
    if idle:
        raise AssertionError(f"examples: {idle} never launched")
    if launches["mla_decode"]:
        raise AssertionError("examples: mla_decode launched at the smoke "
                             "widths")
    if not run_card["last_loss"] < run_card["first_loss"]:
        raise AssertionError("examples: the trainer did not learn")
    trained = {lib: on_card["launches"][lib] for lib in expected}
    if trained != expected:
        raise AssertionError(f"examples: the trainer made {trained} "
                             f"launches, not {expected}")
    return out


# -- the sharded train step ----------------------------------------------------

# sharded: train's traffic (tinyllama-1.1b whole, 8 x 512 in 2
# microbatches, fp32 parameters and AdamW state, bf16 compute, remat) for
# 3 steps through launch.train.run, without a mesh and then with
# --model-parallel 1 on a (data 1, model 1) mesh under a world-1 NCCL group
SHARDED_ARGS = ("--device", "cuda", "--arch", "tinyllama-1.1b", "--steps",
                "3", "--batch", "8", "--seq", "512", "--microbatches", "2",
                "--lr", "3e-3", "--warmup", "2", "--seed", "0",
                "--log-every", "1")
SHARDED_REL_TOL = 1e-6  # a leaf some DTensor op rounds otherwise


def phase_sharded(device: dict) -> dict:
    """The DTensor route of the train step on the card: the same 3 steps
    without a mesh and on a (1, 1) mesh of ``DTensor``s (B2-B4 through
    ``local_map``) in one process: losses and every parameter after step
    3 bit for bit (or within :data:`SHARDED_REL_TOL` relative to the
    leaf's norm, the leaf named), B2-B4's launches equal and equal to the
    structure; int8 error-feedback compression of the mesh's first
    gradient tree on the card equal to the CPU's, bit for bit."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import keypath_items
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.launch import train
    from repro_torch.launch.mesh import rules_for
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import mesh_context
    from repro_torch.runtime import build_mesh, plan_mesh
    from repro_torch.train import AdamWConfig, loss_and_grads

    args = train.parser().parse_args(SHARDED_ARGS)
    cfg = get_config(args.arch, smoke=args.smoke)
    counters = _lm_counters()
    expected = {lib: n * args.microbatches * args.steps
                for lib, n in _per_forward(cfg, scanned_times=2).items()}

    def counted(a):
        for mod in counters.values():
            mod.launches = 0
        out, log = _quiet_train(a)
        return out, {lib: mod.launches for lib, mod in counters.items()}

    plain, plain_launches = counted(args)
    if not train._process_group(CARD):  # a world-1 NCCL group
        raise AssertionError("sharded: a process group already exists")
    try:
        meshed, mesh_launches = counted(train.parser().parse_args(
            SHARDED_ARGS + ("--model-parallel", "1")))
        params = dict(keypath_items(meshed["state"]["params"]))
        want = dict(keypath_items(plain["state"]["params"]))
        not_dt = [k for k, v in params.items()
                  if not hasattr(v, "placements")]
        differ, rel = [], {}
        for k, v in params.items():
            got = v.full_tensor() if hasattr(v, "placements") else v
            if not torch.equal(got, want[k]):
                differ.append(k)
                rel[k] = float((got.float() - want[k].float()).norm()
                               / want[k].float().norm().clamp_min(1e-30))
        placements = sorted({str(tuple(v.placements)) for v in params.values()
                             if hasattr(v, "placements")})
        del meshed["state"], plain["state"], params, want
        torch.cuda.empty_cache()

        # int8 error feedback over the mesh's gradient tree of step 0's
        # first microbatch, on the card and on the CPU
        mesh = build_mesh(plan_mesh(1, 1), CARD)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                      global_batch=args.batch,
                                      seed=args.seed))
        mb = {k: v[:args.batch // args.microbatches]
              for k, v in to_device(data.batch_at(0), CARD).items()}
        opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                              total_steps=args.steps,
                              state_dtype=cfg.opt_dtype)
        with mesh_context(mesh, rules_for(cfg, "train")):
            values, _ = train.build_state(cfg, opt_cfg, CARD, args.seed,
                                          mesh)
            _, _, grads = loss_and_grads(cfg, values, mb)
        del values
        grads = {k: g.full_tensor() for k, g in keypath_items(grads)}
        host = {k: g.cpu() for k, g in grads.items()}
        q, s, ef = coll.compress_int8_ef(grads, coll.ef_init(grads))
        dq, _ = coll.compressed_grad_step(grads, coll.ef_init(grads),
                                          "int8_ef")
        hq, hs, hef = coll.compress_int8_ef(host, coll.ef_init(host))
        hdq, _ = coll.compressed_grad_step(host, coll.ef_init(host),
                                           "int8_ef")
        compress_differ = [k for k in grads if not (
            torch.equal(q[k].cpu(), hq[k]) and torch.equal(s[k].cpu(), hs[k])
            and torch.equal(ef.residual[k].cpu(), hef.residual[k])
            and torch.equal(dq[k].cpu(), hdq[k]))]
        n_grad = sum(g.numel() for g in grads.values())
        del grads, host, q, s, ef, dq, hq, hs, hef, hdq
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    warm = (sum(plain["step_s"][1:]) / len(plain["step_s"][1:]),
            sum(meshed["step_s"][1:]) / len(meshed["step_s"][1:]))
    out = {"phase": "sharded", "device": device["nvidia_smi"],
           "arch": cfg.name, "args": list(SHARDED_ARGS),
           "mesh": [1, 1], "placements": placements,
           "losses": meshed["losses"], "losses_no_mesh": plain["losses"],
           "losses_bitwise_equal": meshed["losses"] == plain["losses"],
           "params_not_dtensor": not_dt,
           "params_differing": differ, "params_rel_err": rel,
           "launches": mesh_launches, "launches_no_mesh": plain_launches,
           "expected_launches": expected,
           "step_s": meshed["step_s"], "step_s_no_mesh": plain["step_s"],
           "warm_step_s": warm[1], "warm_step_s_no_mesh": warm[0],
           "dtensor_cost_s_per_step": warm[1] - warm[0],
           "int8_ef_elements": n_grad,
           "int8_ef_differ_from_cpu": compress_differ}
    emit(out)
    if not out["losses_bitwise_equal"]:
        raise AssertionError("sharded: the mesh's losses differ from the "
                             "run without one")
    if not_dt:
        raise AssertionError(f"sharded: {not_dt} are not DTensors")
    if any(e > SHARDED_REL_TOL for e in rel.values()):
        raise AssertionError(f"sharded: parameters off by {rel}")
    if mesh_launches != plain_launches or mesh_launches != expected:
        raise AssertionError(f"sharded: launches {mesh_launches} (no mesh "
                             f"{plain_launches}, structure {expected})")
    if compress_differ:
        raise AssertionError(f"sharded: int8 compression on the card "
                             f"differs from the CPU's at {compress_differ}")
    return out


# -- the dry run --------------------------------------------------------------

# the dry-run cells the phase traces through the CLI, at its default
# ``--device cuda``: (arch, shape, mesh)
DRYRUN_CELLS = (("tinyllama-1.1b", "train_4k", "single"),
                ("xlstm-350m", "decode_32k", "multi"))
DRYRUN_TIMEOUT = 300  # seconds, each subprocess
# the torch ops of each LM kernel library, as a row's kernel_calls names them
DRYRUN_OPS = {"rmsnorm": ("fused_rmsnorm",),
              "fused_ffn": ("fused_swiglu", "fused_swiglu_with_hidden"),
              "flash_attention": ("flash_attention",),
              "mla_decode": ("mla_decode",)}


def _ops_by_lib(calls: dict) -> dict:
    return {lib: sum(calls.get(op, 0) for op in ops)
            for lib, ops in DRYRUN_OPS.items()}


def _dryrun_card_check() -> None:
    """Run in a child process by :func:`phase_dryrun`: tinyllama-1.1b's
    train step at the ``sharded`` phase's batch (:data:`SHARDED_ARGS`) on
    a world of 1 (NCCL) and a (1, 1) mesh, traced by the dry run's
    ``trace_step`` once on fake ``cuda`` tensors and once on real ones;
    then three more real steps, uninstrumented and timed.  Prints one JSON
    line: both passes' counts, the real pass's kernel launches (the
    kernels' own counters, reset just before it), the traced peaks beside
    ``torch.cuda.max_memory_allocated`` and the roofline's bound beside
    the measured step."""
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun, roofline, train
    from repro_torch.launch.mesh import rules_for
    from repro_torch.parallel.sharding import mesh_context
    from repro_torch.runtime import build_mesh, plan_mesh

    args = train.parser().parse_args(SHARDED_ARGS)
    cfg = get_config(args.arch)
    shape = ShapeSpec("card", args.seq, args.batch, "train")
    train._process_group(CARD)
    mesh = build_mesh(plan_mesh(1, 1), CARD)
    counters = _lm_counters()

    def counts(c):
        return {"flops": c.flops, "bytes": c.bytes,
                "kernel_calls": c.kernel_calls, "coll_counts": c.coll_counts}

    try:
        with mesh_context(mesh, rules_for(cfg, "train")):
            with FakeTensorMode():
                step, a = dryrun.cell_step(cfg, shape, mesh, CARD,
                                           args.microbatches)
                t0 = time.perf_counter()
                fake, fake_peak = dryrun.trace_step(step, a)
                fake_s = time.perf_counter() - t0
                del step, a
            gen = torch.Generator(device=CARD).manual_seed(args.seed)
            step, a = dryrun.cell_step(cfg, shape, mesh, CARD,
                                       args.microbatches, gen)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for mod in counters.values():
                mod.launches = 0
            t0 = time.perf_counter()
            real, real_peak = dryrun.trace_step(step, a)
            torch.cuda.synchronize()
            real_s = time.perf_counter() - t0
            launches = {lib: mod.launches for lib, mod in counters.items()}
            max_alloc = torch.cuda.max_memory_allocated()
            step_s = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(*a)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
    finally:
        dist.destroy_process_group()
    rep = roofline.analyze(
        cfg.name, "card", "1x1", 1, real,
        roofline.model_flops_for(cfg, "train", args.seq, args.batch),
        bytes_per_device=float(real_peak))
    emit({"fake": counts(fake), "real": counts(real), "launches": launches,
          "fake_trace_s": fake_s, "real_traced_step_s": real_s,
          "step_s": step_s, "fake_peak_bytes": fake_peak,
          "real_traced_peak_bytes": real_peak,
          "max_memory_allocated": max_alloc,
          "t_compute_ms": rep.t_compute * 1e3,
          "t_memory_ms": rep.t_memory * 1e3,
          "t_collective_ms": rep.t_collective * 1e3,
          "bound_ms": max(rep.t_compute, rep.t_memory,
                          rep.t_collective) * 1e3,
          "bottleneck": rep.bottleneck})


def phase_dryrun(device: dict) -> dict:
    """The dry run on the card's machine: ``python -m
    repro_torch.launch.dryrun`` at its default ``--device cuda`` for
    :data:`DRYRUN_CELLS` (each row on its fake world of 256 or 512 ranks,
    its bottleneck one of the three, tinyllama's kernel calls naming
    B2-B4), and :func:`_dryrun_card_check` beside them, all three in
    subprocesses at once: the fake and the real pass of the same step
    count the same FLOPs, kernel calls and collectives, and the real
    pass's launches equal its kernel calls."""
    import torch

    torch.cuda.empty_cache()
    out_dir = WORK_DIR / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(SRC), str(ROOT), os.environ.get("PYTHONPATH", "")])}
    procs = {}
    t0 = time.perf_counter()
    for arch, shape, mesh in DRYRUN_CELLS:
        procs[(arch, shape, mesh)] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--out", str(out_dir)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    procs["card"] = subprocess.Popen(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke._dryrun_card_check()"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    done, failed = {}, []
    for key, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
            failed.append(f"{key}: no end within {DRYRUN_TIMEOUT} s")
        done[key] = (proc.returncode, stdout, stderr)
    seconds = time.perf_counter() - t0
    rows, cells = {}, []
    for arch, shape, mesh in DRYRUN_CELLS:
        rc, stdout, stderr = done[(arch, shape, mesh)]
        multi = mesh == "multi"
        name = f"{arch}__{shape}__{'pod2x16x16' if multi else 'pod16x16'}"
        path = out_dir / f"{name}.json"
        row = json.loads(path.read_text()) if path.is_file() else {}
        rows[name] = row
        cells.append({k: row.get(k) for k in (
            "arch", "shape", "mesh", "devices", "lower_s", "t_compute_ms",
            "t_memory_ms", "t_collective_ms", "bottleneck", "hlo_gflops",
            "hlo_gbytes", "coll_gbytes", "coll_counts", "kernel_calls",
            "peak_bytes", "counted_at")})
        if rc != 0 or "error" in row or not row:
            failed.append(f"{name}: exit {rc}: {row.get('error')} "
                          f"{stderr[-2000:]}")
            continue
        if row["devices"] != (512 if multi else 256):
            failed.append(f"{name}: {row['devices']} devices")
        if row["bottleneck"] not in ("compute", "memory", "collective"):
            failed.append(f"{name}: bottleneck {row['bottleneck']}")
        if row.get("counted_at") != "per_device":
            failed.append(f"{name}: counted_at {row.get('counted_at')}")
    tiny = rows.get("tinyllama-1.1b__train_4k__pod16x16", {})
    if "kernel_calls" in tiny and not all(  # B2-B4: mla_decode is decode's
            n for lib, n in _ops_by_lib(tiny["kernel_calls"]).items()
            if lib != "mla_decode"):
        failed.append(f"tinyllama train_4k: kernel calls "
                      f"{tiny['kernel_calls']} miss one of B2-B4")
    rc, stdout, stderr = done["card"]
    card = {}
    if rc != 0:
        failed.append(f"card check: exit {rc}: {stderr[-3000:]}")
    else:
        card = json.loads(stdout.strip().splitlines()[-1])
        fake, real = card["fake"], card["real"]
        for key in ("flops", "kernel_calls", "coll_counts"):
            if fake[key] != real[key]:
                failed.append(f"card check: {key} fake {fake[key]} != real "
                              f"{real[key]}")
        if card["launches"] != _ops_by_lib(real["kernel_calls"]):
            failed.append(f"card check: launches {card['launches']} != "
                          f"kernel calls {real['kernel_calls']}")
    out = {"phase": "dryrun", "device": device["nvidia_smi"],
           "seconds": seconds, "cells": cells,
           "card_check": card,
           "launches": card.get("launches", {})}
    emit(out)
    if failed:
        raise AssertionError("dryrun: " + "; ".join(failed))
    return out


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


def _mla_decode_inputs(b, t, seed, h=128):
    """MLA's latent decode inputs as ``mla_apply`` hands them over: q_lat
    ``[B, H, 512]`` (a view of the ``[H, B, 512]`` product), q_rope ``[B,
    H, 64]`` (the rope columns of the ``[B, H, 192]`` query), ckv ``[B, T,
    512]`` and k_rope ``[B, T, 64]`` (a view of the ``[B, T, 1, 64]``
    cache), bf16, and each row's position (int64), drawn from
    ``[T / 2, T + 8)`` with the first row at 0 and the last at ``T - 1``;
    and the scale ``1/sqrt(192)``.  The queries are drawn at std 2, so
    that the logits have std ~3.5 and attention is peaked, as a trained
    model's is: on near-uniform weights the output averages to ~0 and
    hides a wrong slot or weight."""
    import torch

    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)
    pos = torch.randint(t // 2, t + 8, (b,), generator=g, device="cuda")
    pos[0], pos[-1] = 0, t - 1
    return (_randn((h, b, 512), bf16, seed, 2.0).transpose(0, 1),
            _randn((b, h, 192), bf16, seed + 1, 2.0)[..., 128:],
            _randn((b, t, 512), bf16, seed + 2),
            _randn((b, t, 1, 64), bf16, seed + 3)[:, :, 0],
            pos), 192 ** -0.5


def _mla_decode_bytes_ops(args) -> tuple:
    """The bytes ``mla_decode`` must move (each row's live cache slots, q
    and the output once) and its operations (the products over the live
    slots), from its inputs."""
    q_lat, _, ckv, _, pos = args
    b, h, kvr = q_lat.shape
    live = int((pos + 1).clamp(0, ckv.shape[1]).sum())
    return ((live * (kvr + 64) + b * h * (2 * kvr + 64)) * 2,
            2 * h * live * (2 * kvr + 64))


def _lm_calls():
    """(kernel library, case, kernel call, plain call) for every case of
    the kernel-against-plain phase, in both dtypes; each kernel called as
    its torch op (``repro_torch::...``), as the models call it."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import mla_decode as md
    from repro_torch.kernels import rmsnorm as rn

    for i, (b, t) in enumerate(MLA_DECODE_CASES + ((66, 300), (2, 2184))):
        # (66, 300): 132 blocks, one split, no combine; (2, 2184): 33
        # splits, the first row live at slot 0 alone
        args, scale = _mla_decode_inputs(b, t, 170 + 5 * i)
        yield ("mla_decode", {"b": b, "h": 128, "t": t, "repeat": True,
                              **MLA_DECODE_TOL},
               torch.bfloat16,
               lambda a=args, sc=scale: md.mla_decode_op(*a, sc),
               lambda a=args, sc=scale: md.mla_decode_plain(*a, sc))

    for i, (b, h, s_len, dqk, dv, tname) in enumerate(MLA_ATTN_CASES):
        dtype = getattr(torch, tname)
        args, scale = _mla_attn_inputs(b, h, s_len, dqk, dv, dtype, 90 + i)
        unpadded = (dqk, dv) in fa.WIDTH_PAIRS
        for padded in ((False, True) if i == 0 else (not unpadded,)):
            a = args[:3] if padded else args[3:]
            yield ("flash_attention",
                   {"b": b, "h": h, "hkv": h, "s": s_len,
                    "d": a[0].shape[-1], "dv": a[2].shape[-1],
                    "mla": {"qk": dqk, "v": dv, "padded": padded},
                    "scale": scale, "causal": True, "window": 0}, dtype,
                   lambda a=a, sc=scale: fa.flash_attention_op(
                       *a, True, 0, sc),
                   lambda a=a, sc=scale: fa.attention_plain(*a, scale=sc))
    for i, (m, d, f) in enumerate(DEEPSEEK_FFN_CASES):
        args = _ffn_inputs(m, d, f, torch.bfloat16, 100 + 4 * i)
        yield ("fused_ffn", {"m": m, "d": d, "f": f}, torch.bfloat16,
               lambda a=args: ff.fused_swiglu_op(*a),
               lambda a=args: ff.swiglu_plain(*a))
    for dtype in (torch.bfloat16, torch.float32):
        for i, (m, d, off) in enumerate(RMS_CASES):
            args = _rms_inputs(m, d, dtype, 10 + i, off)
            vec = rn.vector_route(args[0].data_ptr(), args[1].data_ptr(), 0,
                                  d, dtype.itemsize)
            yield ("rmsnorm", {"m": m, "d": d, "offset": off,
                               "route": "vector" if vec else "scalar"},
                   dtype,
                   lambda a=args: rn.fused_rmsnorm_op(*a, 1e-5),
                   lambda a=args: rn.rmsnorm_plain(*a))
        f32 = dtype == torch.float32
        ffn_cases = FFN_CASES + (FFN_F32_CASES if f32 else JAMBA_FFN_CASES)
        for i, (m, d, f) in enumerate(ffn_cases):
            args = _ffn_inputs(m, d, f, dtype, 20 + 4 * i)
            yield ("fused_ffn", {"m": m, "d": d, "f": f, "repeat": f32},
                   dtype, lambda a=args: ff.fused_swiglu_op(*a),
                   lambda a=args: ff.swiglu_plain(*a))
        for i, (b, h, hkv, s, d, causal, window) in enumerate(
                ATTN_CASES + ATTN_SWEEP):
            args = _attn_inputs(b, h, hkv, s, d, dtype, 40 + 3 * i)
            kw = {"causal": causal, "window": window}
            yield ("flash_attention",
                   {"b": b, "h": h, "hkv": hkv, "s": s, "d": d, **kw,
                    "sweep": i >= len(ATTN_CASES), "repeat": f32}, dtype,
                   lambda a=args, kw=kw: fa.flash_attention_op(
                       *a, kw["causal"], kw["window"], None),
                   lambda a=args, kw=kw: fa.attention_plain(*a, **kw))


def _backward_inputs(lib, shape, dtype, seed):
    """The inputs of one :data:`BACKWARD_CASES` case as leaves that require
    grad (B2's q, k, v as ``[B, H, S, d]`` views of ``[B, S, H, d]``, as
    the model hands them over), the Function's call through ``ops``, the
    plain version, and the call's keywords."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rn

    if lib == "flash_attention":
        b, h, hkv, s, d, causal = shape
        ins = _attn_inputs(b, h, hkv, s, d, dtype, seed)
        kw = {"causal": causal}
        fn, plain = ops.attention, fa.attention_plain
    elif lib == "fused_ffn":
        ins = _ffn_inputs(*shape, dtype, seed)
        kw, fn, plain = {}, ops.swiglu, ff.swiglu_plain
    else:
        ins = _rms_inputs(*shape, dtype, seed)
        kw, fn, plain = {}, ops.rmsnorm, rn.rmsnorm_plain
    return [t.detach().requires_grad_() for t in ins], fn, plain, kw


# the gradients of each Function that sum over the rows of its input (a
# weight's or a scale's): by their index among the Function's inputs
ROW_SUMS = {"fused_ffn": (1, 2, 3), "rmsnorm": (1,), "flash_attention": ()}


def _backward_vs_plain(errs: dict, failed: list) -> None:
    """Each kernel's autograd Function on the card: its output is the
    kernel's (a ``grad_fn`` of the Function) and its backward formulas'
    gradients against autograd through the plain version on the same
    inputs and output gradient, within :data:`LM_TOL`, at
    :data:`BACKWARD_CASES`: elementwise (rtol = atol = TOL), or, for a
    gradient that sums over the M rows of the input (:data:`ROW_SUMS`),
    normwise (the error's L2 norm over the gradient's): two
    implementations of a 2,048-row sum over bf16-rounded terms round
    apart at a few elements of small magnitude (as the plain version's
    own gradient does against a float64 truth).  Errors go to ``errs``
    under ``(lib, "backward_<dtype>")``."""
    import torch

    for i, (lib, shape, tname) in enumerate(BACKWARD_CASES):
        dtype = getattr(torch, tname)
        ins, fn, plain, kw = _backward_inputs(lib, shape, dtype, 300 + 5 * i)
        out = fn(*ins, **kw)
        through = type(out.grad_fn).__name__
        dout = _randn(out.shape, dtype, 400 + i)
        got = torch.autograd.grad(out, ins, dout)
        want = torch.autograd.grad(plain(*ins, **kw), ins, dout)
        torch.cuda.synchronize()
        tol = LM_TOL[tname]
        grads, ok = [], "Backward" in through
        for j, (g, w) in enumerate(zip(got, want)):
            g, w = g.float(), w.float()
            outside = int((~torch.isclose(g, w, rtol=tol, atol=tol)).sum())
            norm_err = float((g - w).norm() / w.norm().clamp_min(1e-30))
            row_sum = j in ROW_SUMS[lib]
            ok = ok and bool(torch.isfinite(g).all()) and (
                outside == 0 or (row_sum and norm_err <= tol))
            grads.append({"input": j, "max_abs_err": float(
                (g - w).abs().max()), "max_abs": float(w.abs().max()),
                "outside_elementwise_tol": outside, "elements": g.numel(),
                "norm_rel_err": norm_err, "sums_rows": row_sum})
        err = max(r["max_abs_err"] for r in grads)
        key = (lib, f"backward_{tname}")
        errs[key] = max(errs.get(key, 0.0), err)
        emit({"phase": "lm_kernels_vs_plain", "kernel": lib,
              "backward": True, "shape": list(shape), "dtype": tname,
              "grad_fn": through, "tol": tol, "max_abs_err": err,
              "grads": grads, "ok": ok})
        if not ok:
            failed.append((lib, "backward", shape, tname))
        del ins, out, got, want


def phase_lm_kernels_vs_plain() -> dict:
    """Each LM kernel against its plain torch version on the same card
    tensors: at the serving path's shapes (tinyllama's, jamba's,
    deepseek's and xlstm's; B3 at jamba's and deepseek's widths in bf16
    only; B2 under MLA's contract, :data:`MLA_ATTN_CASES`: unpadded at
    (192, 128) in both dtypes, ragged lengths included, padded at the smoke
    widths in fp32 and to 256 columns once in bf16; B2 at gemma3-4b's d-256
    prefill, windowed and not; B3's fp32 route across its switch and at
    ragged widths, :data:`FFN_F32_CASES`; each fp32 call of B2 and B3
    repeated and held to repeat bit for bit; MLA's latent decode at the
    deepseek cells' decode steps, :data:`MLA_DECODE_CASES`, one split and
    33, each repeated bit for bit) and at ragged ones, in bf16
    (tolerance 2e-2; the latent decode :data:`MLA_DECODE_TOL`) and fp32
    (2e-5, TF32 off), the tolerances of ``tests/test_kernels.py``.  Returns the largest absolute error of each
    kernel, by dtype.  Then each kernel's autograd Function: its backward
    against autograd through the plain version (:func:`_backward_vs_plain`;
    errors under ``(lib, "backward_<dtype>")``)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "lm_kernels_vs_plain", "allow_tf32": {
        "matmul": torch.backends.cuda.matmul.allow_tf32,
        "cudnn": torch.backends.cudnn.allow_tf32}})
    errs: dict = {}
    failed = []
    sweep: dict = {}  # (dtype, d, causal) -> [cases, max error]
    from repro_torch.kernels import fused_ffn as ff

    for name, case, dtype, kernel, plain in _lm_calls():
        got = kernel()
        want = plain()
        repeat = kernel() if case.pop("repeat", False) else None
        torch.cuda.synchronize()
        tname = str(dtype).removeprefix("torch.")
        tol = LM_TOL[tname]
        finite = bool(torch.isfinite(got).all())
        err = float((got.float() - want.float()).abs().max())
        # a case may carry its own (MLA_DECODE_TOL)
        ok = finite and got.shape == want.shape and torch.allclose(
            got.float(), want.float(), rtol=case.get("rtol", tol),
            atol=case.get("atol", tol))
        if repeat is not None:
            # two calls of B2's and B3's fp32 routes: equal bit for bit,
            # B3's split K or not (the workspace bytes say whether a
            # product was split)
            case["repeats_bitwise"] = torch.equal(got, repeat)
            if name == "fused_ffn":
                case["workspace_bytes"] = ff._WORKSPACE.get(
                    (got.get_device(), case["m"], case["d"], case["f"], 0))
            ok = ok and case["repeats_bitwise"]
        key = (name, tname)
        errs[key] = max(errs.get(key, 0.0), err)
        if case.pop("sweep", False) and ok:
            agg = sweep.setdefault((tname, case["d"], case["causal"]),
                                   [0, 0.0])
            agg[0] += 1
            agg[1] = max(agg[1], err)
        else:
            emit({"phase": "lm_kernels_vs_plain", "kernel": name, **case,
                  "dtype": tname, "tol": tol, "max_abs_err": err,
                  "finite": finite, "ok": ok})
        if not ok:
            failed.append((name, case, tname))
    for (tname, d, causal), (n, err) in sorted(sweep.items()):
        emit({"phase": "lm_kernels_vs_plain", "kernel": "flash_attention",
              "sweep": {"s": ATTN_SWEEP_S, "window": [0, 40] if causal
                        else [0], "hkv": [1, 2, 16] if causal else [1, 16],
                        "h": 16}, "d": d, "causal": causal, "dtype": tname,
              "cases_ok": n, "max_abs_err": err})
    _backward_vs_plain(errs, failed)
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
    for name, _, dur in _trace_events(prof)[0]:
        if any(n in name for n in names):
            c = per_name.setdefault(name, [0, 0.0])
            c[0] += 1
            c[1] += dur
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


def _sdpa_backends(call) -> dict:
    """Which backends of ``F.scaled_dot_product_attention`` take ``call()``
    (one call of it), and which of them the default call took: those whose
    output equals the default call's bit for bit."""
    import warnings

    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

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


# the MLA_ATTN_CASES that lm_timing times: deepseek's prefill, the smoke
# prefill
MLA_TIMING_CASES = MLA_ATTN_CASES[:2]


def _mla_timing_rows() -> dict:
    """B2, B3 and B4 at deepseek-v2-236b's and xlstm-350m's shapes
    (``serve_mla``, ``serve_xlstm``).  B2 under MLA's contract
    (:data:`MLA_TIMING_CASES`): the kernel as ``mla_apply`` calls it
    (deepseek's prefill unpadded at (192, 128), the smoke widths padded to
    32), and at deepseek's prefill also on q/k/v zero-padded to 256
    columns (``route`` ``padded``: the route MLA took before, timed in the
    same run); its library call ``F.scaled_dot_product_attention`` on the
    unpadded ones (with the backends that take them,
    :func:`_sdpa_backends`), the bound from the unpadded work (q/k 192 and
    v 128 wide; the padded work's bound beside it).  B3 at an expert's and
    the dense layer's widths (:data:`DEEPSEEK_FFN_CASES`), with the
    composite; B4 at the new norm widths over an 8 x 512 prefill, with
    ``F.rms_norm``; MLA's latent decode at the deepseek cells' decode
    steps (:data:`MLA_DECODE_CASES`), its bound from the live slots."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import mla_decode as md
    from repro_torch.kernels import rmsnorm as rn

    bf16, rows = torch.bfloat16, {}
    rows["flash_attention"] = []
    for b, h, s_len, dqk, dv, tname in MLA_TIMING_CASES:
        dtype = getattr(torch, tname)
        first, scale = _mla_attn_inputs(b, h, s_len, dqk, dv, dtype, 111)
        width = first[0].shape[-1]
        pairs = b * h * s_len * (s_len + 1) // 2  # causal
        nbytes = b * h * s_len * 2 * (dqk + dv) * dtype.itemsize
        padded_bytes = b * h * s_len * 4 * width * dtype.itemsize
        unpadded = (dqk, dv) in fa.WIDTH_PAIRS

        def sdpa(qp, kp, vp, q, k, v, scale=scale):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  scale=scale)

        for padded in ((False, True) if unpadded else (True,)):
            i0 = 3 * (not padded)  # the unpadded q, k, v follow the padded
            rows["flash_attention"].append(_timing_row(
                "flash_attention",
                {"b": b, "h": h, "hkv": h, "s": s_len,
                 "d": width if padded else dqk,
                 "causal": True, "mla": {"qk": dqk, "v": dv},
                 "route": "padded" if padded else "unpadded"},
                lambda i, b=b, h=h, s_len=s_len, dqk=dqk, dv=dv,
                dtype=dtype: _mla_attn_inputs(b, h, s_len, dqk, dv, dtype,
                                              111 + 6 * i)[0],
                lambda *a, scale=scale, i0=i0: fa.flash_attention(
                    *a[i0:i0 + 3], scale=scale),
                lambda *a, scale=scale, i0=i0: fa.attention_plain(
                    *a[i0:i0 + 3], scale=scale),
                sdpa, nbytes=nbytes, ops=2 * (dqk + dv) * pairs,
                reps=20 if b > 1 else 200, dtype=tname,
                extra={**_sdpa_backends(
                    lambda: sdpa(None, None, None, *first[3:])),
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
    # MLA's latent decode at the deepseek cells' decode steps
    # (MLA_DECODE_CASES); no one library call takes the split key in place
    rows["mla_decode"] = []
    for b, t in MLA_DECODE_CASES:
        first, scale = _mla_decode_inputs(b, t, 181)
        nbytes, ops = _mla_decode_bytes_ops(first)
        rows["mla_decode"].append(_timing_row(
            "mla_decode", {"b": b, "h": 128, "t": t},
            lambda i, b=b, t=t: _mla_decode_inputs(b, t, 181 + 5 * i)[0],
            lambda *a, sc=scale: md.mla_decode(*a, sc),
            lambda *a, sc=scale: md.mla_decode_plain(*a, sc), None,
            nbytes=nbytes, ops=ops, reps=100,
            extra={"splits": md.splits_for(
                b, 128, t, torch.cuda.get_device_properties(
                    0).multi_processor_count)}))
    return rows


def phase_lm_timing() -> dict:
    """B2, B3 and B4 at the serving path's shapes in bf16: prefill of 8 x 512
    and 4 x 200 tokens and decode at batch 8 and 4, at tinyllama-1.1b's
    width; B3 also in fp32 (the route ``launch.serve`` takes at its default
    fp32 cache), beside its composite in fp32.  The library calls
    (``F.scaled_dot_product_attention`` with GQA, ``F.rms_norm``) and B3's
    composite (three ``torch.matmul``s and ``F.silu(g) * u``) are timed
    here only; the port never calls them.  Then the same at
    jamba-v0.1-52b's shapes (d 4096, d_ff 14,336, Hkv 8, d 128), at
    deepseek-v2-236b's and xlstm-350m's (:func:`_mla_timing_rows`), B2 at
    whisper-base's encoder shape (non-causal, S 1,500), its fp32 route at
    the ~100M trainer's and tinyllama's 8 x 512 shapes, its d-256 route at
    gemma3-4b's prefill beside the mma.sync route it replaced
    (:func:`_gemma_timing_rows`) and the backward formulas at the train
    step's shapes (:func:`_backward_timing_rows`).
    Returns the 8 x 512 prefill row of each kernel, with B3's and B4's
    decode rows, each kernel's jamba rows (``<lib>_jamba``), deepseek /
    xlstm rows (``<lib>_mla_xlstm``), the fp32 rows of B3 (tinyllama's
    prefill and decode, the ~100M trainer's microbatch) and of B2
    (tinyllama's 8 x 512, the trainer's) (``<lib>_fp32``), B2's whisper
    and gemma rows (``flash_attention_whisper``,
    ``flash_attention_gemma``) and the backward rows (``backward``, by
    kernel)."""
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

    # bf16 at tinyllama's width; fp32 there (prefill, decode) and at the
    # ~100M trainer's microbatch (examples), beside the fp32 composite
    for dtype in (bf16, torch.float32):
        tname = str(dtype).removeprefix("torch.")
        shapes = ([(m, d, f) for m in (4096, 800, 8, 4)] if dtype == bf16
                  else [(4096, d, f), (8, d, f), (512, 768, 2048)])
        for m, dd, ff_ in shapes:
            row = _timing_row(
                "fused_ffn", {"m": m, "d": dd, "f": ff_},
                lambda i, m=m, dd=dd, ff_=ff_, dtype=dtype: _ffn_inputs(
                    m, dd, ff_, dtype, 2 + 4 * i),
                ff.fused_swiglu, ff.swiglu_plain, None,
                nbytes=(2 * m * dd + 3 * dd * ff_) * dtype.itemsize,
                ops=6 * m * dd * ff_, reps=(20 if m > 8 else 200)
                if dtype == bf16 else (10 if m > 512 else 50),
                dtype=tname, composite=composite)
            if dtype == bf16:
                rows.setdefault("fused_ffn", row)
                if m == 8:
                    rows["fused_ffn_decode"] = row
            else:
                rows.setdefault("fused_ffn_fp32", []).append(row)
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
    # MLA's latent decode has no tinyllama shape: its first row, decode_long's
    # step, heads its kernels-line entry
    rows["mla_decode"] = rows["mla_decode_mla_xlstm"][0]

    # whisper-base's encoder attention (serve_whisper): B 8, H = Hkv 8,
    # S 1,500, d 64, non-causal
    b, h, s_len, hd = WHISPER_BATCH, 8, 1500, 64
    rows["flash_attention_whisper"] = [_timing_row(
        "flash_attention",
        {"b": b, "h": h, "hkv": h, "s": s_len, "d": hd, "causal": False},
        lambda i: _attn_inputs(b, h, h, s_len, hd, bf16, 71 + 3 * i),
        lambda q, k, v: fa.flash_attention(q, k, v, causal=False),
        lambda q, k, v: fa.attention_plain(q, k, v, causal=False),
        lambda q, k, v: F.scaled_dot_product_attention(q, k, v),
        nbytes=4 * b * h * s_len * hd * 2, ops=4 * hd * b * h * s_len ** 2,
        reps=50)]
    # B2's fp32 route at the ~100M trainer's microbatch (examples): B 2, H
    # 12, Hkv 4, S 256, d 64, causal, beside SDPA in fp32 (GQA)
    b, h, hkv, s_len, hd = 2, 12, 4, 256, 64
    rows["flash_attention_fp32"] = [_timing_row(
        "flash_attention",
        {"b": b, "h": h, "hkv": hkv, "s": s_len, "d": hd, "causal": True},
        lambda i: _attn_inputs(b, h, hkv, s_len, hd, torch.float32,
                               75 + 3 * i),
        fa.flash_attention, fa.attention_plain,
        lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True),
        nbytes=(2 * b * h + 2 * b * hkv) * s_len * hd * 4,
        ops=4 * hd * b * h * s_len * (s_len + 1) // 2, reps=100,
        dtype="float32")]
    # and at tinyllama-1.1b's 8 x 512 prefill under the reference's fp32
    # cache (serve_fp32_cache): B 8, H 32, Hkv 4, d 64
    b, h, hkv, s_len, hd = 8, 32, 4, 512, 64
    rows["flash_attention_fp32"].insert(0, _timing_row(
        "flash_attention",
        {"b": b, "h": h, "hkv": hkv, "s": s_len, "d": hd, "causal": True},
        lambda i: _attn_inputs(b, h, hkv, s_len, hd, torch.float32,
                               77 + 3 * i),
        fa.flash_attention, fa.attention_plain,
        lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True),
        nbytes=(2 * b * h + 2 * b * hkv) * s_len * hd * 4,
        ops=4 * hd * b * h * s_len * (s_len + 1) // 2, reps=30,
        dtype="float32"))
    rows["flash_attention_gemma"] = _gemma_timing_rows()
    rows["backward"] = _backward_timing_rows()
    return rows


def _launched(fn, part: str) -> list:
    """The names of the device kernels holding ``part`` that ``fn()``
    launched, from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({name for name, _, _ in _trace_events(prof)[0]
                   if part in name})


# gemma3-4b's prefill as serve_gemma's 4 x 2,048 run hands it to B2: B 4,
# H 8, Hkv 4, S 2,048, d 256, causal, bf16; the mma.sync route's rows are
# 260 elements apart (520 bytes, not whole 16-byte units: TMA cannot read
# them), the TMA + wgmma route's 256 (the model's layout)
GEMMA_PREFILL = (4, 8, 4, 2048, 256)
GEMMA_ROUTES = (("tma_wgmma", 256, "flash_attn_wgmma_kernel"),
                ("mma_sync", 260, "flash_attn_bf16_kernel"))


def _gemma_attn_inputs(i: int, width: int) -> tuple:
    """The ``i``-th set of q, k, v at :data:`GEMMA_PREFILL`, ``[B, H, S,
    256]`` views of ``[B, S, H, width]`` rows."""
    import torch

    b, h, hkv, s_len, hd = GEMMA_PREFILL
    return tuple(_randn((b, s_len, n, width), torch.bfloat16,
                        81 + 3 * i + j)[..., :hd].transpose(1, 2)
                 for j, n in enumerate((h, hkv, hkv)))


def _gemma_route_kernels() -> None:
    """Print, as one JSON object, the device kernels B2 launched at
    :data:`GEMMA_PREFILL` for each of :data:`GEMMA_ROUTES`, without and
    with gemma's window (run in a process of its own by
    :func:`_gemma_timing_rows`)."""
    from repro_torch.kernels import flash_attention as fa

    out = {}
    for route, width, _ in GEMMA_ROUTES:
        ins = _gemma_attn_inputs(0, width)
        out[route] = sorted({n for window in (0, GEMMA_WINDOW)
                             for n in _launched(lambda w=window: fa.
                                                flash_attention(*ins,
                                                                window=w),
                                                "flash_attn")})
    print(json.dumps(out))


def _gemma_timing_rows() -> list:
    """B2 at gemma3-4b's prefill (:data:`GEMMA_PREFILL`), its global
    layers' (no window) and its local layers' (a 1,024-key window), bf16:
    the TMA + wgmma route as the model calls it, and the mma.sync route it
    replaced on rows TMA cannot read (element loads), each row failing
    unless its route's kernel launched (traced in a process of its own:
    the full script's profiler drops device events, ROADMAP §B.10); the
    model's rows beside ``F.scaled_dot_product_attention`` (GQA): causal
    on its flash backend, and with the window as a boolean band mask (key
    <= query, key > query - 1,024) on the backend torch picks; and the
    bound from the live pairs."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import flash_attention as fa

    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(SRC), str(ROOT), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke._gemma_route_kernels()"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"gemma's route check exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    launched = json.loads(proc.stdout.strip().splitlines()[-1])
    for route, _, kernel in GEMMA_ROUTES:
        names = launched[route]
        if not names or any(kernel not in n for n in names):
            raise AssertionError(f"gemma's {route} rows launched {names}, "
                                 f"not {kernel}")

    b, h, hkv, s_len, hd = GEMMA_PREFILL

    def sdpa(q, k, v):
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)

    pos = torch.arange(s_len, device="cuda")
    back = pos[:, None] - pos[None, :]
    band = (back >= 0) & (back < GEMMA_WINDOW)

    def sdpa_band(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=band,
                                              enable_gqa=True)

    rows = []
    for window in (0, GEMMA_WINDOW):
        pairs = b * h * fa.live_pairs(s_len, True, window)
        if window:
            first = _gemma_attn_inputs(0, hd)
            want = fa.attention_plain(*first, window=window)
            err = float((sdpa_band(*first).float() - want.float()).abs()
                        .max())
            if not err <= LM_TOL["bfloat16"]:
                raise AssertionError(f"SDPA with the band mask is {err} "
                                     f"off the windowed plain version")
            library = {"sdpa_mask": "band", "sdpa_max_abs_err": err,
                       **_sdpa_backends(lambda: sdpa_band(*first))}
            del first, want
        else:  # pinned by sdpa_kernel, which raises if it cannot run
            library = {"sdpa_mask": "is_causal",
                       "sdpa_backends": ["FLASH_ATTENTION"]}
        for route, width, _ in GEMMA_ROUTES:
            rows.append(_timing_row(
                "flash_attention",
                {"b": b, "h": h, "hkv": hkv, "s": s_len, "d": hd,
                 "causal": True, "window": window, "route": route,
                 "row_elements": width},
                lambda i, width=width: _gemma_attn_inputs(i, width),
                lambda q, k, v, w=window: fa.flash_attention(
                    q, k, v, window=w),
                lambda q, k, v, w=window: fa.attention_plain(
                    q, k, v, window=w),
                # SDPA on the model's rows only: its flash kernel faults
                # (misaligned address) on rows 520 bytes apart
                None if width != hd else sdpa_band if window else sdpa,
                nbytes=(2 * b * h + 2 * b * hkv) * s_len * hd * 2,
                ops=4 * hd * pairs, reps=20,
                extra={"kernels": launched[route],
                       **(library if width == hd else {})}))
    return rows


def _backward_row(lib, shape, make, fn, plain, library, composite, nbytes,
                  ops, reps) -> dict:
    """Times of one backward at one shape, between CUDA events: the
    autograd Function's formulas (``ms``), autograd through the plain
    version (``plain_ms``), through the library call (``library_ms``) and
    through a composite of library calls (``composite_ms``), each over a
    graph built once (``retain_graph``) with the same output gradient; the
    device time of the formulas and of the library call's backward from
    the profiler; the bound from the bytes the backward must move and its
    operations at the bf16 rate."""
    import torch

    ins = [t.detach().requires_grad_() for t in make()]
    dout = None

    def timer(call):
        nonlocal dout
        if call is None:
            return None
        out = call(*ins)
        if dout is None:
            dout = _randn(out.shape, out.dtype, 77)

        def back():
            return torch.autograd.grad(out, ins, dout, retain_graph=True)

        return back

    kernel = timer(fn)
    rest = {name: timer(call) for name, call in (
        ("plain", plain), ("library", library), ("composite", composite))}
    bound_ms, bound_by = _bound(nbytes, ops, "bfloat16")
    row = {"phase": "lm_timing", "kernel": lib, "backward": True,
           "shape": list(shape), "dtype": "bfloat16",
           "ms": _events_ms(kernel, reps),
           "device_ms": _profiled_ms(kernel, reps),
           **{f"{name}_ms": _events_ms(back, max(reps // 2, 3)) if back
              else None for name, back in rest.items()},
           "library_device_ms": _profiled_ms(rest["library"], reps)
           if rest["library"] else None,
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "ops": ops}
    emit(row)
    return row


def _backward_timing_rows() -> dict:
    """The backward formulas at the train step's shapes (tinyllama-1.1b, a
    microbatch of 4 x 512, bf16), each beside torch autograd through the
    plain version and through the library call or composite that computes
    the same function: B2 (GQA 32 / 4 heads, causal; library
    ``F.scaled_dot_product_attention``), B3 (d 2048, f 5632; composite:
    three bf16 ``torch.matmul``s and ``F.silu(g) * u``), B4 (d 2048;
    library ``F.rms_norm``).  Operations counted as the formulas do them:
    B2's five products over the live (causal) pairs, B3's eight (g and u
    recomputed)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rn

    bf16, rows = torch.bfloat16, {}
    b, h, hkv, s_len, hd = 4, 32, 4, 512, 64
    pairs = b * h * s_len * (s_len + 1) // 2
    rows["flash_attention"] = _backward_row(
        "flash_attention", (b, h, hkv, s_len, hd, True),
        lambda: _attn_inputs(b, h, hkv, s_len, hd, bf16, 81),
        lambda q, k, v: ops.attention(q, k, v, causal=True),
        lambda q, k, v: fa.attention_plain(q, k, v, causal=True),
        lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), None,
        nbytes=(4 * b * h + 4 * b * hkv) * s_len * hd * 2,
        ops=10 * hd * pairs, reps=10)
    m, d, f = 2048, 2048, 5632

    def composite(x, wg, wi, wo):
        return (F.silu(x @ wg) * (x @ wi)) @ wo

    rows["fused_ffn"] = _backward_row(
        "fused_ffn", (m, d, f), lambda: _ffn_inputs(m, d, f, bf16, 85),
        ops.swiglu, ff.swiglu_plain, None, composite,
        nbytes=(3 * m * d + m * f + 6 * d * f) * 2, ops=16 * m * d * f,
        reps=10)
    rows["rmsnorm"] = _backward_row(
        "rmsnorm", (m, d), lambda: _rms_inputs(m, d, bf16, 89),
        ops.rmsnorm, rn.rmsnorm_plain,
        lambda x, sc: F.rms_norm(x, (d,), sc, 1e-5), None,
        nbytes=(3 * m * d + 2 * d) * 2, ops=0, reps=50)
    return rows


PHASES = ("kernel_vs_plain", "golden", "full_run", "planner_trace",
          "plan_server", "zoo", "timing", "lm_kernels_vs_plain", "serve", "serve_vs_cpu", "serve_hybrid",
          "hybrid_vs_cpu", "serve_mla", "serve_xlstm", "mla_xlstm_vs_cpu",
          "serve_whisper", "whisper_vs_cpu", "serve_fp32_cache",
          "serve_gemma", "gemma_vs_cpu", "train", "train_vs_cpu",
          "plan_h100", "examples", "sharded", "dryrun", "lm_timing")
# the phases whose LM launches the kernels line sums: those that run a
# model at full width (whole or a full-width slice), and the examples,
# which serve smoke configs and train the ~100M config
MAIN_PATHS = ("serve", "serve_hybrid", "serve_mla", "serve_xlstm",
              "serve_whisper", "serve_fp32_cache", "serve_gemma", "train",
              "examples", "sharded", "dryrun")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=None, metavar="PHASE,...",
                    help=f"run only these phases after the build, and print "
                         f"no kernels or ok line (phases: {', '.join(PHASES)})")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None
    if only and not only <= set(PHASES):
        ap.error(f"unknown phase(s): {sorted(only - set(PHASES))}")
    if only and "planner_trace" in only and "full_run" not in only:
        ap.error("planner_trace traces full_run's result: add full_run")
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

    # each phase's start, for the seconds it took (the script's time limit)
    t_start, started = time.perf_counter(), {}

    def run(name):
        if only is None or name in only:
            started[name] = time.perf_counter()
            return True
        return False

    device = phase_device()
    phase_build()
    max_err = phase_kernel_vs_plain() if run("kernel_vs_plain") else None
    b1_launches = {}
    if run("golden"):
        b1_launches["golden"] = phase_golden()
    full = phase_full_run() if run("full_run") else None
    if full:
        b1_launches["full_run"] = full["kernel_launches"]
    if run("planner_trace"):
        b1_launches["planner_trace"] = \
            phase_planner_trace(full)["kernel_launches"]
    if run("plan_server"):
        b1_launches["plan_server"] = phase_plan_server()["kernel_launches"]
    if run("zoo"):
        b1_launches["zoo"] = phase_zoo()["kernel_launches"]
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
    if run("serve_whisper"):
        served["serve_whisper"] = phase_serve_whisper(device)
    if run("whisper_vs_cpu"):
        phase_whisper_vs_cpu()
    if run("serve_fp32_cache"):
        served["serve_fp32_cache"] = phase_serve_fp32_cache(device)
    if run("serve_gemma"):
        served["serve_gemma"] = phase_serve_gemma(device)
    if run("gemma_vs_cpu"):
        phase_gemma_vs_cpu()
    if run("train"):
        served["train"] = phase_train(device)
    if run("train_vs_cpu"):
        phase_train_vs_cpu()
    if run("plan_h100"):
        b1_launches["plan_h100"] = phase_plan_h100()["kernel_launches"]
    if run("examples"):
        served["examples"] = phase_examples(device)
        b1_launches["examples"] = served["examples"]["launches"][
            "finish_batch"]
    if run("sharded"):
        served["sharded"] = phase_sharded(device)
    if run("dryrun"):
        served["dryrun"] = phase_dryrun(device)
    lm_rows = phase_lm_timing() if run("lm_timing") else None
    ends = [*list(started.values())[1:], time.perf_counter()]
    emit({"phase": "timings", "total_s": ends[-1] - t_start,
          "build_s": next(iter(started.values()), ends[-1]) - t_start,
          "seconds": {name: end - t for (name, t), end in zip(
              started.items(), ends)}})
    if only is not None:
        print(f"ran only {sorted(only)}: no kernels or ok line", flush=True)
        return 0

    kernels = [{
        "name": "finish_batch",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": sum(b1_launches.values()),
        "launches_by_path": b1_launches,
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
                            for p in MAIN_PATHS),
            "launches_by_path": {p: served[p]["launches"][lib]
                                 for p in MAIN_PATHS},
            "max_abs_err": lm_errs[(lib, "bfloat16")],
            # MLA's latent decode: bf16 only, no backward
            "max_abs_err_fp32": lm_errs.get((lib, "float32")),
            "backward_max_abs_err": {
                t: lm_errs.get((lib, f"backward_{t}"))
                for t in ("bfloat16", "float32")},
            "shape": {k: v for k, v in row.items()
                      if k in ("m", "d", "f", "b", "h", "hkv", "s", "t")},
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
        if f"{lib}_jamba" in lm_rows:
            kernels[-1]["jamba"] = [{k: r[k] for k in (
                "m", "d", "f", "b", "h", "hkv", "s", "ms", "device_ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library_device_ms", "composite_ms", "l2_cold") if k in r}
                for r in lm_rows[f"{lib}_jamba"]]
        kernels[-1]["mla_xlstm"] = [{k: r[k] for k in (
            "m", "d", "f", "b", "h", "hkv", "s", "t", "splits", "mla",
            "route", "dtype", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "padded_bound_ms", "library_ms", "library_device_ms",
            "sdpa_backends", "sdpa_default_equals", "composite_ms",
            "l2_cold") if k in r}
            for r in lm_rows[f"{lib}_mla_xlstm"]]
        if lib in lm_rows["backward"]:
            bwd = lm_rows["backward"][lib]
            kernels[-1]["backward"] = {k: bwd[k] for k in (
                "shape", "ms", "device_ms", "plain_ms", "library_ms",
                "composite_ms", "bound_ms", "bound_by")}
        for extra in ("whisper", "fp32", "gemma"):
            if f"{lib}_{extra}" in lm_rows:
                kernels[-1][extra] = [{k: r[k] for k in (
                    "m", "d", "f", "b", "h", "hkv", "s", "causal", "window",
                    "route", "ms", "device_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "library_device_ms",
                    "sdpa_backend", "composite_ms", "l2_cold") if k in r}
                    for r in lm_rows[f"{lib}_{extra}"]]
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
