#!/usr/bin/env python3
"""Host cost of launching the port's B4 (RMSNorm), B3 (fused SwiGLU), B2
(flash attention) and B1 (finish_batch) kernels on one GPU, for the
``repro_torch`` package found under ``--src``.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit::

    python3 scripts/launch_cost.py [--src DIR] [--reps N] [--only WHAT,...]

``--src`` (default: this checkout's ``src``) may name the ``src`` directory
of another checkout, so that two versions of the wrappers are timed by the
same code; alternate them in one process list on one card (old, new, new,
old) to compare.  It prints one JSON line per measurement:

Each figure is the median of 7 blocks of calls, the functions compared
timed in turns block by block (the host's clock varies from block to
block).

* ``rmsnorm``: one B4 call at M 8, d 2048 in bf16 (the decode shape):
  CUDA events over back-to-back calls, the host's time per call (enqueue
  only), the same for ``F.rms_norm`` on the same tensors, the time of the
  C entry point called through ``ctypes`` with the same arguments and
  ``m = 0`` (it returns at once: the least a ``ctypes`` call of that
  argument list costs), the host time of the same call through
  ``ops.rmsnorm`` (the models' route) and, where the tree registers it,
  through the kernel's torch op (``op_host_us``: the dispatcher's cost is
  its difference from ``host_us``), and the ``cProfile`` breakdowns of a
  call of the wrapper and of ``ops.rmsnorm``;
* ``fused_ffn``: one B3 call at M 8, d 2048, f 5632 in bf16 (tinyllama's
  decode shape): events and host time a call beside the composite of
  three ``torch.matmul``s and ``F.silu(g) * u``.  Its ~47 us on the card
  exceed the wrapper's host time, so the launch queue fills and the host
  time there is the card's; the wrapper's own cost is taken at M 8, d 256,
  f 704 (``narrow_*``: a few us on the card, the same route and wrapper
  code): host time a call, the ``ctypes`` entry with ``m = 0``, and the
  ``cProfile`` breakdown;
* ``flash_attention``: one B2 call at B 1, H 4, Hkv 2, S 64, d 64, causal,
  bf16 (a few us on the card, so the host time is the wrapper's): events
  and host time a call beside ``F.scaled_dot_product_attention`` on the
  same tensors, and the ``cProfile`` breakdown;
* ``finish_batch``: a planner batch of 185 lanes (the paper-scale run's
  mean): the round trip of ``finish_cost_batch`` from NumPy to NumPy on the
  host clock, ``finish_lanes`` on card tensors between CUDA events, and the
  ``cProfile`` breakdown of a round trip;
* ``finish_batch_sizes``: from 185 to 2**20 lanes, the round trip of
  ``finish_cost_batch`` against the same batch by copies (the lanes staged
  in pinned memory, one copy to the card, ``finish_lanes`` on the card
  tensor, one copy back into pinned memory, one sync), the way a batch
  crossed before it went by zero copy.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# the host's clock varies from block to block of calls (the machine shares
# its CPU cores), so every figure is the median of BLOCKS blocks, and the
# functions compared are timed in turns, block by block
BLOCKS = 7


def events_ms(fn, reps: int) -> float:
    """Milliseconds a call of ``fn`` between CUDA events around ``reps``
    back-to-back calls."""
    import torch

    for _ in range(10):
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


def host_us(fn, reps: int, sync: bool = True) -> float:
    """Host microseconds a call of ``fn`` over ``reps`` calls, the card
    drained before and (with ``sync``) after the loop."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    if sync:
        torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / reps


def in_turns(timers: dict, reps: int) -> dict:
    """``{name: (timer, fn)}`` -> ``{name: median over BLOCKS blocks}``,
    each block timing every entry once, in turns."""
    runs = {name: [] for name in timers}
    for _ in range(BLOCKS):
        for name, (timer, fn) in timers.items():
            runs[name].append(timer(fn, reps // BLOCKS))
    return {name: statistics.median(v) for name, v in runs.items()}


def profile_us(fn, reps: int, top: int = 14) -> list:
    """``cProfile`` of ``reps`` calls: the functions with the most own time,
    as (function, calls a call, own microseconds a call, cumulative
    microseconds a call).  cProfile adds its own cost to every Python call,
    so these overstate; they rank."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(reps):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    stats = pstats.Stats(prof).stats
    rows = []
    for (path, line, name), (_, ncalls, tt, ct, _) in stats.items():
        where = f"{Path(path).name}:{line}({name})" if line else name
        rows.append((where, ncalls / reps, tt * 1e6 / reps, ct * 1e6 / reps))
    rows.sort(key=lambda r: -r[2])
    return [[w, round(c, 3), round(t, 3), round(ct, 3)]
            for w, c, t, ct in rows[:top]]


def run_rmsnorm(reps: int) -> None:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import rmsnorm as rn

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((8, 2048), generator=g, device="cuda").bfloat16()
    s = torch.randn((2048,), generator=g, device="cuda").bfloat16()
    if not torch.allclose(rn.fused_rmsnorm(x, s).float(),
                          rn.rmsnorm_plain(x, s).float(), rtol=2e-2,
                          atol=2e-2):
        raise AssertionError("B4 disagrees with its plain version")
    entry = _build.load("rmsnorm").rmsnorm_launch
    stream = torch.cuda.current_stream().cuda_stream
    # m = 0: the entry returns before any CUDA call; the rest of the
    # argument list as a real call passes it (this tree's signature)
    noop = [x.data_ptr(), s.data_ptr(), x.data_ptr(), 0, 2048, 1e-5, 1, 1]
    noop += [1] * (len(entry.argtypes) - len(noop) - 1) + [stream]

    def call_noop():
        return entry(*noop)

    def kernel():
        return rn.fused_rmsnorm(x, s)

    def library():
        return F.rms_norm(x, (2048,), s, 1e-5)

    def wrapper():
        return ops.rmsnorm(x, s)

    timers = {
        "events_ms": (events_ms, kernel),
        "library_events_ms": (events_ms, library),
        "host_us": (host_us, kernel),
        "library_host_us": (host_us, library),
        "ops_host_us": (host_us, wrapper),
        "noop_ctypes_us": (lambda f, r: host_us(f, r, sync=False),
                           call_noop)}
    op = getattr(rn, "fused_rmsnorm_op", None)
    if op is not None:  # the kernel as a torch op (repro_torch::...)
        timers["op_host_us"] = (host_us, lambda: op(x, s, 1e-5))
    emit({"what": "rmsnorm", "m": 8, "d": 2048, "dtype": "bfloat16",
          "blocks": BLOCKS, **in_turns(timers, reps),
          "noop_argc": len(entry.argtypes),
          "profile_us": profile_us(kernel, reps),
          "ops_profile_us": profile_us(wrapper, reps)})


def run_ffn(reps: int) -> None:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_ffn as ff

    m, d, f = 8, 2048, 5632
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).bfloat16()

    def inputs(d, f):
        args = (rnd(m, d), rnd(d, f, scale=d ** -0.5),
                rnd(d, f, scale=d ** -0.5), rnd(f, d, scale=f ** -0.5))
        if not torch.allclose(ff.fused_swiglu(*args).float(),
                              ff.swiglu_plain(*args).float(), rtol=2e-2,
                              atol=2e-2):
            raise AssertionError("B3 disagrees with its plain version")
        return args

    x, wg, wi, wo = inputs(d, f)
    narrow = inputs(256, 704)
    entry = _build.load("fused_ffn").fused_ffn_launch
    h = torch.empty((m, 704), dtype=x.dtype, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    # m = 0: the entry returns before any CUDA call
    noop = [*(t.data_ptr() for t in narrow), h.data_ptr(),
            narrow[0].data_ptr()]
    if len(entry.argtypes) == 13:  # a tree whose entry takes a workspace
        noop += [None, 0]
    noop += [0, 256, 704, 1, stream]

    def call_noop():
        return entry(*noop)

    def kernel():
        return ff.fused_swiglu(x, wg, wi, wo)

    def kernel_narrow():
        return ff.fused_swiglu(*narrow)

    def composite():
        return (F.silu(x @ wg) * (x @ wi)) @ wo

    emit({"what": "fused_ffn", "m": m, "d": d, "f": f, "dtype": "bfloat16",
          "blocks": BLOCKS, **in_turns({
              "events_ms": (events_ms, kernel),
              "composite_events_ms": (events_ms, composite),
              "host_us": (host_us, kernel),
              "composite_host_us": (host_us, composite),
              "narrow_events_ms": (events_ms, kernel_narrow),
              "narrow_host_us": (host_us, kernel_narrow),
              "noop_ctypes_us": (lambda fn, r: host_us(fn, r, sync=False),
                                 call_noop)}, reps),
          "narrow_profile_us": profile_us(kernel_narrow, reps)})


def run_attention(reps: int) -> None:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((1, 64, h, 64), generator=g, device="cuda")
               .bfloat16().transpose(1, 2) for h in (4, 2, 2))
    if not torch.allclose(fa.flash_attention(q, k, v).float(),
                          fa.attention_plain(q, k, v).float(), rtol=2e-2,
                          atol=2e-2):
        raise AssertionError("B2 disagrees with its plain version")

    def kernel():
        return fa.flash_attention(q, k, v)

    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)

    emit({"what": "flash_attention", "b": 1, "h": 4, "hkv": 2, "s": 64,
          "d": 64, "dtype": "bfloat16", "blocks": BLOCKS, **in_turns({
              "events_ms": (events_ms, kernel),
              "library_events_ms": (events_ms, library),
              "host_us": (host_us, kernel),
              "library_host_us": (host_us, library)}, reps),
          "profile_us": profile_us(kernel, reps)})


def run_finish_batch(reps: int) -> None:
    import torch

    sys.path.insert(0, str(ROOT))
    from chip_smoke import _as_args, make_lanes

    from repro_torch.kernels import finish_batch as fb

    lanes_np = make_lanes(185, seed=1)
    args = _as_args(lanes_np)
    got = fb.finish_cost_batch(*args, device="cuda")
    want = fb.finish_cost_batch(*args, device="cpu")
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("B1 round trip differs from the plain version")
    lanes = torch.from_numpy(lanes_np).cuda()

    def roundtrip():
        return fb.finish_cost_batch(*args, device="cuda")

    emit({"what": "finish_batch", "n": 185, "blocks": BLOCKS, **in_turns({
        "roundtrip_us": (host_us, roundtrip),
        "finish_lanes_events_ms": (events_ms,
                                   lambda: fb.finish_lanes(lanes))}, reps),
        "profile_us": profile_us(roundtrip, reps)})


def run_sizes() -> None:
    """``finish_cost_batch`` and a round trip by copies, NumPy to NumPy,
    host clock, in turns, at each lane count; both checked bitwise against
    the plain version first."""
    import torch

    sys.path.insert(0, str(ROOT))
    from chip_smoke import _as_args, make_lanes

    from repro_torch.kernels import finish_batch as fb

    for n in (185, 1 << 12, 1 << 14, 1 << 16, 1 << 18, 1 << 20):
        args = _as_args(make_lanes(n, seed=2))
        lanes = torch.empty((fb.N_IN, n), dtype=torch.int64, pin_memory=True)
        out = torch.empty((fb.N_OUT, n), dtype=torch.int64, pin_memory=True)

        def by_copies(args=args, lanes=lanes, out=out):
            view = lanes.numpy()
            for row, arr in enumerate(args):
                view[row] = arr
            out.copy_(fb.finish_lanes(lanes.to("cuda", non_blocking=True)),
                      non_blocking=True)
            torch.cuda.current_stream().synchronize()
            res = out.numpy()
            return tuple(res[:5].copy()) + tuple(res[5:] != 0)

        def roundtrip(args=args):
            return fb.finish_cost_batch(*args, device="cuda")

        want = fb.finish_cost_batch(*args, device="cpu")
        for fn in (roundtrip, by_copies):
            if not all(np.array_equal(a, b) for a, b in zip(fn(), want)):
                raise AssertionError(f"{fn.__name__} differs from the plain "
                                     f"version at n={n}")
        reps = max(70, min(3500, (1 << 22) // n))
        emit({"what": "finish_batch_sizes", "n": n, "blocks": BLOCKS,
              **in_turns({"roundtrip_us": (host_us, roundtrip),
                          "roundtrip_us_copies": (host_us, by_copies)},
                         reps)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory that holds repro_torch")
    ap.add_argument("--reps", type=int, default=3500,
                    help="calls a figure is taken over (in 7 blocks)")
    runs = {"rmsnorm": run_rmsnorm, "fused_ffn": run_ffn,
            "flash_attention": run_attention,
            "finish_batch": run_finish_batch, "finish_batch_sizes": None}
    ap.add_argument("--only", default=",".join(runs), metavar="WHAT,...",
                    help=f"measure only these (of {', '.join(runs)})")
    args = ap.parse_args(argv)
    only = args.only.split(",")
    if not set(only) <= set(runs):
        ap.error(f"unknown: {sorted(set(only) - set(runs))}")
    import torch

    if not torch.cuda.is_available():
        print("error: needs a CUDA GPU", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    emit({"device": smi, "torch": torch.__version__, "src": str(src)})
    for what in only:
        if what == "finish_batch_sizes":
            run_sizes()
        else:
            runs[what](args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
