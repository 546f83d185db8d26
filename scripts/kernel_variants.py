#!/usr/bin/env python3
"""Time tile-shape variants of the port's B2, B3 and B4 CUDA kernels on one
GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit::

    python3 scripts/kernel_variants.py \
        [--only ffn|ffn32|attn|mla|attn256|attn32|rms]

Each variant is the kernel's source in ``src/repro_torch/csrc/`` with a
few lines replaced (``fused_ffn.cu``: its M thresholds, stages and splits,
bf16 (``ffn``) and fp32 (``ffn32``); ``flash_attention.cu``: the TMA
route's stages and blocks, and probes, at d 64 (``attn``), at MLA's
(192, 128) (``mla``) and at gemma3-4b's d 256 (``attn256``: beside the
mma.sync route it replaced), and the fp32 route's query tiles
(``attn32``); ``rmsnorm.cu``: threads a row, a persistent grid, and
probes), built with
the port's nvcc flags into ``build/variants/`` (all variants at once) and
called through the port's own wrapper.  Every variant is checked against
the plain torch version (bf16 tolerance 2e-2) before it is timed (CUDA
events back to back, and device time from ``torch.profiler``) at the
serving shapes of tinyllama-1.1b (fp32 B3 there and at the ~100M
trainer's shape, within 2e-5; MLA at deepseek-v2's 8 x 512 prefill;
d 256 at gemma3-4b's prefill, with and without its 1,024-key window;
fp32 B2 at tinyllama's 8 x 512 and the ~100M trainer's shape, within
2e-5);
probes (``probe_*``, one part of the loop removed) are timed though wrong,
to show what each part costs.  B4's
shapes that move more than a few MB are timed over enough input sets to
exceed twice the 50 MB L2, so that every call reads from device memory.
The library yardsticks (``F.scaled_dot_product_attention`` with GQA, three
bf16 ``torch.matmul``s for SwiGLU, ``F.rms_norm``, and for B4 a device copy
of x, the bytes it moves without the arithmetic) are timed in the same
process.  One JSON line per variant; the first line names the card and its
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# each variant: (old text, new text) substitutions in the kernel's source
FFN_VARIANTS = {
    "repo": (),
    # every M on one tile kind: the threshold (kSmallMaxM) is where they cross
    "small_tiles_only": (("constexpr long long kSmallMaxM = 16;",
                          "constexpr long long kSmallMaxM = 1LL << 40;"),),
    "large_tiles_only": (("constexpr long long kSmallMaxM = 16;",
                          "constexpr long long kSmallMaxM = 0;"),),
    "large_out_4_stages": (("STAGES = NB == 2 ? 4 : 6",
                            "STAGES = NB == 2 ? 4 : 4"),),
}
# the TMA route's stages and blocks an SM, and its loop with one part
# removed (probes: wrong results, timed anyway)
_ATTN_CFG = ("  static constexpr int BKV = 64, QS = 2, KVS = 3, "
             "MINB = DQK == 64 ? 3 : 2;")
ATTN_VARIANTS = {
    "repo": (),
    "kvs4": ((_ATTN_CFG, _ATTN_CFG.replace("KVS = 3", "KVS = 4")),),
    "minb2": ((_ATTN_CFG, _ATTN_CFG.replace("DQK == 64 ? 3 : 2", "2")),),
    "probe_no_exp": (("sc[j] = fast_exp2(fmaf(sc[j], sl2, "
                      "-msl[(j >> 1) & 1]));",
                      "sc[j] = fmaf(sc[j], sl2, -msl[(j >> 1) & 1]);"),),
    "probe_no_pv": (("          wgmma_rs_m64n64k16<1>(acc, p_prev[kk], dv);",
                     "          acc[kk] += __uint_as_float(p_prev[kk][0]);"),),
    "probe_no_mask": (("      if (k0 < max(lo[0], lo[1]) || "
                       "k0 + BKV - 1 > min(hi[0], hi[1])) {",
                       "      if (false) {"),),
}
# B3's fp32 route: every M on one design (the threshold, kSmallMaxMF32, is
# where they cross), the tiles' ring depth and the least split depth
_SG_FMA = ("          fma4(acc[4 * q + e][0], x, b[k & 1][0]);\n"
           "          fma4(acc[4 * q + e][1], x, b[k & 1][1]);\n")
FFN32_VARIANTS = {
    "repo": (),
    "tiles_only": (("constexpr long long kSmallMaxMF32 = 16;",
                    "constexpr long long kSmallMaxMF32 = 0;"),),
    "min_split_256": (("constexpr int kMinSplitK = 128;",
                       "constexpr int kMinSplitK = 256;"),),
    "no_64_row_tiles": (("for (const int tm : {16, 8})",
                         "for (const int tm : {16})"),),
    "no_splits_in_tiles": (("for (int S = 1; S <= std::max(1, K[i] / "
                            "kMinSplitK); ++S)",
                            "for (int S = 1; S <= 1; ++S)"),),
    "bk16": (("SG_BK = 32, SG_THREADS = 256;",
              "SG_BK = 16, SG_THREADS = 256;"),),
    "probe_no_fma": ((_SG_FMA, "          acc[4 * q + e][0][0] += x;\n"
                               "          acc[4 * q + e][1][0] += "
                               "b[k & 1][0].x + b[k & 1][1].x;\n"),),
}
# B2 at MLA's (192, 128): keys a tile, Q buffers, K/V stages and blocks
# an SM, and the order of the work items
_MLA_CFG = ("  static constexpr int BKV = 128, QS = 1, KVS = 2, MINB = 1;\n"
            "  static constexpr bool HEADS_FIRST = true;")


def _mla(bkv, qs, kvs, minb, heads_first=True):
    return ((_MLA_CFG, f"  static constexpr int BKV = {bkv}, QS = {qs}, "
             f"KVS = {kvs}, MINB = {minb};\n  static constexpr bool "
             f"HEADS_FIRST = {'true' if heads_first else 'false'};"),)


MLA_VARIANTS = {
    "repo": (),
    "q_tiles_first": _mla(128, 1, 2, 1, heads_first=False),
    "bkv64_qs1_kvs4": _mla(64, 1, 4, 1),
    "bkv64_qs2_kvs3": _mla(64, 2, 3, 1),
    "bkv64_qs1_kvs2_minb2": _mla(64, 1, 2, 2),
}

# B4: threads a row (the repo's choice holds a row of d 2048 in bf16 in one
# 16-byte unit a thread, 256 threads; more units a thread give fewer
# threads a row and more rows a block), rows a thread at once (at M >=
# 1024), a persistent grid of k blocks an SM looping over row groups (the
# loop and the grid's cap patched in), a cap on registers for 6 or 8 blocks
# an SM, and probes without the scale or the reduction
_RMS_ROWS = "constexpr int kRowsPerThread = 2;"
_RMS_BOUNDS = "__global__ void __launch_bounds__(kThreads)\nrmsnorm_kernel"


def _rms(units=None, rows=None, grid=None, min_blocks=None):
    subs = []
    if units is not None:
        subs.append(("  while (tpr < units && ",
                     f"  while (tpr < (units + {units - 1}) / {units} && "))
    if rows is not None:
        subs.append((_RMS_ROWS, f"constexpr int kRowsPerThread = {rows};"))
    if grid is not None:
        # the register route's row group becomes a loop over groups (a
        # barrier before each: the shared partial sums are reused), and
        # its grid is capped at `grid` blocks an SM
        subs += [
            ("    const long long base = (long long)blockIdx.x * rows * R;\n",
             "    for (long long base = (long long)blockIdx.x * rows * R;\n"
             "         base < m; base += (long long)gridDim.x * rows * R) {\n"
             "    __syncthreads();\n"),
            ("  } else {\n    const long long row = (long long)blockIdx.x",
             "  }\n  } else {\n    const long long row = "
             "(long long)blockIdx.x"),
            ("  const long long grid = (m + rows - 1) / rows;\n",
             "  long long grid = (m + rows - 1) / rows;\n"
             "  int dev = 0, sms = 0;\n"
             "  cudaGetDevice(&dev);\n"
             "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,"
             " dev);\n"
             f"  if (NV > 0 && grid > {grid}LL * sms)\n"
             f"    grid = {grid}LL * sms;\n"),
        ]
    if min_blocks is not None:
        subs.append((_RMS_BOUNDS, _RMS_BOUNDS.replace(
            "(kThreads)", f"(kThreads, {min_blocks})")))
    return tuple(subs)


RMS_VARIANTS = {
    "repo": (),
    "rows1": _rms(rows=1),
    "rows1_minblocks8": _rms(rows=1, min_blocks=8),
    "rows4": _rms(rows=4),
    "minblocks6": _rms(min_blocks=6),
    "units2_rows1": _rms(units=2, rows=1),
    "rows1_persistent8": _rms(rows=1, grid=8),
    "persistent4": _rms(grid=4),
    "rows4_persistent2": _rms(rows=4, grid=2),
    "probe_no_scale": (("      if (c < units) sc[i] = load_unit<S, VT>(scale "
                        "+ c * VT);",
                        "      if (c < units) for (int j = 0; j < VT; ++j) "
                        "sc[i].e[j] = from_f32<S>(1.f);"),),
    "probe_no_reduce": (("    row_sums<R>(ss, tpr, part);\n", ""),),
}
# B2 at d 256: the TMA route's stages, and the mma.sync route it replaced
# (d 256 taken out of the TMA route's widths)
_D256_CFG = "  static constexpr int BKV = 64, QS = 1, KVS = 3, MINB = 1;\n" \
    "  static constexpr bool HEADS_FIRST = false;\n};\nconstexpr int WG"
_TMA_WIDTHS = "(DQK == 64 || DQK == 128 || DQK == 256) && DV == DQK"
ATTN256_VARIANTS = {
    "repo": (),
    "kvs2": ((_D256_CFG, _D256_CFG.replace("KVS = 3", "KVS = 2")),),
    "heads_first": ((_D256_CFG, _D256_CFG.replace("= false", "= true")),),
    "mma_sync_route": ((_TMA_WIDTHS,
                        "(DQK == 64 || DQK == 128) && DV == DQK"),),
}
# B2's fp32 route: every shape on 64-row or on 32-row query tiles (the repo
# takes 32 where 64 would leave block slots empty), and a probe without
# the exponentials
_F32_TILES = "    return blocks < (long long)facts.sms * facts.per_sm\n"
ATTN32_VARIANTS = {
    "repo": (),
    "rows64_only": ((_F32_TILES, "    return false\n"),),
    "rows32_only": ((_F32_TILES, "    return true\n"),),
    "probe_no_exp": (("          sc[i][j] = fast_exp2(fmaf(sc[i][j], sl2, "
                      "-msl));",
                      "          sc[i][j] = fmaf(sc[i][j], sl2, -msl);"),),
    # the loops over d (S) and over keys (O += P V) unrolled further
    "unroll_d_full": (("#pragma unroll 4\n      for (int d = 0; d < DQK; "
                       "d += 4) {",
                       "#pragma unroll\n      for (int d = 0; d < DQK; "
                       "d += 4) {"),),
    "unroll_keys_16": (("#pragma unroll 4\n      for (int key = 0; key < "
                        "BKV; ++key) {",
                        "#pragma unroll 16\n      for (int key = 0; key < "
                        "BKV; ++key) {"),),
    # 32-key tiles at every width: 63 KB at d 64, three blocks an SM
    "bkv32": (("BKV = DQK + DV >= 256 ? 32 : 64", "BKV = 32"),),
}
VARIANTS = {"fused_ffn": FFN_VARIANTS, "fused_ffn_f32": FFN32_VARIANTS,
            "flash_attention": ATTN_VARIANTS,
            "flash_attention_mla": MLA_VARIANTS,
            "flash_attention_d256": ATTN256_VARIANTS,
            "flash_attention_f32": ATTN32_VARIANTS, "rmsnorm": RMS_VARIANTS}
# the source each set of variants edits
SOURCE = {"fused_ffn_f32": "fused_ffn",
          "flash_attention_mla": "flash_attention",
          "flash_attention_d256": "flash_attention",
          "flash_attention_f32": "flash_attention"}


def variant_sources(name: str) -> dict:
    src = (ROOT / "src/repro_torch/csrc"
           / f"{SOURCE.get(name, name)}.cu").read_text()
    variants = VARIANTS[name]
    out = {}
    for tag, subs in variants.items():
        text = src
        for old, new in subs:
            assert text.count(old) == 1, (tag, old)
            text = text.replace(old, new)
        out[tag] = text
    return out


def build_variants(name: str) -> dict:
    """Every variant of ``csrc/<name>.cu``, one nvcc each, all at once."""
    from repro_torch.kernels import _build

    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    work = ROOT / "build" / "variants"
    work.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, text in variant_sources(name).items():
        cu = work / f"{name}_{tag}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o",
               str(so), str(cu)]
        procs[tag] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True))
    libs = {}
    for tag, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            print(json.dumps({"kernel": name, "variant": tag,
                              "build_failed": err[-3000:]}), flush=True)
            continue
        lib = ctypes.CDLL(str(so))
        for fn, (argtypes, restype) in _build._SIGNATURES[
                SOURCE.get(name, name)].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        # ptxas: each kernel's name, then its registers and spills
        report = []
        for ln in err.splitlines():
            if "Compiling entry function" in ln:
                report.append(ln.split("'")[1][-60:])
            elif "spill" in ln or "registers" in ln:
                report.append(ln.split(" : ")[-1].strip())
        libs[tag] = (lib, report)
    return libs


def _calls(fn, reps: int, sets):
    """``reps`` calls of ``fn``, call ``i`` on ``sets[i % len(sets)]``; with
    several sets the last ``len(sets)`` outputs stay alive, so that outputs
    rotate through fresh memory as the inputs do."""
    keep = [None] * len(sets) if len(sets) > 1 else None
    for i in range(reps):
        out = fn(*sets[i % len(sets)])
        if keep:
            keep[i % len(keep)] = out


def events_ms(fn, reps: int, sets=((),)) -> float:
    import torch

    _calls(fn, max(3, len(sets)), sets)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    _calls(fn, reps, sets)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, name: str, sets=((),)):
    """Device time per call of the device kernels whose names contain
    ``name`` (all of them for ``""``), from ``torch.profiler``, host launch
    cost excluded; ``None`` when the profiler shows none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    _calls(fn, len(sets), sets)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _calls(fn, reps, sets)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    per_name: dict = {}  # the trace may miss a few launches: mean x count
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and name in e.name:
            c = per_name.setdefault(e.name, [0, 0.0])
            c[0] += 1
            c[1] += e.time_range.elapsed_us()
    total = sum(us / n * max(1, round(n / reps))
                for n, us in per_name.values())
    return total / 1e3 if total > 0 else None


def launched(fn, name: str) -> list:
    """The names of the device kernels containing ``name`` that ``fn()``
    launched, from ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA and name in e.name})


def close(got, want) -> bool:
    import torch

    return bool(torch.isfinite(got).all()) and torch.allclose(
        got.float(), want.float(), rtol=2e-2, atol=2e-2)


def randn(shape, seed, scale=1.0):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda")
            * scale).to(torch.bfloat16)


def run_ffn() -> None:
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_ffn as ff

    d, f = 2048, 5632
    for m in (4096, 800, 64, 32, 24, 16, 8):
        x = randn((m, d), 1)
        wg, wi = randn((d, f), 2, d ** -0.5), randn((d, f), 3, d ** -0.5)
        wo = randn((f, d), 4, f ** -0.5)
        want = ff.swiglu_plain(x, wg, wi, wo)
        print(json.dumps({"kernel": "fused_ffn", "m": m, "variant":
                          "composite (3 bf16 matmuls + silu * u)",
                          "ms": events_ms(lambda: (F.silu(x @ wg) * (x @ wi))
                                          @ wo, 20)}), flush=True)
        for tag, (lib, spills) in LIBS["fused_ffn"].items():
            _build._LOADED["fused_ffn"] = lib
            ok = close(ff.fused_swiglu(x, wg, wi, wo), want)

            def call():
                return ff.fused_swiglu(x, wg, wi, wo)

            print(json.dumps({
                "kernel": "fused_ffn", "m": m, "variant": tag, "ok": ok,
                "ptxas": spills,
                "ms": events_ms(call, 20 if m > 64 else 200) if ok else None,
                "device_ms": device_ms(call, 20, "ffn_") if ok else None}),
                flush=True)
    _build._LOADED.pop("fused_ffn", None)


def _in_turns(timed: dict, passes: int) -> dict:
    """name -> (median events ms, median device ms) of each ``(call, reps,
    device kernels' name, (lib name, lib) or None)`` in ``timed``, timed
    in ``passes`` turns (each turn times all of them once)."""
    import statistics

    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_ffn as ff

    runs = {name: ([], []) for name in timed}
    for _ in range(passes):
        for name, (fn, reps, kname, lib) in timed.items():
            if lib is not None:
                _build._LOADED[lib[0]] = lib[1]
                ff._WORKSPACE.clear()  # a variant may split otherwise
            runs[name][0].append(events_ms(fn, reps))
            runs[name][1].append(device_ms(fn, max(reps // 2, 3), kname))
    out = {}
    for name, (ms, dev) in runs.items():
        seen = [t for t in dev if t is not None]
        out[name] = (statistics.median(ms),
                     statistics.median(seen) if seen else None)
    return out


def run_ffn32(passes: int = 2) -> None:
    """B3's fp32 variants against the plain version (2e-5) and the fp32
    composite (three ``torch.matmul``s, TF32 off) at tinyllama-1.1b's
    width (M 4096, across the small-M switch, decode) and at the ~100M
    trainer's microbatch (M 512, d 768, f 2048), in turns."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_ffn as ff

    torch.backends.cuda.matmul.allow_tf32 = False
    for m, d, f in ((4096, 2048, 5632), (512, 768, 2048), (8, 2048, 5632),
                    (16, 2048, 5632), (17, 2048, 5632), (32, 2048, 5632),
                    (48, 2048, 5632), (256, 2048, 5632), (1024, 2048, 5632)):
        g = torch.Generator(device="cuda").manual_seed(m)
        x, wg, wi, wo = (torch.randn(shape, generator=g, device="cuda") * sc
                         for shape, sc in (((m, d), 1.0), ((d, f), d ** -0.5),
                                           ((d, f), d ** -0.5),
                                           ((f, d), f ** -0.5)))
        want = ff.swiglu_plain(x, wg, wi, wo)
        reps = 5 if m >= 4096 else 50
        smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, text=True) if m >= 4096 else None
        timed = {"composite (3 fp32 matmuls + silu * u)":
                 (lambda: (F.silu(x @ wg) * (x @ wi)) @ wo, reps, "", None)}
        rows = {name: {} for name in timed}
        for tag, (lib, spills) in LIBS["fused_ffn_f32"].items():
            _build._LOADED["fused_ffn"] = lib
            ff._WORKSPACE.clear()
            got = ff.fused_swiglu(x, wg, wi, wo)
            ok = bool(torch.isfinite(got).all()) and torch.allclose(
                got, want, rtol=2e-5, atol=2e-5)
            rows[tag] = {"ok": ok, "repeat": ok and torch.equal(
                got, ff.fused_swiglu(x, wg, wi, wo)), "ptxas": spills}
            if ok or tag.startswith("probe_"):
                timed[tag] = (lambda: ff.fused_swiglu(x, wg, wi, wo), reps,
                              "ffn_", ("fused_ffn", lib))
        times = _in_turns(timed, passes)
        if smi is not None:  # the SM clock and power while they ran
            smi.terminate()
            samples = [[float(v) for v in ln.split(",")]
                       for ln in smi.communicate()[0].splitlines()
                       if ln.strip()]
            print(json.dumps({"kernel": "fused_ffn", "m": m,
                              "sm_clock_mhz_power_w": samples}), flush=True)
        for name, row in rows.items():
            ms, dev = times.get(name, (None, None))
            print(json.dumps({"kernel": "fused_ffn", "dtype": "float32",
                              "m": m, "d": d, "f": f, "variant": name,
                              **row, "ms": ms, "device_ms": dev}),
                  flush=True)
    _build._LOADED.pop("fused_ffn", None)
    ff._WORKSPACE.clear()


def run_mla(passes: int = 2) -> None:
    """B2's (192, 128) variants against the plain version (bf16 2e-2) at
    deepseek-v2's 8 x 512 prefill (H = Hkv 128, scale 1/sqrt(192)), beside
    ``F.scaled_dot_product_attention`` on the same tensors and the kernel
    on q, k, v zero-padded to 256 columns (the route MLA took before), in
    turns."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    b, h, s_len, scale = 8, 128, 512, 192 ** -0.5
    q, k = (randn((b, s_len, h, 192), 5 + i).transpose(1, 2)
            for i in range(2))
    v = randn((b, s_len, h, 128), 7).transpose(1, 2)
    padded = [F.pad(t, (0, 256 - t.shape[-1])) for t in (q, k, v)]
    want = fa.attention_plain(q, k, v, scale=scale)
    base = LIBS["flash_attention_mla"]["repo"][0]
    timed = {
        "F.scaled_dot_product_attention": (
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                   scale=scale), 20, "",
            None),
        "padded to d 256 (the repo's mma.sync route)": (
            lambda: fa.flash_attention(*padded, scale=scale), 10,
            "flash_attn_", ("flash_attention", base))}
    rows = {name: {} for name in timed}
    for tag, (lib, spills) in LIBS["flash_attention_mla"].items():
        _build._LOADED["flash_attention"] = lib
        ok = close(fa.flash_attention(q, k, v, scale=scale), want)
        rows[tag] = {"ok": ok, "ptxas": spills}
        if ok:
            timed[tag] = (lambda: fa.flash_attention(q, k, v, scale=scale),
                          20, "flash_attn_", ("flash_attention", lib))
    times = _in_turns(timed, passes)
    for name, row in rows.items():
        ms, dev = times.get(name, (None, None))
        print(json.dumps({"kernel": "flash_attention", "b": b, "h": h,
                          "s": s_len, "dqk": 192, "dv": 128,
                          "variant": name, **row, "ms": ms,
                          "device_ms": dev}), flush=True)
    _build._LOADED.pop("flash_attention", None)


def run_attn256(passes: int = 2) -> None:
    """B2's d-256 variants against the plain version (bf16 2e-2) at
    gemma3-4b's prefill (B 4, H 8, Hkv 4, S 2,048, causal), without and
    with its local layers' 1,024-key window, beside
    ``F.scaled_dot_product_attention`` (GQA; causal on its flash backend,
    the window as a boolean band mask on the backend torch picks) and the
    repo's kernel on rows TMA cannot read (q, k, v sliced out of rows 260
    elements apart, not whole 16-byte units: the mma.sync route with
    element loads, held to launch ``flash_attn_bf16_kernel``), in turns."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    b, h, hkv, s_len = 4, 8, 4, 2048
    q, k, v = (randn((b, s_len, n, 256), 5 + i).transpose(1, 2)
               for i, n in enumerate((h, hkv, hkv)))
    wide = [torch.zeros((b, s_len, t.shape[1], 260), dtype=t.dtype,
                        device="cuda") for t in (q, k, v)]
    for w, t in zip(wide, (q, k, v)):
        w[..., :256] = t.transpose(1, 2)
    q2, k2, v2 = (w[..., :256].transpose(1, 2) for w in wide)
    base = LIBS["flash_attention_d256"]["repo"][0]

    def sdpa():
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)

    pos = torch.arange(s_len, device="cuda")
    back = pos[:, None] - pos[None, :]
    band = (back >= 0) & (back < 1024)

    def sdpa_band():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=band,
                                              enable_gqa=True)

    _build._LOADED["flash_attention"] = base
    names = launched(lambda: fa.flash_attention(q2, k2, v2), "flash_attn")
    if not names or any("flash_attn_bf16_kernel" not in n for n in names):
        raise AssertionError(f"rows TMA cannot read launched {names}")
    for window in (0, 1024):
        want = fa.attention_plain(q, k, v, window=window)
        timed = {
            "repo on rows TMA cannot read (mma.sync, element loads)": (
                lambda w=window: fa.flash_attention(q2, k2, v2, window=w),
                10, "flash_attn_bf16_kernel", ("flash_attention", base))}
        if window:
            timed["F.scaled_dot_product_attention (band mask)"] = (
                sdpa_band, 20, "", None)
        else:
            timed["F.scaled_dot_product_attention (flash)"] = (sdpa, 20, "",
                                                               None)
        rows = {name: {} for name in timed}
        for tag, (lib, spills) in LIBS["flash_attention_d256"].items():
            _build._LOADED["flash_attention"] = lib
            ok = close(fa.flash_attention(q, k, v, window=window), want)
            rows[tag] = {"ok": ok, "ptxas": spills}
            if ok:
                timed[tag] = (lambda w=window: fa.flash_attention(
                    q, k, v, window=w), 20, "flash_attn_",
                    ("flash_attention", lib))
        times = _in_turns(timed, passes)
        for name, row in rows.items():
            ms, dev = times.get(name, (None, None))
            print(json.dumps({"kernel": "flash_attention", "b": b, "h": h,
                              "hkv": hkv, "s": s_len, "d": 256,
                              "window": window, "variant": name, **row,
                              "ms": ms, "device_ms": dev}), flush=True)
    _build._LOADED.pop("flash_attention", None)


def run_attn32(passes: int = 2) -> None:
    """B2's fp32 variants against the plain version (2e-5, TF32 off) at
    tinyllama-1.1b's 8 x 512 prefill under the fp32 cache (B 8, H 32, Hkv
    4, d 64) and at the ~100M trainer's microbatch (B 2, H 12, Hkv 4, S
    256), beside ``F.scaled_dot_product_attention`` in fp32 (GQA, the
    backend torch picks), in turns; each variant called twice and held to
    repeat bit for bit."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    for b, h, hkv, s_len in ((8, 32, 4, 512), (2, 12, 4, 256)):
        g = torch.Generator(device="cuda").manual_seed(s_len)
        q, k, v = (torch.randn((b, s_len, n, 64), generator=g,
                               device="cuda").transpose(1, 2)
                   for n in (h, hkv, hkv))
        want = fa.attention_plain(q, k, v)
        timed = {"F.scaled_dot_product_attention (fp32)": (
            lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), 50, "", None)}
        rows = {name: {} for name in timed}
        for tag, (lib, spills) in LIBS["flash_attention_f32"].items():
            _build._LOADED["flash_attention"] = lib
            got = fa.flash_attention(q, k, v)
            ok = bool(torch.isfinite(got).all()) and torch.allclose(
                got, want, rtol=2e-5, atol=2e-5)
            rows[tag] = {"ok": ok, "repeat": ok and torch.equal(
                got, fa.flash_attention(q, k, v)),
                "max_abs_err": float((got - want).abs().max()),
                "ptxas": spills}
            if ok or tag.startswith("probe_"):
                timed[tag] = (lambda: fa.flash_attention(q, k, v), 50,
                              "flash_attn_", ("flash_attention", lib))
        times = _in_turns(timed, passes)
        for name, row in rows.items():
            ms, dev = times.get(name, (None, None))
            print(json.dumps({"kernel": "flash_attention", "dtype":
                              "float32", "b": b, "h": h, "hkv": hkv,
                              "s": s_len, "d": 64, "variant": name, **row,
                              "ms": ms, "device_ms": dev}), flush=True)
    _build._LOADED.pop("flash_attention", None)


def run_attn() -> None:
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    for b, s in ((8, 512), (4, 200), (8, 1024)):
        h, hkv, hd = 32, 4, 64
        q = randn((b, s, h, hd), 5).transpose(1, 2)
        k = randn((b, s, hkv, hd), 6).transpose(1, 2)
        v = randn((b, s, hkv, hd), 7).transpose(1, 2)
        want = fa.attention_plain(q, k, v)
        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)

        print(json.dumps({"kernel": "flash_attention", "b": b, "s": s,
                          "variant": "F.scaled_dot_product_attention",
                          "ms": events_ms(sdpa, 100),
                          "device_ms": device_ms(sdpa, 50, "")}), flush=True)
        for tag, (lib, spills) in LIBS["flash_attention"].items():
            _build._LOADED["flash_attention"] = lib
            ok = close(fa.flash_attention(q, k, v), want)
            def call():
                return fa.flash_attention(q, k, v)

            print(json.dumps({
                "kernel": "flash_attention", "b": b, "s": s, "variant": tag,
                "ok": ok, "ptxas": spills,
                "ms": events_ms(call, 100) if ok else None,
                "device_ms": device_ms(call, 50, "flash_attn_")
                if ok or tag.startswith("probe_") else None}), flush=True)
    _build._LOADED.pop("flash_attention", None)


def run_rms(passes: int = 3) -> None:
    """B4 variants at d 2048 (M 4096 prefill, M 8 decode) and at qk-norm's
    d 128 over 4096 tokens x 32 heads, bf16; shapes above a few MB on
    rotating input sets (L2-cold).  Every variant and yardstick is timed in
    ``passes`` turns (each turn times all of them once); the line gives the
    median of the turns."""
    import statistics

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import rmsnorm as rn

    for m, d in ((4096, 2048), (8, 2048), (4096 * 32, 128)):
        nbytes = (2 * m * d + d) * 2
        n_sets = -(-2 * (50 << 20) // nbytes) + 1 if nbytes > 4 << 20 else 1
        sets = tuple((randn((m, d), 10 + 2 * i), randn((d,), 11 + 2 * i))
                     for i in range(n_sets))
        copies = tuple((x, torch.empty_like(x)) for x, _ in sets)
        want = rn.rmsnorm_plain(*sets[0])

        def library(x, s, d=d):
            return F.rms_norm(x, (d,), s, 1e-5)

        # name -> (call, its argument sets, device kernels' name, lib)
        timed = {"copy_ (x to a second buffer)":
                 (lambda x, o: o.copy_(x), copies, "", None),
                 "F.rms_norm": (library, sets, "", None)}
        rows = {name: {} for name in timed}
        for tag, (lib, spills) in LIBS["rmsnorm"].items():
            _build._LOADED["rmsnorm"] = lib
            ok = close(rn.fused_rmsnorm(*sets[0]), want)
            rows[tag] = {"ok": ok, "ptxas": spills}
            if ok or tag.startswith("probe_"):
                timed[tag] = (rn.fused_rmsnorm, sets, "rmsnorm_", lib)
        runs = {name: ([], []) for name in timed}
        for _ in range(passes):
            for name, (fn, args, kname, lib) in timed.items():
                if lib is not None:
                    _build._LOADED["rmsnorm"] = lib
                runs[name][0].append(events_ms(fn, 200, args))
                runs[name][1].append(device_ms(fn, 100, kname, args))
        for name, row in rows.items():
            ms, dev = runs.get(name, ([], []))
            # a pass whose trace held no device time is left out
            seen = [t for t in dev if t is not None]
            print(json.dumps({
                "kernel": "rmsnorm", "m": m, "d": d, "variant": name,
                "sets": n_sets, "bound_ms": nbytes / 3.35e12 * 1e3, **row,
                "ms": statistics.median(ms) if ms else None,
                "device_ms": statistics.median(seen) if seen else None,
                "device_ms_passes": dev}), flush=True)
    _build._LOADED.pop("rmsnorm", None)


LIBS: dict = {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=["ffn", "ffn32", "attn", "mla",
                                       "attn256", "attn32", "rms"],
                    default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("error: needs a CUDA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": smi, "torch": torch.__version__}), flush=True)
    names = {"ffn": ["fused_ffn"], "ffn32": ["fused_ffn_f32"],
             "attn": ["flash_attention"], "mla": ["flash_attention_mla"],
             "attn256": ["flash_attention_d256"],
             "attn32": ["flash_attention_f32"], "rms": ["rmsnorm"],
             None: list(VARIANTS)}[args.only]
    for name in names:
        LIBS[name] = build_variants(name)
    runs = {"fused_ffn": run_ffn, "fused_ffn_f32": run_ffn32,
            "flash_attention": run_attn, "flash_attention_mla": run_mla,
            "flash_attention_d256": run_attn256,
            "flash_attention_f32": run_attn32, "rmsnorm": run_rms}
    for name in names:
        runs[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
