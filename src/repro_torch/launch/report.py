"""Render the dry-run/roofline markdown tables from runs/dryrun/*.json
(the JAX package's ``repro.launch.report``; the same tables from the same
rows).  Needs no device.

    PYTHONPATH=src python -m repro_torch.launch.report [--dir runs/dryrun]

The port's rows (:mod:`repro_torch.launch.dryrun`) carry the reference's
keys: ``compile (s)`` reads their ``compile_s``, which is 0.0 (nothing is
compiled), and bytes/dev their ``temp_size_in_bytes`` plus
``argument_size_in_bytes``, which add up to the traced peak.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List


def load(directory: str) -> List[Dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def fmt_bytes(b) -> str:
    if b is None:
        return "-"
    return f"{b / 2**30:.2f}"


def dryrun_table(rows: List[Dict], mesh: str) -> str:
    out = ["| arch | shape | status | bytes/dev (GiB) | compile (s) | "
           "collectives (GiB, wire) |",
           "|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if r["mesh"] != mesh:
            continue
        if "skipped" in r:
            out.append(f"| {r['arch']} | {r['shape']} | SKIP (documented)"
                       f" | - | - | - |")
            continue
        if "error" in r:
            out.append(f"| {r['arch']} | {r['shape']} | FAIL | - | - | - |")
            continue
        dev_bytes = (r.get("temp_size_in_bytes", 0)
                     + r.get("argument_size_in_bytes", 0))
        out.append(
            f"| {r['arch']} | {r['shape']} | ok | {fmt_bytes(dev_bytes)} | "
            f"{r.get('compile_s', 0):.0f} | "
            f"{r.get('coll_gbytes', 0):.2f} |")
    return "\n".join(out)


def roofline_table(rows: List[Dict], mesh: str = "pod16x16") -> str:
    out = ["| arch | shape | t_comp (ms) | t_mem (ms) | t_coll (ms) | "
           "bound | MODEL/HLO flops | roofline frac |",
           "|---|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if r.get("mesh") != mesh or "bottleneck" not in r:
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_ms']:.2f} | "
            f"{r['t_memory_ms']:.2f} | {r['t_collective_ms']:.2f} | "
            f"{r['bottleneck']} | {r['flops_util']:.2f} | "
            f"{r['roofline_frac']:.3f} |")
    return "\n".join(out)


def pick_hillclimb(rows: List[Dict]) -> List[Dict]:
    """Worst roofline fraction, most collective-bound, most representative
    (largest fused-attention share: a long-seq train/prefill cell)."""
    ok = [r for r in rows if r.get("mesh") == "pod16x16"
          and "bottleneck" in r]
    if not ok:
        return []
    worst = min(ok, key=lambda r: r["roofline_frac"])
    coll = max(ok, key=lambda r: (r["t_collective_ms"]
                                  / max(max(r["t_compute_ms"],
                                            r["t_memory_ms"]), 1e-9)))
    rep = max((r for r in ok if r["kind"] in ("train", "prefill")),
              key=lambda r: r["hlo_gflops"], default=worst)
    picks, seen = [], set()
    for r, why in ((worst, "worst roofline fraction"),
                   (coll, "most collective-bound"),
                   (rep, "most representative of the technique")):
        key = (r["arch"], r["shape"])
        if key not in seen:
            seen.add(key)
            picks.append({**r, "why": why})
    return picks


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="runs/dryrun")
    args = ap.parse_args()
    rows = load(args.dir)
    print("## Dry-run (single pod 16x16)\n")
    print(dryrun_table(rows, "pod16x16"))
    print("\n## Dry-run (multi-pod 2x16x16)\n")
    print(dryrun_table(rows, "pod2x16x16"))
    print("\n## Roofline (single pod)\n")
    print(roofline_table(rows))
    print("\n## Hillclimb picks\n")
    for p in pick_hillclimb(rows):
        print(f"- {p['arch']} x {p['shape']}: {p['why']} "
              f"(frac={p['roofline_frac']:.3f}, bound={p['bottleneck']})")


if __name__ == "__main__":
    main()
