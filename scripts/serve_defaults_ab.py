#!/usr/bin/env python3
"""Time ``python -m repro_torch.launch.serve`` at its defaults on the GPU
for two source trees, in turns.

Run from the root of a checkout on a machine with a CUDA GPU::

    python3 scripts/serve_defaults_ab.py --src OTHER_CHECKOUT/src --src src

Each turn runs one tree in a fresh process: ``launch.serve.main`` once to
build and load the kernels and warm up, then again at the same arguments
(the defaults: tinyllama-1.1b, 6 requests of 12 prompt tokens, 8 new
tokens, batches of 4, the reference's fp32 cache, so B2 and B3 take their
fp32 routes), with every kernel's launch count set to 0 before the second
run and read after.  The trees run in the order A, B, B, A (``--rounds``
times).  One JSON line a turn: the tree, the launches, each group's TTFT
and decode rate, and the second run's wall time; the first line names the
card and its power limit.  Extra arguments after ``--`` go to
``launch.serve``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# one turn, in a fresh process with the tree's src first on the path
TURN = r"""
import contextlib, io, json, sys, time
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels import flash_attention, fused_ffn, rmsnorm
from repro_torch.launch import serve
args = ["--device", "cuda", *sys.argv[2:]]
with contextlib.redirect_stdout(io.StringIO()):
    assert serve.main(args) == 0
mods = {"rmsnorm": rmsnorm, "fused_ffn": fused_ffn,
        "flash_attention": flash_attention}
for m in mods.values():
    m.launches = 0
buf = io.StringIO()
t0 = time.perf_counter()
with contextlib.redirect_stdout(buf):
    assert serve.main(args) == 0
wall = time.perf_counter() - t0
groups = [json.loads(ln[len("group: "):]) for ln in buf.getvalue().splitlines()
          if ln.startswith("group: ")]
print(json.dumps({"launches": {k: m.launches for k, m in mods.items()},
                  "wall_s": wall, "groups": groups}))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", action="append", required=True,
                    help="a tree's src directory (give two: A, then B)")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("serve_args", nargs="*",
                    help="arguments for launch.serve, after --")
    args = ap.parse_args(argv)
    if len(args.src) != 2:
        ap.error("give --src twice")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": smi}), flush=True)
    a, b = (str(Path(s).resolve()) for s in args.src)
    for _ in range(args.rounds):
        for src in (a, b, b, a):
            out = subprocess.run([sys.executable, "-c", TURN, src,
                                  *args.serve_args], capture_output=True,
                                 text=True, cwd=ROOT)
            if out.returncode != 0:
                print(out.stderr[-3000:], file=sys.stderr)
                return 1
            row = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps({"src": src, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
