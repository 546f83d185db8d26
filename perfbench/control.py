"""The readings that a cell's limit is set from, on the card at the cell's
own size: for each seed, the program serves the first batches of the
cell's traffic, enough to finish as many requests as a run compares; the
reference then reads the gaps of the served tokens (the program's
reading) and of the tokens its fp8 forward ranks first (the control's).

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        [--look] [--out FILE]

With ``--look``, instead of the control: where the widest gaps come from
(the router's margins at their positions) and the gaps of the tokens the
reference with bf16 products ranks first.  One JSON line a seed.  The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    ROOT = Path(__file__).resolve().parent.parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve()
                   != Path(__file__).resolve().parent]
    sys.path[0:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import check, spec, traffic, weights  # noqa: E402


def summary(gaps) -> dict:
    """The mean gap, the widest and other statistics of a list of
    gaps."""
    g = sorted(gaps)
    n = len(g)
    return {"mean": sum(g) / n, "max": g[-1],
            "p99": g[min(n - 1, math.ceil(0.99 * n) - 1)],
            "share_over_0": sum(x > 0 for x in g) / n, "tokens": n}


def look(read) -> dict:
    """Where the widest gaps come from: the 12 served tokens with the
    widest gaps, each with the least router margin at its position, and
    the quantiles of that margin over every sampled token."""
    pairs = sorted(((g, m) for r in read
                    for g, m in zip(r["gaps"], r["margin"])), reverse=True)
    margins = sorted(m for _, m in pairs)
    n = len(margins)
    return {"widest": [[g, m] for g, m in pairs[:12]],
            "margin_quantiles": {q: margins[min(n - 1, int(q * n))]
                                 for q in (0.01, 0.05, 0.1, 0.5)}}


def readings(cell: dict, seed: int, device, with_look: bool = False) -> dict:
    """The program's gaps on ``seed`` and the control's (fp8); with
    ``with_look``, :func:`look` and the gaps of bf16 products in the
    reference (what bf16 rounding of the products alone reads) in place
    of the control's."""
    import torch

    from repro_torch.models.config import ModelConfig
    from repro_torch.serve import ServeConfig, ServeEngine

    from perfbench.harness import _serve_batch, _served_ok

    conf, mix = cell["config"], cell["mix"]
    cfg = ModelConfig(**conf["port"])
    weights.check_layers(cfg, conf["layers"])
    tree, ref_w = weights.draw(cfg, seed, device, conf["layers"])
    eng = ServeEngine(cfg, tree, ServeConfig(
        max_batch=int(mix["batch"]), max_len=traffic.max_len(mix),
        cache_dtype=getattr(torch, mix["cache_dtype"])))
    del tree
    lens = len(mix["prompt_lens"])
    n = math.ceil(int(mix["check_requests"]) / int(mix["batch"]) / lens) \
        * lens
    t0 = time.perf_counter()
    served = [_serve_batch(eng, traffic.batch(mix, cfg.vocab, seed, i),
                           i * mix["batch"]) for i in range(n)]
    serve_s = time.perf_counter() - t0
    del eng
    torch.cuda.empty_cache() if torch.device(device).type == "cuda" else None
    finished = [(b["index"], row, b["prompt_len"]) for b in served
                for row, t in enumerate(b["tokens"])
                if _served_ok(t, int(mix["new_tokens"]), cfg.vocab)]
    picked = traffic.sample(mix, seed, finished)
    requests = [(traffic.batch(mix, cfg.vocab, seed, bi).prompts[row],
                 served[bi]["tokens"][row]) for bi, row, _ in picked]
    t0 = time.perf_counter()
    low = "bf16" if with_look else "fp8"
    read = check.gaps(conf, ref_w, requests, device, lows=(low,),
                      look=with_look)
    ref_s = time.perf_counter() - t0
    out = {"workload": cell["name"], "seed": seed, "serve_s": serve_s,
           "reference_s": ref_s,
           "program": summary([g for r in read for g in r["gaps"]])}
    if with_look:
        out["bf16_products"] = summary([g for r in read for g in r[low]])
        out["look"] = look(read)
    else:
        out["control"] = summary([g for r in read for g in r[low]])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    ap.add_argument("--look", action="store_true",
                    help="the widest gaps beside the router's margins, and "
                         "bf16 products, instead of the control")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    out = open(args.out, "a") if args.out else None
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        r = readings(cell, int(s), "cuda:0", args.look)
        r["seconds"] = time.perf_counter() - t0
        line = json.dumps(r)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
