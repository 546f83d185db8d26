#!/usr/bin/env python
"""Smoke for the port's plan server, `python -m repro_torch serve-plans`.

Boots a real server subprocess on an OS-assigned port, its searches on
``--device`` (default ``cuda``; without a GPU, pass ``--device cpu``),
then asserts the acceptance behaviour of the plan service end to end over
HTTP, as ``scripts/smoke_serve_plans.py`` does for the JAX package's:

1. a cold request searches (``served_from == "search"``);
2. the identical request again replays from the store in bounded time
   (``served_from == "store"``, default bound 100 ms);
3. N concurrent *misses* of one new spec perform exactly one search —
   ``/stats`` reports ``dedup_joins == N-1`` and ``searches`` grew by 1
   (the spec is ResNet-50's, a search of about a second, so that every
   request arrives while it runs: the reference script's 10-layer search
   takes ~13 ms on a CPU, and on a loaded machine later requests then
   miss it and hit the store);
4. every response carries identical result bytes for identical specs, and
   ``/stats`` matches the request history (requests/hits/misses add up);
5. ``GET /metrics`` serves parseable Prometheus text whose per-tier
   request histograms agree with the /stats ledger, and whose counters
   are monotone across scrapes.

Exit 0 on success; nonzero with a diagnostic on any violation.  Usage::

    python scripts/smoke_serve_plans_torch.py [--device cpu] [--hit-budget-ms 100]
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
sys.path.insert(0, str(SRC))

from repro_torch.api import ExploreSpec  # noqa: E402
from repro_torch.api.cli import missing_device  # noqa: E402
from repro_torch.core import HWSpace, Objective  # noqa: E402
from repro_torch.serve.plans import (  # noqa: E402
    fetch_metrics,
    fetch_stats,
    request_plan,
)


def parse_metrics(text: str) -> dict:
    """Parse Prometheus text exposition into {name{labels}: value}."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        try:
            key, raw = line.rsplit(" ", 1)
            out[key] = float(raw)
        except ValueError:
            fail(f"unparseable /metrics line: {line!r}")
    return out


def spec_for(seed: int,
             workload: str = "synthetic:layered:10?seed=4") -> ExploreSpec:
    return ExploreSpec(workload=workload,
                       strategy="greedy",
                       objective=Objective(metric="ema", alpha=None),
                       hw=HWSpace(mode="fixed"),
                       sample_budget=200, seed=seed)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def wait_for_url(port_file: Path, proc: subprocess.Popen,
                 timeout: float = 30.0) -> str:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            fail(f"server exited early with rc={proc.returncode}")
        if port_file.exists():
            url = port_file.read_text().strip()
            if url:
                return url
        time.sleep(0.05)
    fail("server did not write --port-file in time")
    raise AssertionError  # unreachable


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hit-budget-ms", type=float, default=100.0,
                    help="max server-side latency for a store hit")
    ap.add_argument("--dedup-fanout", type=int, default=6)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the server's searches run (default: cuda)")
    args = ap.parse_args(argv)
    if missing_device(args.device):
        return 2

    tmp = Path(tempfile.mkdtemp(prefix="serve-plans-smoke-"))
    port_file = tmp / "url"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch", "--device", args.device,
         "serve-plans",
         "--store-dir", str(tmp / "store"), "--port", "0",
         "--port-file", str(port_file), "--workers", "2"],
        env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        url = wait_for_url(port_file, proc)
        print(f"server up at {url}")

        # 1+2: cold search, then a store hit answered within budget
        cold = request_plan(url, spec_for(seed=0))
        if cold["served_from"] != "search":
            fail(f"cold request served from {cold['served_from']!r}")
        warm = request_plan(url, spec_for(seed=0))
        if warm["served_from"] != "store":
            fail(f"repeat request served from {warm['served_from']!r}")
        if warm["result"] != cold["result"]:
            fail("store replay is not bitwise-identical to the search")
        if warm["latency_ms"] > args.hit_budget_ms:
            fail(f"store hit took {warm['latency_ms']:.1f}ms "
                 f"(> {args.hit_budget_ms:.0f}ms budget)")
        print(f"store hit in {warm['latency_ms']:.1f}ms "
              f"(budget {args.hit_budget_ms:.0f}ms)")

        # 3: concurrent identical misses dedup to one search
        n = args.dedup_fanout
        fresh = spec_for(seed=1, workload="netlib:resnet50")
        with ThreadPoolExecutor(max_workers=n) as pool:
            docs = list(pool.map(lambda _: request_plan(url, fresh),
                                 range(n)))
        if len({json.dumps(d["result"], sort_keys=True)
                for d in docs}) != 1:
            fail("concurrent duplicates returned different results")
        deduped = sum(d["deduped"] for d in docs)
        stats = fetch_stats(url)["server"]
        if stats["searches"] != 2:
            fail(f"expected exactly 2 searches total (cold + fanout), "
                 f"/stats says {stats['searches']}")
        if stats["dedup_joins"] != n - 1 or deduped != n - 1:
            fail(f"expected {n - 1} dedup joins, /stats says "
                 f"{stats['dedup_joins']} (responses flagged {deduped})")
        print(f"dedup fanout: {n} concurrent requests -> 1 search, "
              f"{stats['dedup_joins']} joins")

        # 4: the ledger adds up
        if stats["requests"] != 2 + n:
            fail(f"/stats requests={stats['requests']}, expected {2 + n}")
        if stats["store_hits"] < 1 or stats["errors"] != 0:
            fail(f"unexpected /stats counters: {stats}")
        # 5: /metrics agrees with /stats and is monotone across scrapes
        m1 = parse_metrics(fetch_metrics(url))
        if m1["repro_plan_requests_total"] != stats["requests"]:
            fail(f"/metrics requests_total={m1['repro_plan_requests_total']}"
                 f" != /stats requests={stats['requests']}")
        # the search-tier histogram counts *responses* served by the
        # search path (dedup joiners included), not searches executed
        n_search_served = (stats["requests"] - stats["store_hits"]
                           - stats["zoo_hits"])
        for tier, want in (("store", stats["store_hits"]),
                           ("search", n_search_served)):
            got = m1[f'repro_plan_request_latency_seconds_count'
                     f'{{tier="{tier}"}}']
            if got != want:
                fail(f"/metrics latency histogram count for {tier!r} is "
                     f"{got}, /stats says {want}")
        extra = request_plan(url, spec_for(seed=0))
        if extra["served_from"] != "store":
            fail("warm re-request no longer hits the store")
        m2 = parse_metrics(fetch_metrics(url))
        regressed = [k for k, v in m1.items()
                     if "_total" in k or "_count" in k or "_bucket" in k
                     if m2.get(k, -1) < v]
        if regressed:
            fail(f"/metrics counters went backwards: {regressed}")
        if m2["repro_plan_requests_total"] != m1[
                "repro_plan_requests_total"] + 1:
            fail("requests_total did not advance across scrapes")
        print(f"metrics OK: {len(m1)} samples, counters monotone")

        print("smoke OK:", json.dumps({k: stats[k] for k in
              ("requests", "searches", "store_hits", "dedup_joins")}))
        return 0
    finally:
        proc.terminate()
        try:
            out = proc.communicate(timeout=10)[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            out = proc.communicate()[0]
        if out:
            print("--- server log ---")
            print(out, end="")
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
