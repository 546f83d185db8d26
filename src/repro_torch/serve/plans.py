"""Planning-as-a-service: a concurrent plan server over the result store.

``python -m repro_torch serve-plans`` turns the one-shot spec→strategy→result
pipeline into a long-running service: clients POST an :class:`ExploreSpec`
as JSON and get back the archived (or freshly searched) `ExploreResult`.
The serving stack is three read-through tiers:

1. **zoo** — an optional read-only directory of precomputed artifacts
   (``python -m repro_torch zoo build``); common requests never search.
2. **store** — the read-write spec-addressed :class:`ResultStore`; every
   search is published here, so a repeated request replays in milliseconds.
3. **search** — a bounded worker pool running the actual strategy, with
   per-spec **in-flight deduplication** (N concurrent identical requests
   share one search; the other N-1 "join" the winner's future) and **warm
   evaluator reuse** (requests for the same workload fingerprint share one
   :class:`CachedEvaluator`, so repeat searches start cache-hot).

Cross-process safety comes from :meth:`ResultStore.exclusive`: a search
first takes the per-key lockfile, re-checks the store (another process may
have won), and only then searches — so N identical requests across threads
*and* processes perform exactly one search.  All counters (hits, misses,
dedup joins, per-tier latency) are exposed at ``GET /stats`` (JSON) and
``GET /metrics`` (Prometheus text exposition; per-tier latency
histograms from :mod:`repro_torch.obs.metrics`).

Protocol (JSON over HTTP, stdlib ``ThreadingHTTPServer`` — no new deps):

* ``POST /plan`` — body is an ``ExploreSpec`` JSON document (the exact
  ``ExploreSpec.to_dict()`` format; ``--save-spec`` writes one).  Response:
  ``{"ok": true, "key": <spec key>, "served_from": "zoo"|"store"|"search",
  "deduped": bool, "latency_ms": float, "result": <ExploreResult dict>}``.
  Malformed specs get ``400 {"ok": false, "error": ...}``; search failures
  get ``500``.
* ``GET /stats`` — server + store + zoo counters (schema in
  ``docs/serving.md``).
* ``GET /metrics`` — the same counters as Prometheus text format 0.0.4
  (reference table in ``docs/observability.md``).
* ``GET /healthz`` — liveness probe, ``{"ok": true}``.

See ``docs/serving.md`` for the full protocol and the zoo layout.
"""

from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple
from urllib import request as _urlrequest

from repro_torch.api.result import ExploreResult
from repro_torch.api.spec import ExploreSpec
from repro_torch.api.store import ResultStore, graph_fingerprint, spec_key
from repro_torch.api.strategies import run
from repro_torch.api.workloads import build_workload, workload_is_stable
from repro_torch.obs.metrics import Histogram, render_metrics

PROTOCOL_VERSION = 1

Searcher = Callable[[ExploreSpec], ExploreResult]


# ---------------------------------------------------------------------------
# tiered resolution (also the cross-process building block: the zoo builder
# and the multi-process hammer tests call this directly, no HTTP involved)
# ---------------------------------------------------------------------------

def _validated_get(tier: Optional[ResultStore],
                   spec: ExploreSpec) -> Optional[ExploreResult]:
    """A store hit, with the fingerprint revalidation :func:`repro_torch.api.run`
    applies: a non-stable workload URI (``file:`` — the file can change
    under an unchanged URI) is re-resolved and its graph digest checked
    before the artifact replays."""
    if tier is None:
        return None
    cached = tier.get(spec)
    if cached is None:
        return None
    if not workload_is_stable(spec.workload):
        g = build_workload(spec.workload)
        if cached.meta.get("graph_sha") not in (None, graph_fingerprint(g)):
            return None
    return cached


def resolve_plan(spec: ExploreSpec,
                 store: Optional[ResultStore] = None,
                 zoo: Optional[ResultStore] = None,
                 searcher: Optional[Searcher] = None,
                 lock_timeout: Optional[float] = None,
                 device: str = "cuda",
                 ) -> Tuple[ExploreResult, str]:
    """Resolve one spec through the zoo → store → search tiers.

    The default ``searcher`` is :func:`repro_torch.api.run` on ``device``
    (``"cuda"``, the default, or ``"cpu"``).  Returns ``(result,
    served_from)`` with ``served_from`` one of ``"zoo"``, ``"store"``,
    ``"search"``.  The search path holds the store's per-key
    cross-process lock and re-checks the store inside it, so concurrent
    resolvers of the same spec — in any number of processes — perform
    exactly one search; the losers replay the winner's artifact.
    """
    search = searcher if searcher is not None else (
        lambda s: run(s, device=device))
    hit = _validated_get(zoo, spec)
    if hit is not None:
        return hit, "zoo"
    if store is None:
        return search(spec), "search"
    hit = _validated_get(store, spec)
    if hit is not None:
        return hit, "store"
    with store.exclusive(spec, timeout=lock_timeout):
        hit = _validated_get(store, spec)
        if hit is not None:
            return hit, "store"         # another process searched first
        res = search(spec)
        store.put(spec, res)
    return res, "search"


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------

@dataclass
class PlanResponse:
    """One fulfilled ``/plan`` request."""

    result: ExploreResult
    key: str
    served_from: str        # "zoo" | "store" | "search"
    deduped: bool
    latency_ms: float

    def to_dict(self) -> Dict[str, Any]:
        return {
            "key": self.key,
            "served_from": self.served_from,
            "deduped": self.deduped,
            "latency_ms": round(self.latency_ms, 3),
            "result": self.result.to_dict(),
        }


class _WarmEvaluator:
    """One cached evaluator + the mutex serializing searches through it
    (CachedEvaluator's run-scope bookkeeping is not reentrant across
    threads; different workloads still search fully in parallel)."""

    def __init__(self, ev) -> None:
        self.ev = ev
        self.lock = threading.Lock()


class PlanService:
    """The transport-independent core of the plan server.

    ``plan(spec)`` blocks until the spec is served: hits return synchronously
    from the zoo/store tiers, misses are funneled through a bounded
    ``ThreadPoolExecutor`` with in-flight request deduplication.  The HTTP
    layer (:class:`PlanServer`) is a thin shell over this class, which is
    also usable fully in-process (tests).  Searches evaluate on
    ``eval_backend`` (default ``torch``) placed on ``device`` (``"cuda"``,
    the default, or ``"cpu"``).
    """

    def __init__(self, store: ResultStore,
                 zoo: Optional[ResultStore] = None,
                 workers: int = 2,
                 eval_backend: Optional[str] = None,
                 eval_jobs: int = 1,
                 max_warm_evaluators: int = 8,
                 lock_timeout: Optional[float] = None,
                 device: str = "cuda") -> None:
        self.store = store
        self.zoo = zoo
        self.workers = max(1, workers)
        self.eval_backend = eval_backend
        self.eval_jobs = eval_jobs
        self.device = device
        self.max_warm_evaluators = max(1, max_warm_evaluators)
        self.lock_timeout = lock_timeout
        self.started = time.time()
        self._pool = ThreadPoolExecutor(
            max_workers=self.workers, thread_name_prefix="plan-search")
        self._lock = threading.Lock()
        self._inflight: Dict[str, Future] = {}
        self._evaluators: "OrderedDict[Tuple[str, int], _WarmEvaluator]" = \
            OrderedDict()
        self._closed = False
        # counters (all mutated under self._lock)
        self.requests = 0
        self.searches = 0
        self.store_hits = 0
        self.zoo_hits = 0
        self.dedup_joins = 0
        self.errors = 0
        # per-tier cumulative latency histograms (seconds, repro_torch.obs) —
        # they replace the old sliding _LatencyWindow, so quantiles no
        # longer forget samples past a 512-entry deque
        self._latency = {tier: Histogram()
                         for tier in ("zoo", "store", "search")}

    # -- request path -----------------------------------------------------
    def plan(self, spec: ExploreSpec) -> PlanResponse:
        """Serve one spec (blocking).  Thread-safe: this is what each HTTP
        handler thread calls."""
        if self._closed:
            raise RuntimeError("PlanService is closed")
        t0 = time.perf_counter()
        key = spec_key(spec)
        with self._lock:
            self.requests += 1
        # fast path: zoo/store hits answer synchronously (milliseconds, even
        # while every pool worker is busy searching something else)
        hit = self._lookup(spec)
        if hit is not None:
            result, source = hit
            return self._done(result, key, source, False, t0)
        with self._lock:
            fut = self._inflight.get(key)
            deduped = fut is not None
            if deduped:
                self.dedup_joins += 1
            else:
                fut = self._pool.submit(self._fulfil, spec, key)
                self._inflight[key] = fut
        try:
            result, source = fut.result()
        except Exception:
            with self._lock:
                self.errors += 1
            raise
        return self._done(result, key, source, deduped, t0)

    def _lookup(self, spec: ExploreSpec
                ) -> Optional[Tuple[ExploreResult, str]]:
        hit = _validated_get(self.zoo, spec)
        if hit is not None:
            return hit, "zoo"
        hit = _validated_get(self.store, spec)
        if hit is not None:
            return hit, "store"
        return None

    def _fulfil(self, spec: ExploreSpec,
                key: str) -> Tuple[ExploreResult, str]:
        """Pool worker: tiered resolve under the cross-process lock, with a
        warm evaluator for the spec's workload."""
        try:
            return resolve_plan(spec, store=self.store, zoo=self.zoo,
                                searcher=self._search,
                                lock_timeout=self.lock_timeout)
        finally:
            with self._lock:
                self._inflight.pop(key, None)

    def _search(self, spec: ExploreSpec) -> ExploreResult:
        g = build_workload(spec.workload)
        warm = self._warm_evaluator(g, spec.out_tile)
        with warm.lock:
            res = run(spec, graph=g, ev=warm.ev)
        with self._lock:
            self.searches += 1
        return res

    def _warm_evaluator(self, g, out_tile: int) -> _WarmEvaluator:
        from repro_torch.core.cost import CachedEvaluator
        from repro_torch.core.engine import make_executor

        key = (graph_fingerprint(g), out_tile)
        with self._lock:
            warm = self._evaluators.get(key)
            if warm is None:
                warm = _WarmEvaluator(CachedEvaluator(
                    g, out_tile=out_tile,
                    executor=make_executor(self.eval_backend,
                                           self.eval_jobs, self.device)))
                self._evaluators[key] = warm
            self._evaluators.move_to_end(key)
            # LRU-evict cold evaluators (skip any mid-search: its searcher
            # holds the warm lock and will simply be dropped next time)
            while len(self._evaluators) > self.max_warm_evaluators:
                for k in list(self._evaluators):
                    if k != key and not self._evaluators[k].lock.locked():
                        self._evaluators.pop(k).ev.close()
                        break
                else:
                    break
        return warm

    def _done(self, result: ExploreResult, key: str, source: str,
              deduped: bool, t0: float) -> PlanResponse:
        dt = time.perf_counter() - t0
        with self._lock:
            if source == "zoo":
                self.zoo_hits += 1
            elif source == "store":
                self.store_hits += 1
            self._latency[source].observe(dt)
        return PlanResponse(result=result, key=key, served_from=source,
                            deduped=deduped, latency_ms=dt * 1e3)

    # -- introspection ----------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """The ``GET /stats`` document (schema: ``docs/serving.md``)."""
        with self._lock:
            server = {
                "version": PROTOCOL_VERSION,
                "uptime_s": round(time.time() - self.started, 3),
                "workers": self.workers,
                "requests": self.requests,
                "searches": self.searches,
                "store_hits": self.store_hits,
                "zoo_hits": self.zoo_hits,
                "dedup_joins": self.dedup_joins,
                "errors": self.errors,
                "in_flight": len(self._inflight),
                "warm_evaluators": len(self._evaluators),
                "latency_ms": {tier: h.snapshot_ms()
                               for tier, h in self._latency.items()},
            }
        return {
            "ok": True,
            "server": server,
            "store": self.store.counters(),
            "zoo": self.zoo.counters() if self.zoo is not None else None,
        }

    def metrics_text(self) -> str:
        """The ``GET /metrics`` document: Prometheus text format 0.0.4.

        Same counters as :meth:`stats`, but in the standard exposition
        so any Prometheus-compatible scraper can poll the server; the
        per-tier latency *histograms* carry the full distribution (the
        JSON view only shows interpolated p50/p95).
        """
        # store counters walk the artifact directory — gather them before
        # taking the service lock
        tiers: List[Tuple[str, ResultStore]] = [("store", self.store)]
        if self.zoo is not None:
            tiers.append(("zoo", self.zoo))
        store_counts = [(name, st.counters()) for name, st in tiers]
        with self._lock:
            lab = lambda tier: {"tier": tier}
            served: List[Tuple[Optional[Mapping[str, str]], object]] = [
                (lab("zoo"), self.zoo_hits),
                (lab("store"), self.store_hits),
                (lab("search"), self.searches),
            ]
            families = [
                ("repro_plan_requests_total", "counter",
                 "Plan requests received.", [(None, self.requests)]),
                ("repro_plan_served_total", "counter",
                 "Plan responses by serving tier.", served),
                ("repro_plan_request_latency_seconds", "histogram",
                 "Plan request latency by serving tier.",
                 [(lab(t), h) for t, h in self._latency.items()]),
                ("repro_plan_dedup_joins_total", "counter",
                 "Requests that joined an in-flight identical search.",
                 [(None, self.dedup_joins)]),
                ("repro_plan_errors_total", "counter",
                 "Plan requests that raised.", [(None, self.errors)]),
                ("repro_plan_inflight_searches", "gauge",
                 "Searches currently in flight (dedup table size).",
                 [(None, len(self._inflight))]),
                ("repro_plan_warm_evaluators", "gauge",
                 "Warm evaluators resident in the LRU.",
                 [(None, len(self._evaluators))]),
                ("repro_plan_warm_evaluators_limit", "gauge",
                 "Warm-evaluator LRU capacity.",
                 [(None, self.max_warm_evaluators)]),
                ("repro_plan_workers", "gauge",
                 "Search worker pool size.", [(None, self.workers)]),
                ("repro_plan_uptime_seconds", "gauge",
                 "Seconds since the service started.",
                 [(None, round(time.time() - self.started, 3))]),
            ]
            for metric, mtype, help_text in (
                    ("repro_store_hits_total", "counter", "Store hits."),
                    ("repro_store_misses_total", "counter",
                     "Store misses."),
                    ("repro_store_writes_total", "counter",
                     "Store writes."),
                    ("repro_store_quarantined_total", "counter",
                     "Artifacts quarantined on load."),
                    ("repro_store_entries", "gauge",
                     "Artifacts currently in the store."),
                    ("repro_store_bytes", "gauge",
                     "Bytes of artifacts currently in the store."),
            ):
                key = metric.replace("repro_store_", "").replace(
                    "_total", "")
                families.append((metric, mtype, help_text, [
                    (lab(name), counts[key])
                    for name, counts in store_counts]))
            return render_metrics(families)

    def close(self) -> None:
        self._closed = True
        self._pool.shutdown(wait=True)
        with self._lock:
            evs, self._evaluators = list(self._evaluators.values()), \
                OrderedDict()
        for warm in evs:
            warm.ev.close()


# ---------------------------------------------------------------------------
# HTTP shell
# ---------------------------------------------------------------------------

class _PlanRequestHandler(BaseHTTPRequestHandler):
    server_version = f"repro-serve-plans/{PROTOCOL_VERSION}"
    protocol_version = "HTTP/1.1"

    @property
    def service(self) -> PlanService:
        return self.server.service            # type: ignore[attr-defined]

    def log_message(self, fmt: str, *args) -> None:
        if not getattr(self.server, "quiet", True):
            BaseHTTPRequestHandler.log_message(self, fmt, *args)

    def _send(self, code: int, doc: Dict[str, Any]) -> None:
        payload = json.dumps(doc).encode()
        self._send_raw(code, payload, "application/json")

    def _send_raw(self, code: int, payload: bytes,
                  content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self) -> None:                                   # noqa: N802
        path = self.path.rstrip("/") or "/"
        if path == "/stats":
            self._send(200, self.service.stats())
        elif path == "/metrics":
            self._send_raw(200, self.service.metrics_text().encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/healthz":
            self._send(200, {"ok": True})
        elif path == "/":
            self._send(200, {
                "ok": True,
                "service": "repro-serve-plans",
                "version": PROTOCOL_VERSION,
                "endpoints": {
                    "POST /plan": "body: ExploreSpec JSON -> "
                                  "{ok, key, served_from, deduped, "
                                  "latency_ms, result}",
                    "GET /stats": "server + store + zoo counters",
                    "GET /metrics": "Prometheus text-format counters",
                    "GET /healthz": "liveness probe",
                },
            })
        else:
            self._send(404, {"ok": False, "error": f"no route {self.path}"})

    def do_POST(self) -> None:                                  # noqa: N802
        if self.path.rstrip("/") != "/plan":
            self._send(404, {"ok": False, "error": f"no route {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length") or 0)
            spec = ExploreSpec.from_json(
                self.rfile.read(length).decode("utf-8"))
        except (ValueError, KeyError, TypeError, UnicodeDecodeError) as err:
            self._send(400, {"ok": False, "error": f"bad spec: {err}"})
            return
        try:
            resp = self.service.plan(spec)
        except Exception as err:        # search/store failure -> 500
            self._send(500, {"ok": False,
                             "error": f"{type(err).__name__}: {err}"})
            return
        self._send(200, {"ok": True, **resp.to_dict()})


class PlanServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` bound to a :class:`PlanService`.

    Bind with port 0 to let the OS pick; ``server_address`` then reports
    the real port.  ``daemon_threads`` so a hung client cannot block
    shutdown.
    """

    daemon_threads = True

    def __init__(self, address: Tuple[str, int], service: PlanService,
                 quiet: bool = True) -> None:
        super().__init__(address, _PlanRequestHandler)
        self.service = service
        self.quiet = quiet

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}"

    def close(self) -> None:
        self.shutdown()
        self.server_close()
        self.service.close()


def serve_in_thread(service: PlanService, host: str = "127.0.0.1",
                    port: int = 0) -> PlanServer:
    """Start a :class:`PlanServer` on a daemon thread (tests, examples)."""
    server = PlanServer((host, port), service)
    thread = threading.Thread(target=server.serve_forever,
                              name="plan-server", daemon=True)
    thread.start()
    return server


# ---------------------------------------------------------------------------
# client helpers (stdlib urllib; used by the CLI, CI smoke, and examples)
# ---------------------------------------------------------------------------

def request_plan(url: str, spec: ExploreSpec,
                 timeout: float = 600.0) -> Dict[str, Any]:
    """POST ``spec`` to a running plan server; returns the response doc
    (with ``result`` left as a plain dict — ``ExploreResult.from_dict`` it
    if you need the object)."""
    req = _urlrequest.Request(
        url.rstrip("/") + "/plan",
        data=spec.to_json().encode(),
        headers={"Content-Type": "application/json"},
        method="POST")
    with _urlrequest.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def fetch_stats(url: str, timeout: float = 30.0) -> Dict[str, Any]:
    """GET a running plan server's ``/stats`` document."""
    with _urlrequest.urlopen(url.rstrip("/") + "/stats",
                             timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def fetch_metrics(url: str, timeout: float = 30.0) -> str:
    """GET a running plan server's ``/metrics`` text exposition."""
    with _urlrequest.urlopen(url.rstrip("/") + "/metrics",
                             timeout=timeout) as resp:
        return resp.read().decode()
