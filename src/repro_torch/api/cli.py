"""``python -m repro_torch`` — run explorations from the command line.

Subcommands:

* ``explore``   — run one strategy on one workload; print the summary and
                  optionally write the spec/result as JSON artifacts.
* ``compare``   — run several strategies on the same spec (one shared cost
                  evaluator, optionally ``--jobs N`` worker processes) and
                  print a ranked table.
* ``trace``     — search a plan (or load one with ``--plan``), execute it on
                  the time-stepped trace simulator (:mod:`repro_torch.sim`),
                  print the bandwidth profile + analytical/simulated
                  cross-validation, and optionally export the trace JSON.
* ``workloads`` — ``ls`` every resolvable workload URI (scheme registry:
                  ``netlib:`` / ``tpu:`` / ``synthetic:`` / ``file:``);
                  ``--json`` emits a machine-readable listing for tooling.
* ``store``     — ``ls`` the spec-addressed result store (``--json`` for a
                  machine-readable listing), or ``gc`` it down to a byte cap
                  (LRU by artifact mtime).
* ``serve-plans`` — long-running HTTP plan server over a result store
                  (``POST /plan`` with an ExploreSpec JSON body; hits replay
                  in milliseconds, misses search once with in-flight
                  deduplication).  ``--stats`` / ``--request`` are the
                  client modes.  See ``docs/serving.md``.
* ``zoo``       — ``build`` the precomputed plan zoo (resumable grid sweep
                  into a store directory), ``ls`` grid coverage, ``verify``
                  replay integrity of every artifact.
* ``plan-h100`` — Cocco as the H100's execution planner: one block of each
                  bundled architecture searched under the card's on-chip
                  buffer (:mod:`repro_torch.core.h100_adapter`), one
                  summary line each.  (The JAX package's ``plan-tpu`` has
                  no counterpart: asking for it exits 2.)

``--workload`` takes a URI (a bare name is ``netlib:<name>``): e.g.
``netlib:resnet50``, ``tpu:gemma3-4b:0?tokens=4096``,
``synthetic:layered:24?seed=7``, ``file:my_net.json``.

``--device`` (before the subcommand) is ``cuda`` (the default) or ``cpu``.
With ``cuda`` and no GPU, ``explore``, ``compare``, ``trace``, ``zoo
build``, ``plan-h100`` and the ``serve-plans`` server print ``error: ...`` and exit 2;
they never carry on on the CPU.  ``--eval-backend`` picks the
evaluation-engine executor (``repro_torch.core.engine``: ``serial`` |
``process`` | ``vector`` | ``torch``; default ``torch``): ``torch``
batches whole GA generations through the CUDA kernel on ``--device cuda``.
``--eval-jobs`` sizes the ``process`` backend's pool and is refused with
any other backend.  Every backend returns bit-identical results, so they
are pure runtime knobs.

``--store-dir`` (or ``$REPRO_STORE_DIR``) points ``explore``, ``compare``
and ``trace`` at a spec-addressed result store, in the same format and
under the same keys as the JAX package's, so a store (or a zoo) written by
either replays in the other.  ``explore --profile`` prints where the
search spent its time and the structure-cache counters;
``--struct-cache-dir`` (or ``$REPRO_STRUCT_CACHE_DIR``) adds a disk-backed
warm cache of canonical subgraph structures.

Examples::

    python -m repro_torch explore --workload resnet50 --strategy ga \
        --metric energy --alpha 0.002 --hw-mode shared --budget 4000
    python -m repro_torch --device cpu compare \
        --workload "synthetic:layered:24?seed=7" --strategies greedy,dp,ga
    python -m repro_torch workloads ls --json
    python -m repro_torch explore --workload "tpu:gemma3-4b:0?tokens=4096" \
        --strategy ga --budget 2000
    python -m repro_torch trace "synthetic:layered:24?seed=7" \
        --strategy greedy --out runs/trace.json
    python -m repro_torch store gc --store-dir runs/store --max-bytes 100000000
    python -m repro_torch zoo build --zoo-dir runs/zoo --budget 2000
    python -m repro_torch serve-plans --store-dir runs/store --zoo-dir runs/zoo
    python -m repro_torch serve-plans --stats --url http://127.0.0.1:8787
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import replace
from typing import Any, Dict, List, Optional

from repro_torch.core.cost import METRICS
from repro_torch.core.ga import HWSpace, Objective

from .registry import list_strategies, options_class_for
from .result import ExploreResult
from .spec import ExploreSpec
from .store import ResultStore
from .strategies import compare, plan_h100, run


def _parse_opt_overrides(pairs: List[str]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"--opt expects KEY=VALUE, got {pair!r}")
        key, raw = pair.split("=", 1)
        try:
            out[key] = json.loads(raw)
        except json.JSONDecodeError:
            out[key] = raw
    return out


def _apply_seed_from_store(args: argparse.Namespace,
                           spec: ExploreSpec) -> ExploreSpec:
    """Resolve ``--seed-from-store KEY`` prefixes against the store and
    inject them as ``options.seed_from_keys`` (GA warm-starting from
    archived reduced-budget results)."""
    prefixes = getattr(args, "seed_from_store", None) or []
    if not prefixes:
        return spec
    if args.spec:
        raise SystemExit(
            "--seed-from-store cannot be combined with --spec; set "
            "options.seed_from_keys inside the spec file instead")
    if spec.options is None or not hasattr(spec.options, "seed_from_keys"):
        raise SystemExit(
            "--seed-from-store needs a strategy that supports "
            f"seed_from_keys (ga), not {spec.strategy!r}")
    store = _store_from_args(args)
    if store is None:
        raise SystemExit(
            "--seed-from-store resolves keys against a store: pass "
            "--store-dir (or set $REPRO_STORE_DIR), without --no-store")
    keys = tuple(k if len(k) == 64 else store.resolve_key(k)
                 for k in prefixes)
    return replace(spec, options=replace(spec.options,
                                         seed_from_keys=keys))


def _spec_from_args(args: argparse.Namespace) -> ExploreSpec:
    if args.spec:
        with open(args.spec) as f:
            return _apply_seed_from_store(
                args, ExploreSpec.from_json(f.read()))
    if not args.workload:
        raise SystemExit("either --spec or --workload is required")
    opts_cls = options_class_for(args.strategy)
    if opts_cls is None:
        raise SystemExit(
            f"unknown strategy {args.strategy!r}; "
            f"registered: {', '.join(list_strategies())}")
    options = opts_cls(**_parse_opt_overrides(args.opt))
    cores = getattr(args, "cores", None)
    try:
        core_candidates = tuple(
            int(c) for c in cores.split(",") if c.strip()) if cores else ()
    except ValueError:
        raise SystemExit(f"--cores expects comma-separated integers, "
                         f"got {cores!r}")
    spec = ExploreSpec(
        workload=args.workload,
        strategy=args.strategy,
        objective=Objective(metric=args.metric, alpha=args.alpha),
        hw=HWSpace(mode=args.hw_mode, core_candidates=core_candidates),
        sample_budget=args.budget,
        seed=args.seed,
        out_tile=args.out_tile,
        options=options,
    )
    return _apply_seed_from_store(args, spec)


def _write_file(path: str, payload: str) -> None:
    """Write an artifact, creating parent directories (the documented
    quickstarts use paths like runs/trace.json on fresh checkouts)."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        f.write(payload)


def _maybe_save(path: Optional[str], payload: str) -> None:
    if path:
        _write_file(path, payload)


def _store_from_args(args: argparse.Namespace) -> Optional[ResultStore]:
    """Resolve --store-dir / --no-store / $REPRO_STORE_DIR to a store."""
    if args.no_store:
        return None
    store_dir = args.store_dir or os.environ.get("REPRO_STORE_DIR")
    return ResultStore(store_dir) if store_dir else None


def _result_row(res: ExploreResult) -> Dict[str, str]:
    plan = res.plan
    return {
        "strategy": res.strategy,
        "cost": f"{res.cost:.4g}",
        "EMA_MB": f"{plan.ema_total/1e6:.2f}" if plan else "-",
        "energy_mJ": f"{plan.energy_pj/1e9:.3f}" if plan else "-",
        "subgraphs": str(res.n_subgraphs),
        "samples": str(res.samples),
        "evals": str(res.evaluations),
    }


def _print_table(rows: List[Dict[str, str]]) -> None:
    cols = ["rank"] + list(rows[0].keys()) if rows else []
    table = [dict(rank=str(i + 1), **r) for i, r in enumerate(rows)]
    widths = {c: max(len(c), *(len(r[c]) for r in table)) for c in cols}
    print("  ".join(c.ljust(widths[c]) for c in cols))
    for r in table:
        print("  ".join(r[c].ljust(widths[c]) for c in cols))


def _print_profile(res: ExploreResult) -> None:
    prof = res.meta.get("profile")
    if prof is None:
        print("  profile: store hit — no search ran")
        return
    wall = prof.get("wall_s", 0.0)
    derive = prof.get("structure_derive_s", 0.0)
    pct = 100.0 * derive / wall if wall > 0 else 0.0
    canon = "on" if prof.get("canonical") else "off"
    print(f"  profile: wall {wall:.2f}s, derive_schedule {derive:.2f}s "
          f"({pct:.0f}% of wall) over {prof.get('structure_misses', 0)} "
          f"structure misses (canonical memo {canon})")
    disk = ""
    if "structure_disk_writes" in prof:
        disk = (f", {prof.get('structure_disk_hits', 0)} disk hits / "
                f"{prof['structure_disk_writes']} writes")
    print(f"           structure hits: "
          f"{prof.get('structure_raw_hits', 0)} raw, "
          f"{prof.get('structure_canon_hits', 0)} canonical{disk}; "
          f"{prof.get('evaluations', 0)} cost evals / "
          f"{prof.get('lookups', 0)} lookups")


def _require_device(device: str) -> None:
    """Raise ``RuntimeError`` (``error: ...``, exit 2 from :func:`main`)
    when ``device`` is ``cuda`` and there is no GPU: a command that
    evaluates on the card never carries on on the CPU."""
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                "--device cuda needs a CUDA GPU and none is available; "
                "pass --device cpu to run on the CPU")


def _eval_kwargs(args: argparse.Namespace) -> Dict[str, Any]:
    """The evaluation-engine knobs ``run``/``compare`` take from the CLI."""
    return dict(eval_backend=args.eval_backend or "torch",
                eval_jobs=args.eval_jobs,
                struct_cache_dir=args.struct_cache_dir, device=args.device)


def cmd_explore(args: argparse.Namespace) -> int:
    spec = _spec_from_args(args)
    _maybe_save(args.save_spec, spec.to_json(indent=2))
    store = _store_from_args(args)
    rec = None
    if args.telemetry:
        from repro_torch.obs import Recorder, recording

        rec = Recorder()
        with recording(rec):
            res = run(spec, store=store, profile=args.profile,
                      **_eval_kwargs(args))
    else:
        res = run(spec, store=store, profile=args.profile,
                  **_eval_kwargs(args))
    print(res.summary())
    if rec is not None:
        from repro_torch.obs import (
            chrome_trace_doc,
            recorder_events,
            write_chrome_trace,
        )

        doc = chrome_trace_doc(
            recorder_events(rec), counters=rec.counters,
            meta={"kind": "search", "workload": spec.workload,
                  "strategy": spec.strategy, "seed": spec.seed})
        write_chrome_trace(args.telemetry, doc)
        print(f"  telemetry written to {args.telemetry} "
              f"({len(rec.spans)} spans; open in ui.perfetto.dev)")
    if res.history:
        print(f"  converged: cost {res.history[0][1]:.4g} -> "
              f"{res.history[-1][1]:.4g} over {res.samples} samples "
              f"({res.evaluations} cost-model evals)")
    if args.profile:
        _print_profile(res)
    if store is not None:
        print(f"  {store.stats()}")
    _maybe_save(args.out, res.to_json(indent=2))
    if args.out:
        print(f"  result written to {args.out}")
    return 0


def cmd_compare(args: argparse.Namespace) -> int:
    spec = _spec_from_args(args)
    _maybe_save(args.save_spec, spec.to_json(indent=2))
    names = [s.strip() for s in args.strategies.split(",") if s.strip()]
    if not names:
        raise SystemExit("--strategies needs at least one strategy name")
    store = _store_from_args(args)
    results = compare(spec, names, jobs=args.jobs, store=store,
                      **_eval_kwargs(args))
    ranked = sorted(results, key=lambda r: r.cost)
    _print_table([_result_row(r) for r in ranked])
    best = ranked[0]
    print(f"\nbest: {best.summary()}")
    if store is not None:
        print(store.stats())
    _maybe_save(args.out,
                json.dumps([r.to_dict() for r in ranked], indent=2))
    return 0


def _store_for_maintenance(args: argparse.Namespace) -> ResultStore:
    store_dir = args.store_dir or os.environ.get("REPRO_STORE_DIR")
    if not store_dir:
        raise SystemExit(
            "store maintenance needs --store-dir (or $REPRO_STORE_DIR)")
    return ResultStore(store_dir)


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024 or unit == "GB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GB"


def cmd_store_ls(args: argparse.Namespace) -> int:
    import datetime

    store = _store_for_maintenance(args)
    entries = store.entries()
    total = sum(e.size for e in entries)
    if args.json:
        # machine-readable contract for tooling: full keys, raw sizes and
        # mtimes, LRU order (oldest first) — same rows `store gc` walks
        doc = {
            "root": str(store.root),
            "count": len(entries),
            "total_bytes": total,
            "entries": [{
                "key": e.key,
                "workload": e.workload or None,
                "strategy": e.strategy or None,
                "size": e.size,
                "mtime": e.mtime,
            } for e in entries],
        }
        print(json.dumps(doc, indent=2, sort_keys=True))
        return 0
    rows = [{
        "key": e.key[:16],
        "workload": e.workload or "?",
        "strategy": e.strategy or "?",
        "size": _fmt_bytes(e.size),
        "mtime": datetime.datetime.fromtimestamp(e.mtime)
                 .strftime("%Y-%m-%d %H:%M:%S"),
    } for e in entries]
    if rows:
        _print_table(rows)
    print(f"\n{len(entries)} entries, {_fmt_bytes(total)} in {store.root}")
    return 0


def cmd_store_gc(args: argparse.Namespace) -> int:
    store = _store_for_maintenance(args)
    removed, freed = store.gc(args.max_bytes)
    print(f"store[{store.root}]: evicted {removed} entries "
          f"({_fmt_bytes(freed)}), {_fmt_bytes(store.total_bytes())} of "
          f"{_fmt_bytes(args.max_bytes)} cap in use")
    return 0


def cmd_workloads_ls(args: argparse.Namespace) -> int:
    from .workloads import list_workloads, workload_schemes

    if args.json:
        # machine-readable contract for tooling: every "workloads" entry is
        # a concrete URI the resolver accepts (templates never appear here)
        doc = {
            "schemes": [{
                "name": s.name,
                "syntax": s.syntax,
                "description": s.description,
                "stable": s.stable,
            } for s in workload_schemes()
                if args.scheme in (None, s.name)],
            "workloads": [{
                "uri": uri,
                "scheme": uri.split(":", 1)[0],
                "description": note,
            } for uri, note in list_workloads(args.scheme, concrete=True)],
        }
        print(json.dumps(doc, indent=2, sort_keys=True))
        return 0
    # --uris-only is the script-friendly contract: every printed line is a
    # concrete URI that `explore --workload <line>` resolves; the default
    # view may show compact templates (tpu:<arch>:0..N) alongside the table
    rows = list_workloads(args.scheme, concrete=args.uris_only)
    if not args.uris_only:
        _print_table([{
            "scheme": s.name,
            "syntax": s.syntax,
            "description": s.description,
        } for s in workload_schemes()])
        print()
    for uri, _note in rows:
        print(uri)
    return 0


def cmd_trace(args: argparse.Namespace) -> int:
    from repro_torch.sim import cross_validate_trace, simulate_plan

    from .workloads import build_workload

    if getattr(args, "uri", None):
        if args.workload and args.workload != args.uri:
            raise SystemExit(
                f"trace: conflicting workloads {args.uri!r} (positional) "
                f"and {args.workload!r} (--workload); pass one")
        args.workload = args.uri
    if args.plan:
        if args.workload or args.spec:
            raise SystemExit(
                "trace: --plan replays an archived result (with its own "
                "workload); it cannot be combined with a workload URI or "
                "--spec")
        with open(args.plan) as f:
            res = ExploreResult.from_json(f.read())
        workload, strategy = res.workload, res.strategy
        seed = res.spec.seed if res.spec else 0
        out_tile = res.spec.out_tile if res.spec else 1
    else:
        spec = _spec_from_args(args)
        store = _store_from_args(args)
        res = run(spec, store=store, **_eval_kwargs(args))
        workload, strategy = spec.workload, spec.strategy
        seed, out_tile = spec.seed, spec.out_tile
    if not res.groups or res.plan is None:
        raise RuntimeError(
            f"{workload}[{strategy}] found no feasible plan to trace")
    g = build_workload(workload)
    trace = simulate_plan(g, res.groups, res.acc, out_tile=out_tile,
                          steps_per_subgraph=args.steps_per_subgraph)
    report = cross_validate_trace(trace, res.plan)
    prof = trace.bandwidth_profile()
    print(f"{workload}[{strategy}]: {len(res.groups)} subgraphs, "
          f"{len(trace.steps)} trace steps over "
          f"{trace.total_cycles:.0f} cycles")
    print(f"  DRAM traffic: {trace.total_dram_in / 1e6:.2f} MB in, "
          f"{trace.total_dram_out / 1e6:.2f} MB out")
    print(f"  bandwidth: peak={prof.peak / 1e9:.2f} GB/s  "
          f"p99={prof.percentiles['p99'] / 1e9:.2f}  "
          f"p95={prof.percentiles['p95'] / 1e9:.2f}  "
          f"p50={prof.percentiles['p50'] / 1e9:.2f}  "
          f"sustained={prof.sustained / 1e9:.2f} GB/s")
    if trace.total_noc_bytes:
        links = res.acc.weight_share_cores
        agg = trace.noc_profile()
        link = trace.noc_profile(links=links)
        print(f"  NoC broadcast: {trace.total_noc_bytes / 1e6:.2f} MB over "
              f"{links} links; aggregate "
              f"peak={agg.peak / 1e9:.2f} GB/s "
              f"p95={agg.percentiles['p95'] / 1e9:.2f}; per-link "
              f"peak={link.peak / 1e9:.2f} GB/s "
              f"p95={link.percentiles['p95'] / 1e9:.2f}")
    print(f"  {report.summary()}")
    if args.out:
        meta = {"workload": workload, "strategy": strategy, "seed": seed,
                "validation": report.to_dict()}
        _write_file(args.out,
                    trace.to_json(meta=meta,
                                  include_steps=not args.no_steps) + "\n")
        print(f"  trace written to {args.out}")
    if args.perfetto:
        from repro_torch.obs import chrome_trace_doc, traffic_events, \
            write_chrome_trace

        doc = chrome_trace_doc(
            traffic_events(trace),
            meta={"kind": "traffic", "workload": workload,
                  "strategy": strategy, "seed": seed})
        write_chrome_trace(args.perfetto, doc)
        print(f"  perfetto timeline written to {args.perfetto} "
              f"(open in ui.perfetto.dev)")
    if args.plot:
        from repro_torch.sim.plot import plot_bandwidth

        plot_bandwidth(trace, args.plot,
                       title=f"{workload}[{strategy}]: bandwidth over time")
        print(f"  bandwidth plot written to {args.plot}")
    if not report.ok:
        raise RuntimeError(report.summary())
    return 0


def cmd_plan_h100(args: argparse.Namespace) -> int:
    from repro_torch.configs import ARCHS

    archs = [args.arch] if args.arch else list(ARCHS)
    for arch in archs:
        plan = plan_h100(arch, tokens=args.tokens, layer_idx=args.layer,
                         sample_budget=args.samples, seed=args.seed,
                         device=args.device)
        print(plan.summary())
    return 0


def cmd_serve_plans(args: argparse.Namespace) -> int:
    from repro_torch.serve.plans import (
        PlanServer,
        PlanService,
        fetch_stats,
        request_plan,
    )

    if args.stats or args.request:
        # client modes: talk to an already-running server and exit
        url = args.url or f"http://{args.host}:{args.port}"
        if args.stats:
            print(json.dumps(fetch_stats(url), indent=2, sort_keys=True))
            return 0
        with open(args.request) as f:
            spec = ExploreSpec.from_json(f.read())
        doc = request_plan(url, spec, timeout=args.timeout)
        res = ExploreResult.from_dict(doc["result"])
        print(res.summary())
        print(f"  served_from={doc['served_from']} deduped={doc['deduped']} "
              f"latency={doc['latency_ms']:.1f}ms key={doc['key'][:16]}")
        return 0
    _require_device(args.device)
    store_dir = args.store_dir or os.environ.get("REPRO_STORE_DIR")
    if not store_dir:
        raise SystemExit(
            "serve-plans needs --store-dir (or $REPRO_STORE_DIR)")
    store = ResultStore(store_dir)
    zoo_dir = args.zoo_dir or os.environ.get("REPRO_ZOO_DIR")
    zoo = ResultStore(zoo_dir, read_only=True) if zoo_dir else None
    service = PlanService(store, zoo=zoo, workers=args.workers,
                          eval_backend=args.eval_backend,
                          eval_jobs=args.eval_jobs, device=args.device)
    server = PlanServer((args.host, args.port), service,
                        quiet=not args.verbose)
    if args.port_file:
        _write_file(args.port_file, server.url + "\n")
    zoo_note = f", zoo={zoo.root} ({len(zoo)} plans)" if zoo else ""
    print(f"serve-plans: listening on {server.url} "
          f"(store={store.root}{zoo_note}, workers={service.workers})",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0


def _zoo_dir_from_args(args: argparse.Namespace) -> str:
    return args.zoo_dir or os.environ.get("REPRO_ZOO_DIR") or "runs/zoo"


def _parse_objectives(raw: str) -> List[Any]:
    """``"ema,energy:0.002"`` -> ``[("ema", None), ("energy", 0.002)]``."""
    out = []
    for item in raw.split(","):
        item = item.strip()
        if not item:
            continue
        if ":" in item:
            metric, alpha = item.split(":", 1)
            out.append((metric, float(alpha)))
        else:
            out.append((item, None))
    return out


def _zoo_grid(args: argparse.Namespace) -> List[ExploreSpec]:
    from repro_torch.serve.zoo import zoo_specs

    workloads = ([w.strip() for w in args.workloads.split(",") if w.strip()]
                 if args.workloads else None)
    strategies = [s.strip() for s in args.strategies.split(",") if s.strip()]
    specs = zoo_specs(workloads=workloads, strategies=strategies,
                      objectives=_parse_objectives(args.objectives),
                      budget=args.budget, seed=args.seed)
    if args.limit is not None:
        specs = specs[:args.limit]
    return specs


def _objective_label(spec: ExploreSpec) -> str:
    return spec.objective.metric + (
        "" if spec.objective.alpha is None else f":{spec.objective.alpha:g}")


def cmd_zoo_build(args: argparse.Namespace) -> int:
    from repro_torch.api.store import spec_key
    from repro_torch.serve.zoo import build_zoo

    specs = _zoo_grid(args)
    if args.dry_run:
        _print_table([{
            "workload": s.workload,
            "strategy": s.strategy,
            "objective": _objective_label(s),
            "budget": str(s.sample_budget),
            "key": spec_key(s)[:16],
        } for s in specs])
        print(f"\n{len(specs)} zoo specs (dry run; nothing built)")
        return 0
    store = ResultStore(_zoo_dir_from_args(args))
    report = build_zoo(store, specs, progress=print, device=args.device)
    print(f"zoo[{store.root}]: {report.built} built, {report.replayed} "
          f"already archived, {report.failed} failed "
          f"({len(store)} artifacts, {_fmt_bytes(store.total_bytes())})")
    return 1 if report.failed else 0


def cmd_zoo_ls(args: argparse.Namespace) -> int:
    from repro_torch.serve.zoo import zoo_coverage

    zoo_dir = _zoo_dir_from_args(args)
    store = (ResultStore(zoo_dir, read_only=True)
             if os.path.isdir(zoo_dir) else None)
    rows = zoo_coverage(store, _zoo_grid(args))
    archived = sum(r["status"] == "archived" for r in rows)
    if args.json:
        print(json.dumps({
            "zoo_dir": zoo_dir,
            "archived": archived,
            "missing": len(rows) - archived,
            "rows": rows,
        }, indent=2, sort_keys=True))
        return 0
    if rows:
        _print_table(rows)
    print(f"\nzoo[{zoo_dir}]: {archived}/{len(rows)} grid points archived")
    return 0


def cmd_zoo_verify(args: argparse.Namespace) -> int:
    from repro_torch.serve.zoo import verify_zoo

    store = ResultStore(_zoo_dir_from_args(args), read_only=True)
    problems = verify_zoo(store, rebuild_graphs=not args.no_rebuild)
    if problems:
        for problem in problems:
            print(f"FAIL {problem}")
        print(f"zoo[{store.root}]: {len(problems)} problems in "
              f"{len(store)} artifacts")
        return 1
    print(f"zoo[{store.root}]: {len(store)} artifacts verified clean")
    return 0


def _add_spec_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--spec", help="load an ExploreSpec JSON file "
                                  "(overrides the flags below)")
    p.add_argument("--workload",
                   help="workload URI: netlib:<model> (bare names alias "
                        "here), tpu:<config>:<layer>[?tokens=N&tp=K], "
                        "synthetic:<kind>:<n>[?seed=S], file:<path>.json; "
                        "see `repro_torch workloads ls`")
    p.add_argument("--strategy", default="ga",
                   help=f"one of: {', '.join(list_strategies())}")
    p.add_argument("--metric", default="ema", choices=list(METRICS))
    p.add_argument("--alpha", type=float, default=None,
                   help="Formula-2 weight (None => partition-only Formula 1)")
    p.add_argument("--hw-mode", default="fixed",
                   choices=["fixed", "separate", "shared"])
    p.add_argument("--cores", default=None, metavar="N[,N...]",
                   help="comma-separated weight-share core counts to "
                        "co-explore (HWSpace.core_candidates), e.g. "
                        "--cores 1,2,4; omit to keep the core count fixed "
                        "at the base config's value")
    p.add_argument("--budget", type=int, default=5_000,
                   help="sample budget for search strategies")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out-tile", type=int, default=1)
    p.add_argument("--opt", action="append", default=[], metavar="KEY=VALUE",
                   help="strategy option override, e.g. --opt population=40")
    p.add_argument("--save-spec", metavar="PATH",
                   help="write the resolved ExploreSpec JSON here")
    p.add_argument("--store-dir", metavar="DIR",
                   default=None,
                   help="spec-addressed result store: re-running an "
                        "already-searched spec replays the archived result "
                        "(default: $REPRO_STORE_DIR if set)")
    p.add_argument("--no-store", action="store_true",
                   help="ignore --store-dir/$REPRO_STORE_DIR and always "
                        "search from scratch")
    p.add_argument("--seed-from-store", action="append", default=[],
                   metavar="KEY",
                   help="seed the GA population from this archived result's "
                        "groups (full store key or a unique >= 8-char "
                        "prefix; repeatable; needs a store and strategy ga "
                        "— warm-start FULL-budget sweeps from reduced runs)")
    p.add_argument("--eval-jobs", type=int, default=1,
                   help="worker processes of --eval-backend process for "
                        "batched cost queries within one strategy (results "
                        "are identical to serial evaluation)")
    p.add_argument("--eval-backend", default=None, metavar="NAME",
                   help="evaluation-engine executor: serial | process | "
                        "vector | torch (default: torch, which runs on "
                        "--device)")
    p.add_argument("--struct-cache-dir", metavar="DIR", default=None,
                   help="disk-backed warm cache for canonical subgraph "
                        "structures, shared across runs and worker "
                        "processes (default: $REPRO_STRUCT_CACHE_DIR if "
                        "set; unset means no filesystem traffic)")


def _subcommand(argv: List[str]) -> Optional[str]:
    """The first word of ``argv`` that is not a global option."""
    it = iter(argv)
    for word in it:
        if word == "--device":
            next(it, None)
        elif not word.startswith("-"):
            return word
    return None


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch",
        description="Cocco hardware-mapping co-exploration (PyTorch port)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the torch eval backend runs (default: cuda; "
                         "without a GPU, pass --device cpu)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("explore", help="run one strategy on one workload")
    _add_spec_args(pe)
    pe.add_argument("--out", metavar="PATH",
                    help="write the ExploreResult JSON here")
    pe.add_argument("--profile", action="store_true",
                    help="print a search profile: wall time, "
                         "derive_schedule seconds, and structure-cache "
                         "hit/miss counters (raw / canonical / disk)")
    pe.add_argument("--telemetry", metavar="PATH",
                    help="record the search's span tree + counters and "
                         "write a Chrome/Perfetto trace-event JSON here "
                         "(open in ui.perfetto.dev; results are identical "
                         "with or without recording)")
    pe.set_defaults(fn=cmd_explore, needs_device=True)

    pc = sub.add_parser("compare",
                        help="run several strategies on one spec, ranked")
    _add_spec_args(pc)
    pc.add_argument("--strategies", default="greedy,dp,ga",
                    help="comma-separated strategy names")
    pc.add_argument("--jobs", type=int, default=1,
                    help="run strategies in N worker processes "
                         "(results are identical to the serial path)")
    pc.add_argument("--out", metavar="PATH",
                    help="write all ExploreResult JSONs here (a list)")
    pc.set_defaults(fn=cmd_compare, needs_device=True)

    ptr = sub.add_parser(
        "trace",
        help="simulate a plan's DRAM traffic over time "
             "(repro_torch.sim trace simulator)")
    ptr.add_argument("uri", nargs="?", default=None,
                     help="workload URI (positional alias for --workload)")
    _add_spec_args(ptr)
    ptr.add_argument("--plan", metavar="PATH",
                     help="trace an archived ExploreResult JSON instead of "
                          "searching for a plan first")
    ptr.add_argument("--steps-per-subgraph", type=int, default=None,
                     metavar="N",
                     help="coalesce each subgraph's row-granular steps to "
                          "at most N buckets (totals are preserved; "
                          "default: full row resolution)")
    ptr.add_argument("--out", metavar="PATH",
                     help="write the trace JSON here (cocco-trace format)")
    ptr.add_argument("--no-steps", action="store_true",
                     help="omit the per-step timeline from --out JSON "
                          "(totals, profile, and per-subgraph rows stay)")
    ptr.add_argument("--perfetto", metavar="PATH",
                     help="write the timeline as Chrome/Perfetto "
                          "trace-event JSON (steps as duration events on "
                          "per-core tracks, DRAM/NoC bytes as counter "
                          "tracks; open in ui.perfetto.dev)")
    ptr.add_argument("--plot", metavar="PATH",
                     help="render a bandwidth-over-time plot (PNG/SVG by "
                          "extension; needs the optional matplotlib "
                          "dependency)")
    ptr.set_defaults(fn=cmd_trace, needs_device=True)

    pw = sub.add_parser("workloads",
                        help="list resolvable workload URIs")
    wsub = pw.add_subparsers(dest="workloads_cmd", required=True)
    pwl = wsub.add_parser("ls", help="schemes + every enumerable workload")
    pwl.add_argument("--scheme", default=None,
                     help="limit to one scheme (netlib, tpu, synthetic, "
                          "file, or a registered custom scheme)")
    pwl.add_argument("--uris-only", action="store_true",
                     help="print only concrete, resolvable URIs — every "
                          "line works as --workload (script-friendly; "
                          "no scheme table, no templates)")
    pwl.add_argument("--json", action="store_true",
                     help="machine-readable output: {schemes, workloads} "
                          "with concrete URIs only (for tooling)")
    pwl.set_defaults(fn=cmd_workloads_ls, needs_device=False)

    ps = sub.add_parser("store",
                        help="inspect / garbage-collect a result store")
    store_sub = ps.add_subparsers(dest="store_cmd", required=True)
    psl = store_sub.add_parser("ls", help="list store entries (LRU first)")
    psl.add_argument("--store-dir", default=None,
                     help="store directory (default: $REPRO_STORE_DIR)")
    psl.add_argument("--json", action="store_true",
                     help="machine-readable output: {root, count, "
                          "total_bytes, entries:[{key, workload, strategy, "
                          "size, mtime}]} with full keys (for tooling)")
    psl.set_defaults(fn=cmd_store_ls, needs_device=False)
    psg = store_sub.add_parser(
        "gc", help="evict least-recently-written entries down to a size cap")
    psg.add_argument("--store-dir", default=None,
                     help="store directory (default: $REPRO_STORE_DIR)")
    psg.add_argument("--max-bytes", type=int, required=True,
                     help="keep at most this many bytes of artifacts")
    psg.set_defaults(fn=cmd_store_gc, needs_device=False)


    from repro_torch.serve.zoo import DEFAULT_BUDGET

    ph = sub.add_parser("plan-h100",
                        help="Cocco as the H100's execution planner")
    ph.add_argument("--arch", default=None,
                    help="model config name (default: all)")
    ph.add_argument("--tokens", type=int, default=8192)
    ph.add_argument("--layer", type=int, default=None)
    ph.add_argument("--samples", type=int, default=2_000)
    ph.add_argument("--seed", type=int, default=0)
    ph.set_defaults(fn=cmd_plan_h100, needs_device=True)

    psp = sub.add_parser(
        "serve-plans",
        help="HTTP plan server over a result store (docs/serving.md)")
    psp.add_argument("--host", default="127.0.0.1")
    psp.add_argument("--port", type=int, default=8787,
                     help="bind port (0 lets the OS pick; see --port-file)")
    psp.add_argument("--store-dir", default=None,
                     help="read-write result store every search publishes "
                          "to (default: $REPRO_STORE_DIR)")
    psp.add_argument("--zoo-dir", default=None,
                     help="mount a prebuilt plan zoo as a read-only "
                          "read-through tier (default: $REPRO_ZOO_DIR)")
    psp.add_argument("--workers", type=int, default=2,
                     help="search worker threads (hits never queue behind "
                          "them)")
    psp.add_argument("--eval-jobs", type=int, default=1,
                     help="evaluation-engine workers per search")
    psp.add_argument("--eval-backend", default=None, metavar="NAME",
                     help="evaluation-engine executor per search (serial | "
                          "process | vector | torch; default: torch, "
                          "on --device)")
    psp.add_argument("--port-file", metavar="PATH",
                     help="write the bound URL here once listening "
                          "(CI/scripts; pairs with --port 0)")
    psp.add_argument("--verbose", action="store_true",
                     help="log each HTTP request")
    psp.add_argument("--stats", action="store_true",
                     help="client mode: print a running server's /stats "
                          "JSON and exit")
    psp.add_argument("--request", metavar="SPEC.json",
                     help="client mode: POST this ExploreSpec file to a "
                          "running server, print the plan summary")
    psp.add_argument("--url", default=None,
                     help="server URL for --stats/--request "
                          "(default: http://HOST:PORT)")
    psp.add_argument("--timeout", type=float, default=600.0,
                     help="client-mode request timeout in seconds")
    psp.set_defaults(fn=cmd_serve_plans, needs_device=False)

    def _add_zoo_grid_args(p: argparse.ArgumentParser) -> None:
        p.add_argument("--zoo-dir", default=None,
                       help="zoo directory (default: $REPRO_ZOO_DIR, "
                            "else runs/zoo)")
        p.add_argument("--workloads", default=None,
                       help="comma-separated workload URIs (default: every "
                            "netlib: model + the curated tpu: blocks)")
        p.add_argument("--strategies", default="greedy,ga",
                       help="comma-separated strategies")
        p.add_argument("--objectives", default="ema,energy:0.002",
                       help="comma-separated metric[:alpha] objectives")
        p.add_argument("--budget", type=int, default=DEFAULT_BUDGET,
                       help="sample budget per grid point")
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--limit", type=int, default=None, metavar="N",
                       help="only the first N grid points (smoke/CI)")

    pz = sub.add_parser(
        "zoo", help="build / inspect / verify the precomputed plan zoo")
    zsub = pz.add_subparsers(dest="zoo_cmd", required=True)
    pzb = zsub.add_parser(
        "build",
        help="archive every grid point into the zoo store (resumable: "
             "already-archived specs replay instead of re-searching)")
    _add_zoo_grid_args(pzb)
    pzb.add_argument("--dry-run", action="store_true",
                     help="print the grid (workload/strategy/objective/key) "
                          "without building anything")
    pzb.set_defaults(fn=cmd_zoo_build, needs_device=True)
    pzl = zsub.add_parser("ls", help="grid coverage: archived vs missing")
    _add_zoo_grid_args(pzl)
    pzl.add_argument("--json", action="store_true",
                     help="machine-readable coverage rows")
    pzl.set_defaults(fn=cmd_zoo_ls, needs_device=False)
    pzv = zsub.add_parser(
        "verify",
        help="replay-integrity check of every artifact in the zoo")
    pzv.add_argument("--zoo-dir", default=None,
                     help="zoo directory (default: $REPRO_ZOO_DIR, "
                          "else runs/zoo)")
    pzv.add_argument("--no-rebuild", action="store_true",
                     help="skip re-resolving workload URIs (faster; still "
                          "checks parse/spec-hash/re-scored cost)")
    pzv.set_defaults(fn=cmd_zoo_verify, needs_device=False)

    if _subcommand(sys.argv[1:] if argv is None else argv) == "plan-tpu":
        print("error: the port plans for the H100, not a TPU: use plan-h100",
              file=sys.stderr)
        return 2
    args = ap.parse_args(argv)
    backend = getattr(args, "eval_backend", None)
    if backend is not None:
        # pre-flight: an unknown name lists the valid backends before any
        # search work starts
        from repro_torch.core.engine import backend_status

        ok, why = backend_status(backend)
        if not ok:
            print(f"error: {why}", file=sys.stderr)
            return 2
    try:
        if args.needs_device:
            _require_device(args.device)
        return args.fn(args)
    except (KeyError, ValueError, TypeError, OSError, RuntimeError) as err:
        # user-input errors (unknown workload, bad option key, missing spec
        # file, absent optional dep) -> clean message, nonzero exit
        print(f"error: {err}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
