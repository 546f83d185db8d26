"""``python -m repro_torch`` — run explorations from the command line.

Subcommands:

* ``explore``   — run one strategy on one workload; print the summary and
                  optionally write the spec/result as JSON artifacts.
* ``compare``   — run several strategies on the same spec (one shared cost
                  evaluator, optionally ``--jobs N`` worker processes) and
                  print a ranked table.
* ``workloads`` — ``ls`` every resolvable workload URI (scheme registry:
                  ``netlib:`` / ``synthetic:`` / ``file:``); ``--json``
                  emits a machine-readable listing for tooling.

``--workload`` takes a URI (a bare name is ``netlib:<name>``): e.g.
``netlib:resnet50``, ``synthetic:layered:24?seed=7``, ``file:my_net.json``.

``--device`` (before the subcommand) is ``cuda`` (the default) or ``cpu``.
With ``cuda`` and no GPU, ``explore`` and ``compare`` print ``error: ...``
and exit 2; they never carry on on the CPU.  ``--eval-backend`` picks the
evaluation-engine executor (``repro_torch.core.engine``: ``serial`` |
``process`` | ``vector`` | ``torch``; default ``torch``): ``torch``
batches whole GA generations through the CUDA kernel on ``--device cuda``.
``--eval-jobs`` sizes the ``process`` backend's pool and is refused with
any other backend.  Every backend returns bit-identical results, so they
are pure runtime knobs.

``--store-dir`` (or ``$REPRO_STORE_DIR``) points ``explore`` and
``compare`` at a spec-addressed result store, in the same format and under
the same keys as the JAX package's, so a store written by either replays
in the other.  ``explore --profile`` prints where the search spent its time
and the structure-cache counters; ``--struct-cache-dir`` (or
``$REPRO_STRUCT_CACHE_DIR``) adds a disk-backed warm cache of canonical
subgraph structures.

Examples::

    python -m repro_torch explore --workload resnet50 --strategy ga \
        --metric energy --alpha 0.002 --hw-mode shared --budget 4000
    python -m repro_torch --device cpu compare \
        --workload "synthetic:layered:24?seed=7" --strategies greedy,dp,ga
    python -m repro_torch workloads ls --json
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
from .strategies import compare, run


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


def _eval_kwargs(args: argparse.Namespace) -> Dict[str, Any]:
    """The evaluation-engine knobs ``run``/``compare`` take from the CLI."""
    return dict(eval_backend=args.eval_backend or "torch",
                eval_jobs=args.eval_jobs,
                struct_cache_dir=args.struct_cache_dir, device=args.device)


def cmd_explore(args: argparse.Namespace) -> int:
    spec = _spec_from_args(args)
    _maybe_save(args.save_spec, spec.to_json(indent=2))
    store = _store_from_args(args)
    res = run(spec, store=store, profile=args.profile, **_eval_kwargs(args))
    print(res.summary())
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
    # view may show compact templates (synthetic:<kind>:<n>) beside the table
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


def _add_spec_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--spec", help="load an ExploreSpec JSON file "
                                  "(overrides the flags below)")
    p.add_argument("--workload",
                   help="workload URI: netlib:<model> (bare names alias "
                        "here), synthetic:<kind>:<n>[?seed=S], "
                        "file:<path>.json; "
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

    pw = sub.add_parser("workloads",
                        help="list resolvable workload URIs")
    wsub = pw.add_subparsers(dest="workloads_cmd", required=True)
    pwl = wsub.add_parser("ls", help="schemes + every enumerable workload")
    pwl.add_argument("--scheme", default=None,
                     help="limit to one scheme (netlib, synthetic, file, "
                          "or a registered custom scheme)")
    pwl.add_argument("--uris-only", action="store_true",
                     help="print only concrete, resolvable URIs — every "
                          "line works as --workload (script-friendly; "
                          "no scheme table, no templates)")
    pwl.add_argument("--json", action="store_true",
                     help="machine-readable output: {schemes, workloads} "
                          "with concrete URIs only (for tooling)")
    pwl.set_defaults(fn=cmd_workloads_ls, needs_device=False)

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
    if args.needs_device and args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("error: --device cuda needs a CUDA GPU and none is "
                  "available; pass --device cpu to run on the CPU",
                  file=sys.stderr)
            return 2
    try:
        return args.fn(args)
    except (KeyError, ValueError, TypeError, OSError, RuntimeError) as err:
        # user-input errors (unknown workload, bad option key, missing spec
        # file) -> clean message, nonzero exit
        print(f"error: {err}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
