"""Workload resolver: ``workload:`` URIs -> Cocco :class:`~repro_torch.core.graph.Graph`.

Every :class:`ExploreSpec` names its workload as a URI ``<scheme>:<rest>``
(a bare name is a back-compat alias for ``netlib:<name>``), and
:func:`build_workload` dispatches on an open scheme registry.  Built-ins:

* ``netlib:<model>`` — the paper's model zoo (:data:`repro_torch.core.netlib.PAPER_MODELS`).
* ``synthetic:<kind>:<n>[?seed=S&...]`` — seeded random DAG generators
  (``layered`` | ``branchy`` | ``diamond`` | ``chain`` | ``pyramid``) for
  stress and fuzz workloads; deterministic in the URI, so fingerprints and
  store keys are stable across processes.
* ``file:<path>.json`` — import an external netlist in the documented Graph
  JSON format (:func:`repro_torch.core.graph.graph_to_json` exports it).

``register_workload_scheme`` is open the same way ``register_strategy`` is:
downstream code can add a scheme and it becomes resolvable by
``run``/``compare``, the CLI, and the benchmarks without touching this
package.  Resolution is deterministic: one URI always builds the same graph
(same :func:`~repro_torch.api.store.graph_fingerprint`), which is what lets the
spec-addressed :class:`~repro_torch.api.store.ResultStore` replay any scheme's
results safely.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qsl

from repro_torch.core.graph import Graph, graph_from_json

# ---------------------------------------------------------------------------
# the scheme registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class WorkloadScheme:
    """One registered URI scheme."""

    name: str
    build: Callable[[str, Dict[str, str]], Graph]   # (rest, params) -> Graph
    syntax: str                                     # e.g. "synthetic:<kind>:<n>[?seed=S]"
    description: str
    # display rows for `python -m repro_torch workloads ls` (may be templates)
    list_fn: Optional[Callable[[], List[str]]] = None
    # concrete, resolvable URIs for `workloads ls --uris-only` (None when the
    # scheme's instances are not enumerable, e.g. file:)
    expand_fn: Optional[Callable[[], List[str]]] = None
    # False when the URI does not pin the graph's content (file: — the file
    # can change under an unchanged URI); the store layer then re-checks the
    # graph fingerprint before replaying an artifact
    stable: bool = True


_SCHEMES: Dict[str, WorkloadScheme] = {}


def register_workload_scheme(name: str, *, syntax: str, description: str,
                             list_fn: Optional[Callable[[], List[str]]] = None,
                             expand_fn: Optional[Callable[[], List[str]]] = None,
                             stable: bool = True):
    """Decorator: register ``fn(rest, params) -> Graph`` as scheme ``name``.

    ``rest`` is everything after ``<name>:`` up to the ``?``; ``params`` is
    the parsed query dict (string values; the builder coerces and must
    reject unknown keys so that two spellings of one workload cannot alias
    different graphs).  Pass ``stable=False`` when the URI alone does not
    pin the graph's content (e.g. a path whose file can change): the store
    layer then verifies the graph fingerprint before replaying artifacts.
    """

    def deco(fn: Callable[[str, Dict[str, str]], Graph]):
        _SCHEMES[name] = WorkloadScheme(name=name, build=fn, syntax=syntax,
                                        description=description,
                                        list_fn=list_fn, expand_fn=expand_fn,
                                        stable=stable)
        return fn

    return deco


def workload_schemes() -> List[WorkloadScheme]:
    return [_SCHEMES[k] for k in sorted(_SCHEMES)]


def parse_workload(uri: str) -> Tuple[str, str, Dict[str, str]]:
    """Split a workload URI into ``(scheme, rest, params)``.

    A bare name (no ``:``) aliases to ``netlib:<name>`` for back-compat
    with pre-resolver specs.  Unknown schemes and malformed query strings
    raise ``ValueError`` — this doubles as :class:`ExploreSpec`-time
    validation, so a typo fails at spec construction, not mid-search.
    """
    if not uri:
        raise ValueError("empty workload")
    if ":" not in uri:
        return "netlib", uri, {}
    scheme, rest = uri.split(":", 1)
    if scheme not in _SCHEMES:
        raise ValueError(
            f"unknown workload scheme {scheme!r} in {uri!r}; registered "
            f"schemes: {sorted(_SCHEMES)} (a bare name means netlib:<name>)")
    rest, _, query = rest.partition("?")
    params: Dict[str, str] = {}
    if query:
        try:
            pairs = parse_qsl(query, keep_blank_values=True,
                              strict_parsing=True)
        except ValueError as err:
            raise ValueError(f"bad workload query {query!r} in {uri!r}: "
                             f"{err}") from None
        for k, v in pairs:
            if k in params:
                raise ValueError(f"duplicate workload param {k!r} in {uri!r}")
            params[k] = v
    return scheme, rest, params


def validate_workload(uri: str) -> None:
    """Spec-construction-time validation: syntax only, no graph build, no
    file access.

    Registered schemes get their full URI syntax checked (malformed query
    strings fail here).  A ``prefix:`` that is *not* a registered scheme is
    accepted — it may be a free-form label for a custom graph passed via
    ``run(graph=...)``, and pre-resolver artifacts with such labels must
    keep deserializing.  Resolution (:func:`build_workload`) still rejects
    it with the full unknown-scheme message.
    """
    if not uri:
        raise ValueError("empty workload")
    if ":" in uri and uri.split(":", 1)[0] in _SCHEMES:
        parse_workload(uri)


def workload_is_stable(uri: str) -> bool:
    """True when the URI alone pins the graph content (every scheme except
    ``file:``-like ones).  Free-form labels count as stable: they resolve
    nowhere, so there is nothing to re-check."""
    if ":" not in uri:
        return True
    entry = _SCHEMES.get(uri.split(":", 1)[0])
    return entry.stable if entry is not None else True


def build_workload(uri: str) -> Graph:
    """Resolve a workload URI (or bare netlib name) to a graph."""
    scheme, rest, params = parse_workload(uri)
    try:
        return _SCHEMES[scheme].build(rest, params)
    except ModuleNotFoundError as err:
        raise RuntimeError(
            f"workload {uri!r} needs an optional dependency: {err}") from err


def list_workloads(scheme: Optional[str] = None,
                   concrete: bool = False) -> List[Tuple[str, str]]:
    """``(uri, note)`` rows for ``workloads ls``.

    Default: display rows, which may be compact templates
    (``synthetic:layered:<n>[?seed=S]``).  With
    ``concrete=True``, only URIs that :func:`build_workload` actually
    resolves are returned (schemes without enumerable instances contribute
    nothing) — the script-friendly ``workloads ls --uris-only`` contract.
    """
    if scheme is not None and scheme not in _SCHEMES:
        raise ValueError(f"unknown workload scheme {scheme!r}; registered "
                         f"schemes: {sorted(_SCHEMES)}")
    rows: List[Tuple[str, str]] = []
    for entry in workload_schemes():
        if scheme is not None and entry.name != scheme:
            continue
        if concrete:
            if entry.expand_fn is not None:
                rows.extend((uri, entry.description)
                            for uri in entry.expand_fn())
        elif entry.list_fn is None:
            rows.append((entry.syntax, entry.description))
        else:
            rows.extend((uri, entry.description) for uri in entry.list_fn())
    return rows


# ---------------------------------------------------------------------------
# shared param helpers (strict: unknown keys are an error, not a shrug)
# ---------------------------------------------------------------------------

def _int_param(params: Dict[str, str], key: str, default: int,
               minimum: int = 1) -> int:
    raw = params.pop(key, None)
    if raw is None:
        return default
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(f"workload param {key}={raw!r} is not an integer") \
            from None
    if value < minimum:
        raise ValueError(f"workload param {key}={value} must be >= {minimum}")
    return value


def _reject_extra_params(scheme: str, params: Dict[str, str]) -> None:
    if params:
        raise ValueError(
            f"unknown params {sorted(params)} for workload scheme "
            f"{scheme!r}")


# ---------------------------------------------------------------------------
# netlib: the paper zoo (bare names alias here)
# ---------------------------------------------------------------------------

def _list_netlib() -> List[str]:
    from repro_torch.core import netlib

    return [f"netlib:{name}" for name in netlib.list_models()]


@register_workload_scheme(
    "netlib",
    syntax="netlib:<model>",
    description="paper model zoo (bare names alias to this scheme)",
    list_fn=_list_netlib,
    expand_fn=_list_netlib,
)
def _build_netlib(rest: str, params: Dict[str, str]) -> Graph:
    from repro_torch.core import netlib

    _reject_extra_params("netlib", params)
    return netlib.build(rest)


# ---------------------------------------------------------------------------
# synthetic: seeded random DAG generators
# ---------------------------------------------------------------------------

def _mark_sinks_as_outputs(g: Graph) -> Graph:
    for v in g.sinks():
        g.nodes[v].is_output = True
    return g


def _random_node(g: Graph, rng: random.Random, name: str, rows: int) -> int:
    """One layer with randomized width/weights/compute (deterministic in rng)."""
    line = rng.choice((16, 32, 64, 128))
    wbytes = rng.choice((0, 256, 1024, 4096))
    macs = rows * line * rng.randint(1, 64)
    return g.add_node(name, rows, line, weight_bytes=wbytes, macs=macs)


def _gen_layered(n: int, seed: int, rows: int, width: int) -> Graph:
    """``width`` parallel lanes per rank; each node consumes 1-2 nodes of the
    previous rank and every producer keeps at least one consumer."""
    rng = random.Random(seed)
    g = Graph(f"synthetic:layered:{n}?seed={seed}")
    prev: List[int] = []
    made = 0
    while made < n:
        layer_w = 1 if not prev else min(width, n - made, rng.randint(1, width))
        layer = []
        for _ in range(layer_w):
            v = _random_node(g, rng, f"n{g.n}", rows)
            layer.append(v)
            made += 1
            for src in (rng.sample(prev, k=min(len(prev), rng.randint(1, 2)))
                        if prev else []):
                g.add_edge(src, v, F=1, s=1)
        # every producer of the previous rank must feed someone
        fed = {e.src for v in layer for e in g.in_edges(v)}
        for src in prev:
            if src not in fed:
                g.add_edge(src, rng.choice(layer), F=1, s=1)
        prev = layer
    return _mark_sinks_as_outputs(g)


def _gen_branchy(n: int, seed: int, rows: int) -> Graph:
    """RandWire-style irregular DAG: node ``i`` consumes 1-3 random nodes
    from a trailing locality window, so merge nodes of mixed fan-in appear."""
    rng = random.Random(seed)
    g = Graph(f"synthetic:branchy:{n}?seed={seed}")
    for i in range(n):
        v = _random_node(g, rng, f"n{i}", rows)
        if i == 0:
            continue
        lo = max(0, i - 8)
        k = min(i - lo, rng.randint(1, 3))
        for src in rng.sample(range(lo, i), k=k):
            g.add_edge(src, v, F=1, s=1)
    return _mark_sinks_as_outputs(g)


def _gen_diamond(n: int, seed: int, rows: int) -> Graph:
    """Residual/diamond chain: repeated ``x -> a -> b -> add(b, x)`` blocks,
    the shape the paper's multi-branch nets are made of."""
    rng = random.Random(seed)
    g = Graph(f"synthetic:diamond:{n}?seed={seed}")
    x = _random_node(g, rng, "stem", rows)
    while g.n < n:
        a = _random_node(g, rng, f"b{g.n}.a", rows)
        g.add_edge(x, a, F=1, s=1)
        if g.n < n:
            b = _random_node(g, rng, f"b{g.n}.b", rows)
            g.add_edge(a, b, F=1, s=1)
        else:
            b = a
        if g.n < n:
            add = g.add_node(f"b{g.n}.add", rows,
                             g.nodes[b].line_bytes, macs=2 * rows)
            g.add_edge(b, add, F=1, s=1)
            g.add_edge(x, add, F=1, s=1)
            x = add
        else:
            x = b
    return _mark_sinks_as_outputs(g)


def _gen_chain(n: int, seed: int, rows: int) -> Graph:
    """Plain chain with randomized sliding windows (F, s), exercising the
    backward row-derivation on heterogeneous strides."""
    rng = random.Random(seed)
    g = Graph(f"synthetic:chain:{n}?seed={seed}")
    prev = _random_node(g, rng, "n0", rows)
    cur_rows = rows
    for i in range(1, n):
        F, s = rng.choice(((1, 1), (1, 1), (3, 1), (3, 2), (2, 2)))
        out_rows = max(1, math.ceil(cur_rows / s))      # 'same' padding
        line = rng.choice((16, 32, 64, 128))
        v = g.add_node(f"n{i}", out_rows, line,
                       weight_bytes=rng.choice((0, 512, 2048)),
                       macs=out_rows * line * F)
        g.add_edge(prev, v, F=min(F, cur_rows), s=s)
        prev, cur_rows = v, out_rows
    return _mark_sinks_as_outputs(g)


def _gen_pyramid(n: int, seed: int, rows: int) -> Graph:
    """Stride pyramid with multi-input merges: rows halve level by level
    (non-uniform row counts across the graph), each level chains a few
    same-rate nodes, and merge nodes additionally consume a stride-matched
    skip edge from an *earlier* level — the mixed-rate fan-in shape the
    consumption-centric rate solver (tiling stage 3) has to balance."""
    rng = random.Random(seed)
    g = Graph(f"synthetic:pyramid:{n}?seed={seed}")
    cur_rows = max(rows, 2)
    prev = _random_node(g, rng, "p0.stem", cur_rows)
    levels: List[List[int]] = [[prev]]
    level_rows: List[int] = [cur_rows]
    while g.n < n:
        # new level: stride-2 downsample from the previous level's tail
        # (window F=s keeps f(k) = F + (k-1)s within the producer's rows)
        nxt_rows = max(1, cur_rows // 2)
        s_down = min(2, cur_rows)
        down = _random_node(g, rng, f"p{len(levels)}.down", nxt_rows)
        g.add_edge(prev, down, F=s_down, s=s_down)
        level = [down]
        prev, cur_rows = down, nxt_rows
        for _ in range(rng.randint(0, 2)):          # same-rate body nodes
            if g.n >= n:
                break
            v = _random_node(g, rng, f"p{len(levels)}.c{g.n}", cur_rows)
            g.add_edge(prev, v, F=1, s=1)
            level.append(v)
            prev = v
        if g.n < n:
            # multi-input merge: level tail + a skip from an earlier level,
            # stride chosen so the window stays inside the skip source
            merge = g.add_node(f"p{len(levels)}.merge", cur_rows,
                               g.nodes[prev].line_bytes,
                               macs=2 * cur_rows * g.nodes[prev].line_bytes)
            g.add_edge(prev, merge, F=1, s=1)
            j = rng.randrange(len(levels))
            src = rng.choice(levels[j])
            if cur_rows > 1:
                s_skip = min(2 ** (len(levels) - j),
                             max(1, (level_rows[j] - 1) // (cur_rows - 1)))
            else:
                s_skip = 1
            g.add_edge(src, merge, F=1, s=s_skip)
            level.append(merge)
            prev = merge
        levels.append(level)
        level_rows.append(cur_rows)
    return _mark_sinks_as_outputs(g)


_SYNTHETIC_KINDS = {
    "layered": _gen_layered,
    "branchy": _gen_branchy,
    "diamond": _gen_diamond,
    "chain": _gen_chain,
    "pyramid": _gen_pyramid,
}


def _list_synthetic() -> List[str]:
    return [f"synthetic:{kind}:<n>[?seed=S]" for kind in
            sorted(_SYNTHETIC_KINDS)]


@register_workload_scheme(
    "synthetic",
    syntax="synthetic:<kind>:<n>[?seed=S&rows=R&width=W]",
    description="seeded random DAG generators for stress/fuzz workloads",
    list_fn=_list_synthetic,
)
def _build_synthetic(rest: str, params: Dict[str, str]) -> Graph:
    kind, sep, n_raw = rest.partition(":")
    if not sep:
        raise ValueError(
            f"synthetic workload needs a node count: synthetic:<kind>:<n>, "
            f"got synthetic:{rest!r}")
    if kind not in _SYNTHETIC_KINDS:
        raise ValueError(f"unknown synthetic kind {kind!r}; known: "
                         f"{sorted(_SYNTHETIC_KINDS)}")
    try:
        n = int(n_raw)
    except ValueError:
        raise ValueError(f"synthetic node count must be an integer, "
                         f"got {n_raw!r}") from None
    if n < 2:
        raise ValueError(f"synthetic workload needs n >= 2, got {n}")
    seed = _int_param(params, "seed", 0, minimum=0)
    rows = _int_param(params, "rows", 32)
    kw = {}
    if kind == "layered":
        kw["width"] = _int_param(params, "width", 4)
    _reject_extra_params("synthetic", params)
    return _SYNTHETIC_KINDS[kind](n, seed, rows, **kw)


# ---------------------------------------------------------------------------
# file: external netlists in the documented Graph JSON format
# ---------------------------------------------------------------------------

@register_workload_scheme(
    "file",
    syntax="file:<path>.json",
    description="external netlist in the Graph JSON format "
                "(export with repro_torch.core.graph.graph_to_json)",
    stable=False,   # the file can change under an unchanged URI
)
def _build_file(rest: str, params: Dict[str, str]) -> Graph:
    _reject_extra_params("file", params)
    path = Path(rest).expanduser()
    if not path.is_file():
        raise ValueError(f"workload file not found: {path}")
    try:
        return graph_from_json(path.read_text())
    except ValueError as err:
        raise ValueError(f"cannot load workload file {path}: {err}") from None
