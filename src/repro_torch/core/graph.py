"""Computation-graph IR for the Cocco scheme.

A DNN model is a DAG ``G = (V, E)`` (paper §4.1.1).  Every node is a layer
producing one output tensor.  For the memory scheme we model the *sliding*
spatial axis explicitly (rows, i.e. the H axis of an NWHC layout): a node's
output is ``out_len`` rows of ``line_bytes`` bytes each.  Every edge carries the
consumer's window semantics over the producer's rows:

* ``sliding`` edges have a kernel extent ``F`` and stride ``s`` (convolutions,
  pooling; pointwise ops are F=1, s=1),
* ``full`` edges require the producer's entire output to be resident before the
  consumer can start (attention over a sequence, global pooling, FC over the
  spatial axis).  These act as phase boundaries in the subgraph pipeline.

Units: activation/weight bytes are INT8 (1 byte/elem) as in the paper's
Simba-like platform.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

SLIDING = "sliding"
FULL = "full"


@dataclass(frozen=True)
class Edge:
    """Dependency ``src -> dst``: dst consumes src's output."""

    src: int
    dst: int
    F: int = 1          # window extent in producer rows (sliding only)
    s: int = 1          # stride in producer rows (sliding only)
    kind: str = SLIDING

    def window(self, k: int) -> int:
        """Rows of src needed for dst to produce ``k`` of its own rows.

        This is the paper's ``f_v(x) = F + (x - 1) * s`` (footnote 1).
        """
        if self.kind == FULL:
            raise ValueError("full edges have no finite window")
        return self.F + (k - 1) * self.s


@dataclass
class Node:
    """One layer.  ``out_len`` rows x ``line_bytes`` bytes/row output tensor."""

    idx: int
    name: str
    out_len: int                 # rows along the sliding axis (H_out)
    line_bytes: int              # W_out * C_out * act_bytes
    weight_bytes: int = 0
    macs: int = 0
    is_output: bool = False      # model output -> always written back to DRAM

    @property
    def out_bytes(self) -> int:
        return self.out_len * self.line_bytes


class Graph:
    """A DAG of layers.  Node indices are dense 0..N-1 in insertion order and
    insertion order must be a valid topological order (asserted)."""

    def __init__(self, name: str = "graph") -> None:
        self.name = name
        self.nodes: List[Node] = []
        self.edges: List[Edge] = []
        self._out: Dict[int, List[Edge]] = {}
        self._in: Dict[int, List[Edge]] = {}
        # undirected neighbour ids, for O(deg) connectivity queries (the GA's
        # normalize/repair loop calls them hundreds of thousands of times)
        self._und: Dict[int, List[int]] = {}
        # topo_order() memo (a tuple, so the shared value is mutation-proof);
        # invalidated by length whenever add_node grows the graph
        self._topo: Optional[Tuple[int, ...]] = None

    # -- construction -----------------------------------------------------
    def add_node(
        self,
        name: str,
        out_len: int,
        line_bytes: int,
        weight_bytes: int = 0,
        macs: int = 0,
        is_output: bool = False,
    ) -> int:
        idx = len(self.nodes)
        self.nodes.append(
            Node(idx, name, int(out_len), int(line_bytes), int(weight_bytes),
                 int(macs), is_output)
        )
        self._out[idx] = []
        self._in[idx] = []
        self._und[idx] = []
        return idx

    def add_edge(self, src: int, dst: int, F: int = 1, s: int = 1,
                 kind: str = SLIDING) -> None:
        if not (0 <= src < len(self.nodes) and 0 <= dst < len(self.nodes)):
            raise ValueError(f"bad edge ({src},{dst})")
        if src >= dst:
            raise ValueError("insertion order must be topological: src < dst")
        if kind not in (SLIDING, FULL):
            raise ValueError(
                f"edge kind must be {SLIDING!r} or {FULL!r}, got {kind!r}")
        if kind == SLIDING:
            if F < 1 or s < 1:
                raise ValueError("sliding edge needs F>=1, s>=1")
        e = Edge(src, dst, int(F), int(s), kind)
        self.edges.append(e)
        self._out[src].append(e)
        self._in[dst].append(e)
        self._und[src].append(dst)
        self._und[dst].append(src)

    # -- queries ----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.nodes)

    @property
    def n(self) -> int:
        return len(self.nodes)

    def in_edges(self, v: int) -> List[Edge]:
        return self._in[v]

    def out_edges(self, v: int) -> List[Edge]:
        return self._out[v]

    def preds(self, v: int) -> List[int]:
        return [e.src for e in self._in[v]]

    def succs(self, v: int) -> List[int]:
        return [e.dst for e in self._out[v]]

    def sources(self) -> List[int]:
        return [v.idx for v in self.nodes if not self._in[v.idx]]

    def sinks(self) -> List[int]:
        return [v.idx for v in self.nodes if not self._out[v.idx]]

    def topo_order(self) -> Sequence[int]:
        # insertion order is topological; memoized — search loops walk this
        # once per crossover/partition sample
        t = self._topo
        if t is None or len(t) != len(self.nodes):
            t = self._topo = tuple(range(len(self.nodes)))
        return t

    # -- subgraph helpers ---------------------------------------------------
    #
    # These iterate the subgraph's own adjacency lists (O(sum of member
    # degrees)) instead of every edge of the graph (O(E)) — compute_structure
    # calls them per node-set query, which made the O(E) scans a measurable
    # slice of structure-derivation time on 200+-node models.  Members are
    # walked in sorted order so the returned edge order is a deterministic
    # function of the node set (callers only ever set-reduce the result).

    def internal_edges(self, nodes: Set[int]) -> List[Edge]:
        _in = self._in
        return [e for v in sorted(nodes) for e in _in[v] if e.src in nodes]

    def boundary_in(self, nodes: Set[int]) -> List[Edge]:
        """Edges entering ``nodes`` from outside."""
        _in = self._in
        return [e for v in sorted(nodes) for e in _in[v]
                if e.src not in nodes]

    def boundary_out(self, nodes: Set[int]) -> List[Edge]:
        """Edges leaving ``nodes``."""
        _out = self._out
        return [e for v in sorted(nodes) for e in _out[v]
                if e.dst not in nodes]

    def is_connected(self, nodes: Set[int]) -> bool:
        """Weak connectivity of the induced subgraph (paper: subgraphs must be
        connected in G, otherwise meaningless)."""
        if not nodes:
            return False
        if len(nodes) == 1:
            return True
        und = self._und
        seen = set()
        stack = [next(iter(nodes))]
        while stack:
            v = stack.pop()
            if v in seen:
                continue
            seen.add(v)
            stack.extend(w for w in und[v] if w in nodes and w not in seen)
        return len(seen) == len(nodes)

    def weakly_connected_components(self, nodes: Set[int]) -> List[Set[int]]:
        if len(nodes) == 1:  # fast path: most GA groups are singletons
            return [set(nodes)]
        remaining = set(nodes)
        comps: List[Set[int]] = []
        und = self._und
        while remaining:
            root = next(iter(remaining))
            comp = set()
            stack = [root]
            while stack:
                v = stack.pop()
                if v in comp:
                    continue
                comp.add(v)
                # neighbours of an earlier component are never reachable, so
                # filtering against `remaining` equals filtering against the
                # full node set
                stack.extend(w for w in und[v]
                             if w in remaining and w not in comp)
            comps.append(comp)
            remaining -= comp
        return comps

    # -- totals -------------------------------------------------------------
    def total_weight_bytes(self) -> int:
        return sum(v.weight_bytes for v in self.nodes)

    def total_macs(self) -> int:
        return sum(v.macs for v in self.nodes)

    def total_act_bytes(self) -> int:
        return sum(v.out_bytes for v in self.nodes)

    def summary(self) -> str:
        return (
            f"{self.name}: {self.n} nodes, {len(self.edges)} edges, "
            f"{self.total_macs()/1e6:.1f} MMACs, "
            f"{self.total_weight_bytes()/1e6:.2f} MB weights, "
            f"{self.total_act_bytes()/1e6:.2f} MB activations"
        )


# ---------------------------------------------------------------------------
# Graph JSON: a documented import/export format for external netlists
# ---------------------------------------------------------------------------
#
# {
#   "format": "cocco-graph", "version": 1, "name": "<label>",
#   "nodes": [{"name", "out_len", "line_bytes", "weight_bytes", "macs",
#              "is_output"}, ...],            # index order == topological order
#   "edges": [{"src", "dst", "F", "s", "kind"}, ...]   # kind: sliding | full
# }
#
# Node order is significant (node i is the i-th entry; edges must satisfy
# src < dst), matching the in-memory invariant that insertion order is a
# valid topological order.  Optional node/edge fields take their dataclass
# defaults, so a minimal external netlist only needs names, shapes, and arcs.

GRAPH_FORMAT = "cocco-graph"
GRAPH_FORMAT_VERSION = 1


def graph_to_dict(g: Graph) -> Dict[str, Any]:
    """Serialize ``g`` to the documented Graph JSON dict (lossless)."""
    return {
        "format": GRAPH_FORMAT,
        "version": GRAPH_FORMAT_VERSION,
        "name": g.name,
        "nodes": [
            {
                "name": v.name,
                "out_len": v.out_len,
                "line_bytes": v.line_bytes,
                "weight_bytes": v.weight_bytes,
                "macs": v.macs,
                "is_output": v.is_output,
            }
            for v in g.nodes
        ],
        "edges": [
            {"src": e.src, "dst": e.dst, "F": e.F, "s": e.s, "kind": e.kind}
            for e in g.edges
        ],
    }


def graph_from_dict(d: Dict[str, Any]) -> Graph:
    """Build a :class:`Graph` from a Graph JSON dict, validating the format
    header, node dimensions (``out_len >= 1``, byte/MAC counts ``>= 0``),
    and — through ``add_node``/``add_edge`` — the construction-time
    invariants (topological edge order, window sanity, known edge kinds)."""
    if not isinstance(d, dict):
        raise ValueError(f"not a {GRAPH_FORMAT} document: expected a JSON "
                         f"object, got {type(d).__name__}")
    if d.get("format") != GRAPH_FORMAT:
        raise ValueError(f"not a {GRAPH_FORMAT} document "
                         f"(format={d.get('format')!r})")
    if d.get("version") != GRAPH_FORMAT_VERSION:
        raise ValueError(
            f"unsupported {GRAPH_FORMAT} version {d.get('version')!r} "
            f"(this build reads version {GRAPH_FORMAT_VERSION})")
    g = Graph(str(d.get("name", "graph")))
    for i, nd in enumerate(d.get("nodes", [])):
        try:
            name, out_len = str(nd["name"]), int(nd["out_len"])
            line_bytes = int(nd["line_bytes"])
        except KeyError as err:
            raise ValueError(
                f"node {i} is missing required key {err.args[0]!r} "
                f"(nodes need name, out_len, line_bytes)") from None
        wbytes, macs = int(nd.get("weight_bytes", 0)), int(nd.get("macs", 0))
        if out_len < 1 or line_bytes < 0 or wbytes < 0 or macs < 0:
            raise ValueError(
                f"node {i} ({name!r}) has invalid dimensions: "
                f"out_len={out_len} (need >=1), line_bytes={line_bytes}, "
                f"weight_bytes={wbytes}, macs={macs} (need >=0)")
        g.add_node(name, out_len, line_bytes, weight_bytes=wbytes,
                   macs=macs, is_output=bool(nd.get("is_output", False)))
    for i, ed in enumerate(d.get("edges", [])):
        try:
            src, dst = int(ed["src"]), int(ed["dst"])
        except KeyError as err:
            raise ValueError(
                f"edge {i} is missing required key {err.args[0]!r} "
                f"(edges need src, dst)") from None
        g.add_edge(src, dst, F=int(ed.get("F", 1)), s=int(ed.get("s", 1)),
                   kind=str(ed.get("kind", SLIDING)))
    if not g.nodes:
        raise ValueError(f"{GRAPH_FORMAT} document has no nodes")
    return g


def graph_to_json(g: Graph, indent: Optional[int] = 2) -> str:
    return json.dumps(graph_to_dict(g), indent=indent)


def graph_from_json(data: str) -> Graph:
    try:
        d = json.loads(data)
    except json.JSONDecodeError as err:
        raise ValueError(f"invalid graph JSON: {err}") from None
    return graph_from_dict(d)


def sequential_graph(
    layers: Sequence[Tuple[str, int, int, int, int, int, int]],
    name: str = "chain",
) -> Graph:
    """Build a plain chain. layers = [(name, out_len, line_bytes, wbytes, macs, F, s)].
    F, s describe the window each layer applies to its predecessor."""
    g = Graph(name)
    prev: Optional[int] = None
    for i, (lname, out_len, line_bytes, wb, macs, F, s) in enumerate(layers):
        idx = g.add_node(lname, out_len, line_bytes, wb, macs,
                         is_output=(i == len(layers) - 1))
        if prev is not None:
            g.add_edge(prev, idx, F=F, s=s)
        prev = idx
    return g
