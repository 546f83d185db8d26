"""Shared test graphs (previously scattered across test modules and pulled
in through fragile ``from tests.test_*`` imports).

Plain helpers (not fixtures) so hypothesis property tests can build fresh
graphs per example: ``from conftest import small_graph`` works because
pytest puts this directory on ``sys.path`` (rootdir insertion, no
``__init__.py`` here).
"""

from repro.core import Graph


def pytest_configure(config):
    # Regression guard for the jax-after-fork class of bugs: CPython warns
    # (and jax can deadlock) when a process pool forks a process that
    # already imported the multithreaded jax runtime.  The engine's pools
    # switch to the forkserver start method once jax is loaded
    # (repro.core.engine.pool_mp_context), so any reappearance of this
    # warning is a real bug — fail loudly instead of scrolling by.
    config.addinivalue_line(
        "filterwarnings",
        "error:os\\.fork\\(\\) was called:RuntimeWarning")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA GPU; skips with a reason where there is none")


def small_graph():
    """An 8-node two-diamond graph."""
    g = Graph("dd")
    n = [g.add_node(f"n{i}", 32, 16, weight_bytes=256, macs=10_000)
         for i in range(8)]
    edges = [(0, 1), (0, 2), (1, 3), (2, 3), (3, 4), (4, 5), (4, 6), (5, 7),
             (6, 7)]
    for a, b in edges:
        g.add_edge(n[a], n[b], F=1, s=1)
    g.nodes[n[7]].is_output = True
    return g


def chain_graph(length=64, specs=((3, 1), (3, 2), (2, 1))):
    """A 1D conv chain; returns (graph, internal-node set)."""
    g = Graph("chain")
    prev = g.add_node("in", length, 1)
    nodes = []
    cur = length
    for i, (F, s) in enumerate(specs):
        cur = (cur - F) // s + 1
        idx = g.add_node(f"l{i}", cur, 1)
        g.add_edge(prev, idx, F=F, s=s)
        nodes.append(idx)
        prev = idx
    g.nodes[prev].is_output = True
    return g, set(nodes)


def fig5_like_graph():
    """A 1D two-input diamond with heterogeneous kernels/strides, in the
    spirit of the paper's Fig. 5 example: output nodes drive backward
    derivation with LCM alignment."""
    g = Graph("fig5")
    n_m2 = g.add_node("in-2", out_len=64, line_bytes=1)       # input node -2
    n_m1 = g.add_node("in-1", out_len=33, line_bytes=1)       # input node -1
    n0 = g.add_node("n0", out_len=30, line_bytes=1)           # F=4, s=2 on in-2
    n1 = g.add_node("n1", out_len=31, line_bytes=1)           # F=3/s=2 ; F=3/s=1
    n2 = g.add_node("n2", out_len=31, line_bytes=1)           # F=3, s=1 on in-1
    n3 = g.add_node("n3", out_len=30, line_bytes=1, is_output=True)
    n4 = g.add_node("n4", out_len=30, line_bytes=1, is_output=True)
    g.add_edge(n_m2, n0, F=4, s=2)
    g.add_edge(n_m2, n1, F=3, s=2)
    g.add_edge(n_m1, n1, F=3, s=1)   # n1 merges two inputs (strides 2 and 1)
    g.add_edge(n_m1, n2, F=3, s=1)
    g.add_edge(n0, n3, F=1, s=1)
    g.add_edge(n1, n3, F=2, s=1)
    g.add_edge(n1, n4, F=2, s=1)
    g.add_edge(n2, n4, F=2, s=1)
    return g, (n_m2, n_m1, n0, n1, n2, n3, n4)
