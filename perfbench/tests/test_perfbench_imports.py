"""What a run loads: a run with ``jax`` and the JAX package blocked loads
no module whose top-level name, compared whole, is ``jax``, ``jaxlib``,
``flax`` or ``repro`` (the port's ``repro_torch`` begins with ``repro``
and is not one of them); and the reference imports nothing of the
program."""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

BLOCKER = textwrap.dedent("""
    import importlib.abc, sys
    BLOCKED = ("jax", "jaxlib", "flax", "repro")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, Block())
    sys.path[0:0] = [{root!r}, {src!r}]
""").format(root=str(ROOT), src=str(ROOT / "src"))


def _python(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", BLOCKER + code],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_a_run_loads_neither_jax_nor_the_jax_package():
    out = _python(textwrap.dedent("""
        import time, json, torch
        torch.set_num_threads(2)
        import perfbench.run  # noqa: F401  (the entry's own imports)
        from perfbench import control, harness, spec
        from perfbench.tests import smoke_cells
        for name in json.load(open("BENCHMARK.json"))["per_layer"]:
            spec.reader(name["name"])
        r = harness.execute(smoke_cells.cell("jamba-v0.1-52b"), 3, 0.1, 0,
                            "cpu", time.perf_counter())
        assert r["correct"], r
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    """))
    tops = set(__import__("json").loads(out.splitlines()[-1]))
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_a_run_that_loaded_the_jax_package_prints_no_result(capsys,
                                                          monkeypatch):
    from perfbench import harness

    monkeypatch.setattr(harness.spec, "cell", lambda name: {"chips": 1})
    monkeypatch.setattr(harness, "execute", lambda *a: {"checks": {}})
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    monkeypatch.setattr("torch.cuda.device_count", lambda: 1)
    monkeypatch.setitem(sys.modules, "repro.stub", sys)
    assert harness.main(["--workload", "x", "--seed", "1", "--seconds",
                         "1"]) == 3
    out = capsys.readouterr()
    assert out.out == "" and "repro.stub" in out.err


def test_forbidden_modules_compares_whole_top_level_names():
    from perfbench.harness import forbidden_modules

    before = dict(sys.modules)
    try:
        sys.modules["repro_torch_like"] = sys
        sys.modules["reprox.y"] = sys
        assert forbidden_modules() == sorted(
            m for m in before if m.split(".")[0] in
            ("jax", "jaxlib", "flax", "repro"))
        sys.modules["repro.core"] = sys
        assert "repro.core" in forbidden_modules()
    finally:
        for m in ("repro_torch_like", "reprox.y", "repro.core"):
            sys.modules.pop(m, None)


def test_the_reference_imports_nothing_of_the_program():
    out = _python(textwrap.dedent("""
        import perfbench.reference, perfbench.check
        print(sorted(m for m in sys.modules if m.startswith("repro")))
    """))
    assert out.strip().splitlines()[-1] == "[]"
    allowed = {"__future__", "math", "typing", "torch",
               "torch.nn.functional"}
    for path in (ROOT / "perfbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:       # the reference's own modules
                    continue
                names = [node.module]
            else:
                continue
            assert set(names) <= allowed, (path.name, names)
