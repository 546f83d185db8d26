"""The port's CLI, store addressing, import boundary and card smoke phase.

* ``python -m repro_torch --device cpu explore`` round-trips through
  ``--save-spec``/``--spec`` and writes the same artifact as the JAX
  package's CLI;
* ``--device cuda`` (the default) without a GPU exits 2 with ``error:``;
* ``spec_key`` and ``graph_fingerprint`` give the reference's digests, so
  a store written by either package replays in the other;
* no module of ``repro_torch``, and not ``chip_smoke.py``, imports jax or
  the JAX package;
* the kernel-against-plain phase of ``chip_smoke.py`` runs on a card
  (marked ``gpu``; skips without one).
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from test_golden_workloads import CASES, WORKLOADS, golden_spec  # noqa: E402

from repro.api import ResultStore as RefStore  # noqa: E402
from repro.api import build_workload as ref_build_workload  # noqa: E402
from repro.api import graph_fingerprint as ref_fingerprint  # noqa: E402
from repro.api import run as ref_run  # noqa: E402
from repro.api import spec_key as ref_spec_key  # noqa: E402
from repro.api.cli import main as ref_main  # noqa: E402
from repro.core.graph import graph_to_json  # noqa: E402
from repro_torch.api import ResultStore, build_workload, graph_fingerprint  # noqa: E402
from repro_torch.api import run, spec_key  # noqa: E402
from repro_torch.api.cli import main  # noqa: E402
from repro_torch.bridge import graph_from_reference, spec_from_reference  # noqa: E402
from repro_torch.core.engine import BACKENDS  # noqa: E402
from repro_torch.core.graph import graph_to_json as port_graph_to_json  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
EXPLORE = ["explore", "--workload", "synthetic:layered:24?seed=7",
           "--strategy", "ga", "--metric", "energy", "--alpha", "0.002",
           "--hw-mode", "shared", "--budget", "200", "--opt",
           "population=10"]


def test_cpu_explore_spec_round_trip_matches_reference_cli(tmp_path,
                                                           capsys):
    spec, first, replay, ref = (tmp_path / f for f in (
        "spec.json", "first.json", "replay.json", "ref.json"))
    assert main(["--device", "cpu", *EXPLORE, "--save-spec", str(spec),
                 "--out", str(first)]) == 0
    assert main(["--device", "cpu", "explore", "--spec", str(spec),
                 "--out", str(replay)]) == 0
    assert ref_main(["explore", "--spec", str(spec), "--out",
                     str(ref)]) == 0
    capsys.readouterr()
    assert replay.read_text() == first.read_text() == ref.read_text()


@pytest.mark.parametrize("device_args", [[], ["--device", "cuda"]],
                         ids=["default", "cuda"])
def test_cuda_without_gpu_exits_2(device_args, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    assert main([*device_args, *EXPLORE]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error:") and "--device cpu" in err


def test_unknown_eval_backend_exits_2_listing_backends(capsys):
    assert main(["--device", "cpu", *EXPLORE, "--eval-backend", "jax"]) == 2
    err = capsys.readouterr().err
    assert "unknown eval backend 'jax'" in err
    for backend in BACKENDS:
        assert backend in err


def test_eval_jobs_without_the_process_backend_exits_2(capsys):
    assert main(["--device", "cpu", *EXPLORE, "--eval-jobs", "2"]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error:") and "--eval-backend process" in err


def test_workloads_ls_lists_the_reference_uris_but_tpu(capsys):
    # every URI of the reference, tpu: included; the scheme table differs
    # only where the file: scheme names its package's graph_to_json
    assert main(["workloads", "ls", "--json"]) == 0
    port = json.loads(capsys.readouterr().out)
    assert ref_main(["workloads", "ls", "--json"]) == 0
    ref = json.loads(capsys.readouterr().out)
    assert [s["name"] for s in port["schemes"]] == \
        ["file", "netlib", "synthetic", "tpu"]
    assert port["workloads"] == ref["workloads"]
    assert any(w["scheme"] == "tpu" for w in port["workloads"])
    for s in port["schemes"]:
        s["description"] = s["description"].replace("repro_torch.", "repro.")
    assert port == ref
    for args in (["--uris-only"], ["--uris-only", "--scheme", "tpu"], []):
        assert main(["workloads", "ls", *args]) == 0
        port_text = capsys.readouterr().out
        assert ref_main(["workloads", "ls", *args]) == 0
        ref_text = capsys.readouterr().out
        # the default view's rows after the scheme table (its templates)
        assert port_text.split("\n\n")[-1] == ref_text.split("\n\n")[-1]


@pytest.mark.parametrize("workload_key,strategy", CASES)
def test_spec_key_equals_reference(workload_key, strategy):
    ref_spec = golden_spec(workload_key, strategy)
    assert spec_key(spec_from_reference(ref_spec.to_json())) == \
        ref_spec_key(ref_spec)


@pytest.mark.parametrize("workload_key", sorted(WORKLOADS))
def test_graph_fingerprint_equals_reference(workload_key):
    uri = WORKLOADS[workload_key]
    ref_g = ref_build_workload(uri)
    want = ref_fingerprint(ref_g)
    assert graph_fingerprint(graph_from_reference(graph_to_json(ref_g))) \
        == want
    assert graph_fingerprint(build_workload(uri)) == want


def _tpu_uris():
    from repro.configs import ARCHS, get_config

    return [f"tpu:{arch}:{layer}{query}" for arch in ARCHS
            for layer in sorted({0, get_config(arch).n_layers - 1})
            for query in ("", "?tokens=4096&tp=4")]


@pytest.mark.parametrize("uri", _tpu_uris())
def test_tpu_block_graph_equals_reference(uri):
    ref_g = ref_build_workload(uri)
    g = build_workload(uri)
    assert graph_fingerprint(g) == ref_fingerprint(ref_g)
    assert port_graph_to_json(g) == graph_to_json(ref_g)


@pytest.mark.parametrize("uri,match", [
    ("tpu:gemma3-4b", "needs a layer index"),
    ("tpu:gemma3-4b:x", "must be an integer"),
    ("tpu:nope:0", "unknown tpu config"),
    ("tpu:gemma3-4b:9999", "out of range"),
    ("tpu:gemma3-4b:0?bogus=1", "bogus"),
])
def test_tpu_scheme_errors_equal_reference(uri, match):
    with pytest.raises(ValueError, match=match) as ref_err:
        ref_build_workload(uri)
    with pytest.raises(ValueError, match=match) as port_err:
        build_workload(uri)
    assert str(port_err.value) == str(ref_err.value)
    assert graph_fingerprint(build_workload("tpu:gemma3_4b:0")) == \
        ref_fingerprint(ref_build_workload("tpu:gemma3-4b:0"))


def test_store_written_by_either_package_replays_in_the_other(tmp_path):
    ref_spec = golden_spec("synthetic_layered24", "ga")
    spec = spec_from_reference(ref_spec.to_json())
    ref_res = ref_run(ref_spec, store=RefStore(tmp_path / "a"))
    port_store = ResultStore(tmp_path / "a")
    assert run(spec, store=port_store, device="cpu").to_json() == \
        ref_res.to_json()
    assert port_store.hits == 1
    port_res = run(spec, store=ResultStore(tmp_path / "b"), device="cpu")
    ref_store = RefStore(tmp_path / "b")
    assert ref_run(ref_spec, store=ref_store).to_json() == \
        port_res.to_json()
    assert ref_store.hits == 1


def test_port_imports_neither_jax_nor_the_reference():
    modules = sorted(
        ".".join(p.relative_to(SRC).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in (SRC / "repro_torch").rglob("*.py"))
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path[:0] = [{str(SRC)!r}, {str(ROOT)!r}]\n"
        f"for name in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'repro.')) or m == 'repro']\n"
        "assert all(sys.modules[m] is None for m in bad), bad\n"
        "print(len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "repro_torch.core.engine" in modules
    assert "repro_torch.__main__" in modules


def test_chip_smoke_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    assert proc.returncode == 2
    assert '"ok"' not in proc.stdout and "CUDA GPU" in proc.stderr


def test_chip_smoke_refuses_to_run_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"],
                          capture_output=True, text=True, timeout=300,
                          cwd=tmp_path)
    assert proc.returncode == 2
    assert '"ok"' not in proc.stdout and "checkout" in proc.stderr


@pytest.mark.gpu
def test_chip_smoke_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    assert chip_smoke.phase_kernel_vs_plain() == 0
