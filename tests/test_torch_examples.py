"""The port's examples (``examples/*_torch.py``) against the JAX package's,
on the CPU.

* quickstart: the port's output on ``--device cpu`` is the reference
  example's, byte for byte;
* plan search: each line is ``plan_h100(...).summary()`` on the CPU;
* serve_lm: with the reference's weights bridged, the port's functions
  print the reference example's plans and tokens (the plan latency masked);
* train_tinylm: from the reference's initial state, ``--tiny --steps 4``
  gives the reference's four losses within 1e-5 (the tolerance
  ``tests/test_torch_trainstep.py`` holds one train step to); ``--steps``
  and ``--tiny`` are honoured (the reference ignores both) and no module
  state is left changed; a rerun with nothing left to train exits 0;
* every example and ``scripts/smoke_serve_plans_torch.py`` exit 2 on
  ``--device cuda`` without a GPU.
"""

import importlib.util
import re
import runpy
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro.models import lm_init as ref_lm_init  # noqa: E402
from repro.models import param_values as ref_param_values  # noqa: E402
from repro_torch.api import ResultStore, plan_h100  # noqa: E402
from repro_torch.bridge import lm_params_from_reference  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.serve import PlanService  # noqa: E402
from repro_torch.train import adamw_init  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
LATENCY = re.compile(r" in \d+\.\dms$", re.M)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs files on parallel workers: this file's small torch
    work takes two intra-op threads, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def load(path: Path):
    """The port's example or script at ``path``, imported as a module."""
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_example(name: str, monkeypatch) -> dict:
    """The globals of the reference's ``examples/<name>.py``, imported with
    ``sys.argv`` restored after the test (``train_tinylm.py`` resets it)."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py"])
    return runpy.run_path(str(EXAMPLES / f"{name}.py"),
                          run_name=f"reference_{name}")


def bridged_weights(arch: str):
    jvals = ref_param_values(ref_lm_init(jax.random.PRNGKey(0),
                                         ref_get_config(arch, smoke=True)))
    return lm_params_from_reference(jax.tree.map(np.asarray, jvals))


def test_quickstart_prints_the_reference_bytes(monkeypatch, capsys):
    reference_example("quickstart", monkeypatch)["main"]()
    want = capsys.readouterr().out
    assert load(EXAMPLES / "quickstart_torch.py").main(
        ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want
    assert "result JSON: 116809 bytes" in want


@pytest.mark.parametrize("args", [["--arch", "tinyllama-1.1b"], []],
                         ids=["one_arch", "all_archs"])
def test_plan_search_prints_plan_h100_summaries(args, capsys):
    mod = load(EXAMPLES / "cocco_plan_search_torch.py")
    assert mod.main(["--device", "cpu", "--samples", "300", *args]) == 0
    archs = [args[1]] if args else ARCHS
    assert capsys.readouterr().out.splitlines() == [
        plan_h100(a, sample_budget=300, device="cpu").summary()
        for a in archs]


def test_serve_lm_with_the_reference_weights_prints_its_plans_and_tokens(
        monkeypatch, capsys, tmp_path):
    reference_example("serve_lm", monkeypatch)["main"]()
    want = capsys.readouterr().out
    mod = load(EXAMPLES / "serve_lm_torch.py")
    rng = np.random.default_rng(0)
    planner = PlanService(ResultStore(tmp_path / "plans"), device="cpu")
    try:
        for arch in ("tinyllama-1.1b", "xlstm-350m"):
            mod.serve_decoder(arch, bridged_weights(arch), planner, rng)
        mod.transcribe(bridged_weights("whisper-base"), planner, rng)
    finally:
        planner.close()
    got = capsys.readouterr().out
    assert LATENCY.sub(" in …ms", got) == LATENCY.sub(" in …ms", want)
    assert want.count("served_from=search in") == 3
    assert want.count(" -> [") == 10


def _spy(monkeypatch, module, name, record):
    """Wrap ``module.name`` to append each call's result to ``record``."""
    inner = getattr(module, name)

    def spying(*args, **kwargs):
        record.append(inner(*args, **kwargs))
        return record[-1]

    monkeypatch.setattr(module, name, spying)


class _StepLosses:
    """``jax`` for ``repro.launch.train``, whose jitted train step's losses
    are recorded as the step returns them."""

    def __init__(self):
        self.losses = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kwargs):
        compiled = jax.jit(fn, **kwargs)

        def call(*args):
            out = compiled(*args)
            if isinstance(out, tuple) and len(out) == 3 and "loss" in out[2]:
                self.losses.append(float(out[2]["loss"]))
            return out

        return call


def test_train_tiny_matches_the_reference_losses(monkeypatch, capsys,
                                                 tmp_path):
    ref = reference_example("train_tinylm", monkeypatch)
    recorder = _StepLosses()
    monkeypatch.setattr(ref_train, "jax", recorder)
    monkeypatch.setattr(sys, "argv", ["train_tinylm.py", "--tiny",
                                      "--steps", "4"])
    (tmp_path / "ref").mkdir()
    monkeypatch.chdir(tmp_path / "ref")
    ref["main"]()
    want = capsys.readouterr().out.splitlines()[-1]

    bridged = bridged_weights("tinyllama-1.1b")
    monkeypatch.setattr(port_train, "build_state",
                        lambda cfg, opt_cfg, device, seed=0, mesh=None:
                        (bridged, adamw_init(bridged, opt_cfg)))
    runs = []
    _spy(monkeypatch, port_train, "run", runs)
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    assert load(EXAMPLES / "train_tinylm_torch.py").main(
        ["--device", "cpu", "--tiny", "--steps", "4"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == want
    assert [s for s, _ in runs[0]["losses"]] == [0, 1, 2, 3]
    assert len(recorder.losses) == 4
    np.testing.assert_allclose([loss for _, loss in runs[0]["losses"]],
                               recorder.losses, rtol=1e-5, atol=1e-5)


def test_train_honours_steps_and_tiny_and_resumes_with_nothing_to_train(
        monkeypatch, capsys, tmp_path):
    monkeypatch.chdir(tmp_path)
    smoke = get_config("tinyllama-1.1b", smoke=True)
    mod = load(EXAMPLES / "train_tinylm_torch.py")
    runs = []
    _spy(monkeypatch, port_train, "run", runs)
    assert mod.main(["--device", "cpu", "--tiny", "--steps", "5"]) == 0
    assert [s for s, _ in runs[0]["losses"]] == [0, 1, 2, 3, 4]
    assert (runs[0]["state"]["params"]["embed"].shape
            == (smoke.vocab, smoke.d_model))
    assert capsys.readouterr().out.splitlines()[-1].startswith("loss ")
    # the checkpoint holds step 5: a rerun trains nothing and says so
    assert mod.main(["--device", "cpu", "--tiny", "--steps", "5"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 5" in out and "nothing left to train" in out
    assert runs[1]["steps"] == 0
    assert get_config("tinyllama-1.1b", smoke=True) is smoke


def test_train_default_routes_the_100m_config_and_restores_the_smoke_one(
        monkeypatch, capsys):
    """Without ``--tiny`` the run sees the ~100M config, for ``--steps``
    steps; after it, the smoke config is what it was (the run is stubbed:
    the 100M config is the card's)."""
    smoke = get_config("tinyllama-1.1b", smoke=True)
    seen = []

    def fake_run(args):
        seen.append((get_config(args.arch, smoke=args.smoke), args))
        return {"first_loss": 10.0, "last_loss": 9.0}

    monkeypatch.setattr(port_train, "run", fake_run)
    mod = load(EXAMPLES / "train_tinylm_torch.py")
    assert mod.main(["--device", "cpu", "--steps", "7"]) == 0
    assert "training ~" in capsys.readouterr().out
    (cfg, args), = seen
    assert cfg is mod.SMALL and args.steps == 7 and args.model_parallel is None
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab,
            cfg.compute_dtype) == (8, 768, 2048, 32_000, "float32")
    assert (args.batch, args.seq, args.microbatches, args.fail_at,
            args.save_every) == (4, 256, 2, 60, 50)
    assert get_config("tinyllama-1.1b", smoke=True) is smoke


@pytest.mark.parametrize("path", [
    "examples/quickstart_torch.py", "examples/cocco_plan_search_torch.py",
    "examples/serve_lm_torch.py", "examples/train_tinylm_torch.py",
    "scripts/smoke_serve_plans_torch.py"])
def test_cuda_without_a_gpu_exits_2(path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    assert load(ROOT / path).main(["--device", "cuda"]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error:") and "--device cpu" in err
