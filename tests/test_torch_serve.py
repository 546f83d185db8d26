"""The port's serving engine and its CLI driver, on the CPU.

Greedy tokens must equal the JAX package's ``ServeEngine``'s, token for
token, on the decoder cases of ``tests/test_serve.py`` (a single prompt,
equal-length requests batched across groups, and gemma3's sliding-window
ring cache past its wrap), with the reference's parameters carried over by
the weight bridge.
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm_init as jax_lm_init  # noqa: E402
from repro.models import param_values as jax_param_values  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.bridge import lm_params_from_reference  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import main  # noqa: E402
from repro_torch.serve import Request, ServeConfig, ServeEngine  # noqa: E402

# (arch, rng seed, number of prompts, prompt length, new tokens, max_batch,
#  max_len): tests/test_serve.py:36, :46 and :59
CASES = [("tinyllama-1.1b", 0, 1, 7, 6, 4, 64),
         ("tinyllama-1.1b", 1, 5, 5, 4, 3, 32),
         ("gemma3-4b", 3, 1, 20, 8, 2, 48)]


@pytest.mark.parametrize("case", CASES,
                         ids=["single", "batched", "ring-cache"])
def test_greedy_tokens_equal_the_jax_engine(case):
    arch, seed, n, plen, new, max_batch, max_len = case
    jcfg = jax_get_config(arch, smoke=True)
    jvals = jax_param_values(jax_lm_init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, jcfg.vocab, plen).astype(np.int32)
               for _ in range(n)]
    want = JaxServeEngine(jcfg, jvals, JaxServeConfig(
        max_batch=max_batch, max_len=max_len)).generate(
        [JaxRequest(rid=i, prompt=p, max_new_tokens=new)
         for i, p in enumerate(prompts)])
    eng = ServeEngine(get_config(arch, smoke=True),
                      lm_params_from_reference(jax.tree.map(np.asarray,
                                                            jvals)),
                      ServeConfig(max_batch=max_batch, max_len=max_len))
    got = eng.generate([Request(rid=i, prompt=p, max_new_tokens=new)
                        for i, p in enumerate(prompts)])
    assert got == want
    assert [s["batch"] for s in eng.stats] == [
        min(max_batch, n - i) for i in range(0, n, max_batch)]
    assert all(s["decode_steps"] == new - 1 for s in eng.stats)


def test_cli_serves_on_the_cpu(capsys):
    assert main(["--device", "cpu", "--smoke", "--requests", "3",
                 "--prompt-len", "9", "--new-tokens", "4",
                 "--max-batch", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    reqs = [line for line in out if line.startswith("req ")]
    groups = [line for line in out if line.startswith("group: ")]
    assert len(reqs) == 3 and len(groups) == 2
    assert out[-1].startswith("12 tokens in ")


def test_cli_cuda_without_a_gpu_exits_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    assert main(["--smoke"]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error:") and "--device cpu" in err


@pytest.mark.parametrize("arch,item", [("xlstm-350m", "A3"),
                                       ("whisper-base", "A4")])
def test_cli_refuses_unported_archs(arch, item, capsys):
    assert main(["--device", "cpu", "--smoke", "--arch", arch]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error:") and f"ROADMAP {item}" in err


LM_MODULES = ("repro_torch.configs", "repro_torch.configs.tinyllama_1_1b",
              "repro_torch.models", "repro_torch.models.config",
              "repro_torch.models.layers", "repro_torch.models.blocks",
              "repro_torch.models.lm", "repro_torch.kernels.ref",
              "repro_torch.kernels.ops", "repro_torch.kernels.rmsnorm",
              "repro_torch.kernels.fused_ffn",
              "repro_torch.kernels.flash_attention", "repro_torch.bridge",
              "repro_torch.serve", "repro_torch.serve.engine",
              "repro_torch.launch", "repro_torch.launch.serve")


def test_lm_modules_import_neither_jax_nor_the_reference():
    """The import guard of ``tests/test_torch_cli.py`` for the LM slice's
    modules, each named: jax and ``repro`` are blocked, the modules import,
    and neither blocked name was reached."""
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    for name in LM_MODULES:
        assert (src / Path(*name.split("."))).with_suffix(".py").is_file() \
            or (src / Path(*name.split(".")) / "__init__.py").is_file(), name
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path[:0] = [{str(src)!r}]\n"
        f"for name in {LM_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'repro.')) or m == 'repro']\n"
        "assert all(sys.modules[m] is None for m in bad), bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
