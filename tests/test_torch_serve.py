"""The port's serving engine and its CLI driver, on the CPU.

Greedy tokens must equal the JAX package's ``ServeEngine``'s, token for
token, on the decoder cases of ``tests/test_serve.py`` (a single prompt,
equal-length requests batched across groups, and gemma3's sliding-window
ring cache past its wrap), on jamba's hybrid caches (Mamba states and an
attention ring), arctic's MoE, deepseek's MLA latent cache and xlstm's
mLSTM and sLSTM states (prompts past 4 tokens take mLSTM's chunked form,
shorter ones its unrolled recurrence), with the reference's parameters
carried over by the weight bridge.
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import json  # noqa: E402

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
         ("gemma3-4b", 3, 1, 20, 8, 2, 48),
         ("jamba-v0.1-52b", 2, 3, 9, 6, 2, 32),
         ("arctic-480b", 4, 3, 10, 5, 2, 32),
         ("deepseek-v2-236b", 5, 3, 9, 6, 2, 32),
         ("xlstm-350m", 6, 3, 9, 6, 2, 32),
         ("xlstm-350m", 7, 2, 3, 6, 2, 16)]


@pytest.mark.parametrize("case", CASES,
                         ids=["single", "batched", "ring-cache", "hybrid",
                              "moe", "mla", "xlstm", "xlstm-short"])
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


def test_default_engine_equals_the_jax_default_engine_in_bf16(monkeypatch):
    """At their defaults both engines keep an fp32 cache, which promotes a
    bf16 model's residual stream to fp32 after the first attention layer:
    the same prefill logits (within bf16's 2e-2) and the same greedy
    tokens on the bf16 tinyllama smoke config.

    The reference scans its layers, and ``lax.scan`` refuses a carry whose
    dtype the fp32 cache changes (bf16 in, fp32 out: a TypeError), so here
    it runs every layer unrolled (its ``_layer_groups`` returns all layers
    as the unrolled prefix), which is the same function; its parameters are
    restacked for the port's scanned layout."""
    import jax.numpy as jnp

    import repro.models.lm as jax_lm
    from repro.models import init_caches as jax_init_caches
    from repro_torch.models import init_caches, lm_apply

    monkeypatch.setattr(jax_lm, "_layer_groups",
                        lambda c: (c.n_layers, 0, 0, 0))
    jcfg = jax_get_config("tinyllama-1.1b", smoke=True).with_(
        compute_dtype="bfloat16")
    cfg = get_config("tinyllama-1.1b", smoke=True).with_(
        compute_dtype="bfloat16")
    jvals = jax_param_values(jax_lm_init(jax.random.PRNGKey(0), jcfg))
    tree = jax.tree.map(np.asarray, jvals)
    layers = [tree["pre"][f"q{j}"] for j in range(cfg.n_layers)]
    tree = {**{k: v for k, v in tree.items() if k != "pre"}, "pre": {},
            "scan": {"p0": jax.tree.map(lambda *a: np.stack(a), *layers)},
            "rest": {}}
    prompts = np.random.default_rng(5).integers(
        0, jcfg.vocab, (2, 11)).astype(np.int32)
    jscfg = JaxServeConfig(max_batch=2, max_len=32)
    scfg = ServeConfig(max_batch=2, max_len=32)
    assert jscfg.cache_dtype == jnp.float32
    assert scfg.cache_dtype is torch.float32
    jeng = JaxServeEngine(jcfg, jvals, jscfg)
    eng = ServeEngine(cfg, lm_params_from_reference(tree), scfg)

    jcaches = jax_init_caches(jcfg, 2, 32, jscfg.cache_dtype)
    caches = init_caches(cfg, 2, 32, eng.cache_dtype)
    assert caches["scan"]["p0"]["k"].dtype == torch.float32
    want, _ = jeng._prefill(jeng.values, jcaches, jnp.asarray(prompts))
    got, _, _ = lm_apply(eng.values, cfg, torch.from_numpy(
        prompts.astype(np.int64)), caches=caches, prefill=True,
        last_only=True)
    np.testing.assert_allclose(got[:, -1].float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)
    assert eng.generate([Request(rid=i, prompt=p, max_new_tokens=6)
                         for i, p in enumerate(prompts)]) == jeng.generate(
        [JaxRequest(rid=i, prompt=p, max_new_tokens=6)
         for i, p in enumerate(prompts)])


def test_cli_serves_on_the_cpu(capsys):
    assert main(["--device", "cpu", "--smoke", "--requests", "3",
                 "--prompt-len", "9", "--new-tokens", "4",
                 "--max-batch", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    reqs = [line for line in out if line.startswith("req ")]
    groups = [line for line in out if line.startswith("group: ")]
    assert len(reqs) == 3 and len(groups) == 2
    assert out[-1].startswith("12 tokens in ")


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "arctic-480b"])
def test_cli_serves_the_moe_and_hybrid_archs_on_the_cpu(arch, capsys):
    assert main(["--device", "cpu", "--arch", arch, "--smoke"]) == 0
    out = capsys.readouterr().out.splitlines()
    reqs = [line for line in out if line.startswith("req ")]
    assert len(reqs) == 6
    assert all(len(json.loads(line.split(": ", 1)[1])) == 8
               for line in reqs)
    assert out[-1].startswith("48 tokens in ")


def test_cli_cuda_without_a_gpu_exits_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    assert main(["--smoke"]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error:") and "--device cpu" in err


@pytest.mark.parametrize("arch,item", [("xlstm-350m", "A3"),
                                       ("deepseek-v2-236b", "A3"),
                                       ("whisper-base", "A4")])
def test_cli_refuses_unported_archs(arch, item, capsys):
    """whisper-base's encoder-decoder (A4) exits 2 naming its item; A3's
    archs (xlstm-350m, deepseek-v2-236b) are ported and served."""
    rc = main(["--device", "cpu", "--smoke", "--arch", arch])
    out, err = capsys.readouterr()
    if item == "A3":
        assert rc == 0 and not err
        reqs = [line for line in out.splitlines() if line.startswith("req ")]
        assert len(reqs) == 6
        assert all(len(json.loads(line.split(": ", 1)[1])) == 8
                   for line in reqs)
        return
    assert rc == 2
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
