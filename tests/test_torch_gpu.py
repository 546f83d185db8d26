"""The port's LM kernels on the card (marked ``gpu``; each test skips
where there is no CUDA GPU, deciding inside the test).

This file imports neither jax nor the JAX package, so it also runs on a GPU
machine without them:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

* every CUDA kernel against its plain version at the serving path's shapes
  and at ragged ones, in bf16 and fp32 (``chip_smoke.py``'s phase, with its
  tolerances);
* the smoke tinyllama served through the CUDA kernels and through their
  plain versions on the CPU gives the same greedy tokens, with each kernel
  launched as often as the model's structure implies.
"""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions_on_the_card():
    needs_gpu()
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    errs = chip_smoke.phase_lm_kernels_vs_plain()
    assert {name for name, _ in errs} == set(chip_smoke.LM_KERNELS)


@pytest.mark.gpu
def test_engine_on_the_card_equals_the_cpu():
    needs_gpu()
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, fused_ffn, rmsnorm
    from repro_torch.models import lm_init, param_values
    from repro_torch.models.layers import tree_map
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    cfg = get_config("tinyllama-1.1b", smoke=True)
    values = param_values(lm_init(cfg, torch.Generator().manual_seed(0)))
    prompts = np.random.default_rng(4).integers(0, cfg.vocab, (3, 40))
    outs = []
    for vals in (values, tree_map(lambda t: t.cuda(), values)):
        for mod in (flash_attention, fused_ffn, rmsnorm):
            mod.launches = 0
        eng = ServeEngine(cfg, vals, ServeConfig(max_batch=3, max_len=64))
        outs.append(eng.generate([Request(rid=i, prompt=p, max_new_tokens=6)
                                  for i, p in enumerate(prompts)]))
    assert outs[0] == outs[1]
    assert flash_attention.launches == cfg.n_layers       # one prefill
    assert fused_ffn.launches == 6 * cfg.n_layers         # six forwards
    assert rmsnorm.launches == 6 * (2 * cfg.n_layers + 1)
