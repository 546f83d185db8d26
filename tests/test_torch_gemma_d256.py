"""gemma3-4b at its own head width (d_head 256) in the port, on the CPU.

gemma3-4b's attention is 8 heads of 256 columns over 4 kv heads, with
qk-norm and a 1,024-key sliding window on 5 of every 6 layers; on the card
its prefill goes through the flash-attention kernel's d-256 route.  Here it
is cut to 2 layers at d_model 256 (``local_global_period`` 2: layer 0
windowed, layer 1 global; window 16), fp32, with the smoke config's
vocab and d_ff:

* the uncached forward at S 40 equals the JAX package's from the same
  bridged weights within 1e-5;
* ``ServeEngine``'s greedy tokens equal the JAX engine's under the default
  fp32 cache and under a bf16 cache (the model is fp32, so the reference's
  ``lax.scan`` carry, which a cache of another dtype would change, keeps
  its dtype);
* every prefill reaches B2 (recorded through ``ops.flash_attention_op``)
  at widths 256 x 256, window 16 on the local layer and none on the
  global one;
* a port-only case: the same config in bf16 under the default fp32 cache
  hands B2 fp32 q, k and v wherever it attends over the cache's dtype.
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm_apply as jax_lm_apply  # noqa: E402
from repro.models import lm_init as jax_lm_init  # noqa: E402
from repro.models import param_values as jax_param_values  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.bridge import lm_params_from_reference  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_plain)
from repro_torch.models import lm_apply  # noqa: E402
from repro_torch.models.config import ATTN, ATTN_LOCAL  # noqa: E402
from repro_torch.serve import Request, ServeConfig, ServeEngine  # noqa: E402

ARCH = "gemma3-4b"
# gemma3-4b's attention widths at a CPU-sized depth and model width
GEMMA_D256 = dict(d_head=256, n_heads=8, n_kv_heads=4, d_model=256,
                  n_layers=2, local_global_period=2, sliding_window=16)
WINDOW = GEMMA_D256["sliding_window"]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def gemma():
    """(port cfg, JAX cfg, JAX values, bridged port values)."""
    jcfg = jax_get_config(ARCH, smoke=True).with_(**GEMMA_D256)
    cfg = get_config(ARCH, smoke=True).with_(**GEMMA_D256)
    assert cfg.qk_norm and cfg.head_dim == 256 and not cfg.logit_softcap
    assert [s.mixer for s in cfg.block_specs()] == [ATTN_LOCAL, ATTN]
    jvals = jax_param_values(jax_lm_init(jax.random.PRNGKey(0), jcfg))
    return cfg, jcfg, jvals, lm_params_from_reference(
        jax.tree.map(np.asarray, jvals))


@pytest.fixture
def b2_calls(monkeypatch):
    """Every call of ``ops.attention`` taken as a call of B2's op (as on the
    card), recorded as (q/k width x v width, window, q, k, v dtypes), and
    answered by the plain version; the other kernels stay plain."""
    calls = []

    def recording(q, k, v, causal, window, scale):
        calls.append((f"{q.shape[-1]}x{v.shape[-1]}", window,
                      (q.dtype, k.dtype, v.dtype)))
        return attention_plain(q, k, v, causal=causal, window=window,
                               scale=scale)

    monkeypatch.setattr(ops, "_on_cuda", lambda name, t: name == "attention")
    monkeypatch.setattr(ops, "flash_attention_op", recording)
    return calls


def test_forward_at_d256_equals_the_jax_forward(gemma, b2_calls):
    cfg, jcfg, jvals, tvals = gemma
    tokens = np.random.default_rng(40).integers(0, cfg.vocab, (2, 40))
    want, _, _ = jax_lm_apply(jvals, jcfg, jnp.asarray(tokens))
    got, _, _ = lm_apply(tvals, cfg, torch.from_numpy(tokens))
    assert got.shape == (2, 40, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    f32 = (torch.float32,) * 3
    assert b2_calls == [("256x256", WINDOW, f32), ("256x256", 0, f32)]


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_greedy_tokens_equal_the_jax_engine(gemma, b2_calls, cache):
    """Prompts of 24 tokens (past the window: the local layer's ring is
    full at prefill) and of 9, in two groups; 8 new tokens each."""
    cfg, jcfg, jvals, tvals = gemma
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (24, 24, 9)]
    want = JaxServeEngine(jcfg, jvals, JaxServeConfig(
        max_batch=2, max_len=40, cache_dtype=getattr(jnp, cache))).generate(
        [JaxRequest(rid=i, prompt=p, max_new_tokens=8)
         for i, p in enumerate(prompts)])
    eng = ServeEngine(cfg, tvals, ServeConfig(
        max_batch=2, max_len=40, cache_dtype=getattr(torch, cache)))
    got = eng.generate([Request(rid=i, prompt=p, max_new_tokens=8)
                        for i, p in enumerate(prompts)])
    assert got == want
    # one prefill a group, each through B2 in both layers (decode attends
    # over the cache in plain torch)
    assert len(eng.stats) == 2
    assert [(w, win) for w, win, _ in b2_calls] == [
        ("256x256", WINDOW), ("256x256", 0)] * 2
    assert all(dt == (torch.float32,) * 3 for _, _, dt in b2_calls)


def test_bf16_model_under_the_fp32_cache_hands_b2_fp32(gemma, b2_calls):
    """Port only: gemma's d-256 config in bf16 served at the default
    ``ServeConfig()`` (the reference's fp32 cache).  Where a layer attends
    over its cache's dtype (a prompt shorter than the local layer's ring,
    and the global layer always), q, k and v reach B2 promoted to fp32; a
    prompt that fills the local layer's ring attends there over its
    in-flight bf16 keys, in bf16, and the global layer still in fp32."""
    cfg, _, _, tvals = gemma
    cfg = cfg.with_(compute_dtype="bfloat16")
    scfg = ServeConfig(max_batch=2, max_len=40)
    assert scfg.cache_dtype is torch.float32
    rng = np.random.default_rng(3)
    for n, local in ((12, torch.float32), (24, torch.bfloat16)):
        b2_calls.clear()
        prompt = rng.integers(0, cfg.vocab, n).astype(np.int32)
        out = ServeEngine(cfg, tvals, scfg).generate(
            [Request(rid=0, prompt=prompt, max_new_tokens=4)])
        assert len(out[0]) == 4
        assert b2_calls == [("256x256", WINDOW, (local,) * 3),
                            ("256x256", 0, (torch.float32,) * 3)]
