"""whisper-base's encoder-decoder in the port against the JAX package's,
on the CPU, at the fp32 smoke config with the reference's parameters
bridged through NumPy: the encoder's output and the logits, each cached
decode step's logits, ``EncDecEngine.transcribe``'s tokens and
``launch.serve``'s output; the encoder's self-attention takes
``ops.attention`` non-causally (B2 on the card).

Tolerances: 1e-4 for logits (as ``tests/test_torch_models.py`` holds a
whole smoke LM), 2e-5 for the encoder's output.
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import json  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import encdec_apply as jax_encdec_apply  # noqa: E402
from repro.models import init_caches as jax_init_caches  # noqa: E402
from repro.models import lm_init as jax_lm_init  # noqa: E402
from repro.models import param_values as jax_param_values  # noqa: E402
from repro.serve import EncDecEngine as JaxEncDecEngine  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.bridge import lm_params_from_reference  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import encdec_apply, init_caches  # noqa: E402
from repro_torch.models import lm_init, param_values  # noqa: E402
from repro_torch.models.layers import tree_map  # noqa: E402
from repro_torch.serve import EncDecEngine, ServeConfig  # noqa: E402

ARCH = "whisper-base"
LM_TOL = dict(rtol=1e-4, atol=1e-4)
F32 = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs files on parallel workers: this file's small torch
    work takes two intra-op threads, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def whisper():
    jcfg = jax_get_config(ARCH, smoke=True)
    jvals = jax_param_values(jax_lm_init(jax.random.PRNGKey(0), jcfg))
    tvals = lm_params_from_reference(jax.tree.map(np.asarray, jvals))
    return get_config(ARCH, smoke=True), jcfg, jvals, tvals


def frames_and_tokens(cfg, B=2, S=7, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model))
            .astype(np.float32),
            rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))


def test_tree_is_the_references(whisper):
    cfg, _, jvals, tvals = whisper
    port = param_values(lm_init(cfg, torch.Generator().manual_seed(0)))
    assert tree_map(lambda t: tuple(t.shape), port) == tree_map(
        lambda t: tuple(t.shape), tvals)
    flat = {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(jvals)[0]}
    assert "['dec_cross']['attn']['wq']" in flat
    assert "['encoder']['mixer']['wk']" in flat
    from_flat = lm_params_from_reference(flat)
    # the flat form holds no empty subtree (whisper's "pre" and "rest")
    assert tree_map(lambda t: tuple(t.shape), from_flat) == {
        k: v for k, v in tree_map(lambda t: tuple(t.shape), tvals).items()
        if v != {}}
    assert cfg.tie_embeddings and "head" not in port


def test_encoder_and_logits_match(whisper):
    cfg, jcfg, jvals, tvals = whisper
    frames, tokens = frames_and_tokens(cfg)
    jl, _, je, jaux = jax_encdec_apply(jvals, jcfg, jnp.asarray(frames),
                                       jnp.asarray(tokens))
    tl, _, te, taux = encdec_apply(tvals, cfg, torch.from_numpy(frames),
                                   torch.from_numpy(tokens).long())
    np.testing.assert_allclose(te.numpy(), np.asarray(je), **F32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LM_TOL)
    assert float(taux) == float(jaux) == 0.0
    # enc_out reused: the decoder alone gives the same logits
    again = encdec_apply(tvals, cfg, None, torch.from_numpy(tokens).long(),
                         enc_out=te)[0]
    assert torch.equal(again, tl)


def test_encoder_attention_goes_through_ops_non_causally(whisper,
                                                         monkeypatch):
    cfg, _, _, tvals = whisper
    frames, tokens = frames_and_tokens(cfg)
    calls = []
    inner = ops.attention

    def recording(q, k, v, causal=True, window=0, scale=None):
        calls.append((tuple(q.shape), causal))
        return inner(q, k, v, causal=causal, window=window, scale=scale)

    monkeypatch.setattr(ops, "attention", recording)
    encdec_apply(tvals, cfg, torch.from_numpy(frames),
                 torch.from_numpy(tokens).long())
    B, F = frames.shape[:2]
    enc = [(B, cfg.n_heads, F, cfg.head_dim), False]
    dec = [(B, cfg.n_heads, tokens.shape[1], cfg.head_dim), True]
    assert [list(c) for c in calls] == ([enc] * cfg.n_enc_layers
                                        + [dec] * cfg.n_layers)


def test_cached_decode_steps_match(whisper):
    """Each decode step with the self-attention cache: logits equal the
    reference's step and the uncached forward's row."""
    cfg, jcfg, jvals, tvals = whisper
    frames, tokens = frames_and_tokens(cfg, S=5)
    B, S = tokens.shape
    jc = jax_init_caches(jcfg, B, 16, jnp.float32)
    tc = init_caches(cfg, B, 16, torch.float32)
    full = encdec_apply(tvals, cfg, torch.from_numpy(frames),
                        torch.from_numpy(tokens).long())[0]
    je = te = None
    for t in range(S):
        jl, jc, je, _ = jax_encdec_apply(
            jvals, jcfg, jnp.asarray(frames), jnp.asarray(tokens[:, t:t + 1]),
            positions=jnp.full((B, 1), t, jnp.int32), caches=jc, enc_out=je)
        tl, tc, te, _ = encdec_apply(
            tvals, cfg, torch.from_numpy(frames),
            torch.from_numpy(tokens[:, t:t + 1]).long(),
            positions=torch.full((B, 1), t), caches=tc, enc_out=te)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LM_TOL)
        np.testing.assert_allclose(tl[:, 0].numpy(), full[:, t].numpy(),
                                   **LM_TOL)


def test_transcribe_tokens_equal_the_jax_engine(whisper):
    cfg, jcfg, jvals, tvals = whisper
    frames = frames_and_tokens(cfg, B=3)[0]
    want = JaxEncDecEngine(jcfg, jvals, JaxServeConfig(
        max_len=24)).transcribe(frames, max_new_tokens=6)
    eng = EncDecEngine(cfg, tvals, ServeConfig(max_len=24))
    assert eng.transcribe(frames, max_new_tokens=6) == want
    st = eng.stats[-1]
    assert st["batch"] == 3 and st["decode_steps"] == 5
    assert st["frames"] == cfg.n_frontend_tokens


def test_launch_serve_serves_whisper_on_the_references_frames(capsys):
    assert launch_serve.main(["--device", "cpu", "--arch", ARCH, "--smoke",
                              "--requests", "3", "--new-tokens", "4"]) == 0
    out = capsys.readouterr().out.splitlines()
    reqs = [line for line in out if line.startswith("req ")]
    assert [r.split(": ")[0] for r in reqs] == ["req 0", "req 1", "req 2"]
    assert all(len(json.loads(r.split(": ", 1)[1])) == 4 for r in reqs)
    assert len([line for line in out if line.startswith("group: ")]) == 1
    # the frames are the reference launcher's draw, bit for bit
    cfg = get_config(ARCH, smoke=True)
    np.testing.assert_array_equal(
        launch_serve.make_frames(cfg, 3, 0),
        np.random.default_rng(0).normal(size=(3, 16, cfg.d_model))
        .astype(np.float32))


def test_serve_engine_refuses_whisper(whisper):
    from repro_torch.serve import ServeEngine

    cfg, _, _, tvals = whisper
    with pytest.raises(ValueError, match="EncDecEngine"):
        ServeEngine(cfg, tvals, ServeConfig())
