"""The port's model zoo (attention, MLA, dense-FFN, MoE, Mamba, mLSTM and
sLSTM layers) against the JAX package's, on the CPU, with the reference's
own seeded parameters carried over by
:func:`repro_torch.bridge.lm_params_from_reference`.

Tolerances: fp32 2e-5 for one layer (the two frameworks sum in other
orders; Mamba's scan runs in time order in the port, where the
reference's uncached call takes an associative scan of the same
recurrence); 1e-4 for the logits of a whole smoke LM (those differences
pass through 4 layers and a 256-way head, on activations of unit scale);
the decode-equals-prefill tolerance of ``tests/test_models_smoke.py``.
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import init_caches as jax_init_caches  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import lm_apply as jax_lm_apply  # noqa: E402
from repro.models import lm_init as jax_lm_init  # noqa: E402
from repro.models import param_values as jax_param_values  # noqa: E402
from repro_torch.bridge import lm_params_from_reference  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import init_caches, lm_apply, lm_init  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import param_values  # noqa: E402
from repro_torch.models.config import ATTN_LOCAL, BlockSpec  # noqa: E402
from repro_torch.models.layers import tree_map  # noqa: E402

F32 = dict(rtol=2e-5, atol=2e-5)
LM_TOL = dict(rtol=1e-4, atol=1e-4)
# every decoder-only config; those of ATTN_ARCHS attend with GQA attention
ATTN_ARCHS = ("tinyllama-1.1b", "gemma3-4b", "jamba-v0.1-52b", "arctic-480b",
              "glm4-9b", "granite-3-8b", "llava-next-34b")
ARCHS = ATTN_ARCHS[:4] + ("deepseek-v2-236b", "xlstm-350m") + ATTN_ARCHS[4:]


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def lms():
    """(port cfg, JAX cfg, JAX values, bridged port values) per arch."""
    out = {}
    for arch in ARCHS:
        jcfg = jax_get_config(arch, smoke=True)
        jvals = jax_param_values(jax_lm_init(jax.random.PRNGKey(0), jcfg))
        out[arch] = (get_config(arch, smoke=True), jcfg, jvals,
                     lm_params_from_reference(np_tree(jvals)))
    return out


def shapes(tree):
    return tree_map(lambda t: tuple(t.shape), tree)


def test_configs_are_the_references():
    from repro.configs import ARCHS as JAX_ARCHS

    from repro_torch.configs import ARCHS as PORT_ARCHS

    assert PORT_ARCHS == JAX_ARCHS
    for arch in JAX_ARCHS:
        for smoke in (False, True):
            port, ref = get_config(arch, smoke), jax_get_config(arch, smoke)
            assert vars(port) == vars(ref)
            assert port.layout() == ref.layout()


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_nested_and_flat_give_the_port_tree(lms, arch):
    cfg, _, jvals, bridged = lms[arch]
    flat = {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(jvals)[0]}
    from_flat = lm_params_from_reference(flat)
    port = param_values(lm_init(cfg, torch.Generator().manual_seed(0)))
    drop_empty = {k: v for k, v in shapes(port).items() if v != {}}
    assert shapes(from_flat) == drop_empty
    assert shapes(bridged) == shapes(port)
    for key, arr in flat.items():
        node = from_flat
        for part in key[2:-2].split("']['"):
            node = node[part]
        assert np.array_equal(node.numpy(), arr), key
    bf16 = lm_params_from_reference(flat, dtype=torch.bfloat16)
    assert bf16["embed"].dtype == torch.bfloat16


def test_layer_rmsnorm_and_rope_match():
    x = rand((2, 5, 3, 16), 1)
    scale = rand((16,), 2)
    np.testing.assert_allclose(
        tl.rmsnorm({"scale": torch.from_numpy(scale)},
                   torch.from_numpy(x)).numpy(),
        np.asarray(jl.rmsnorm({"scale": jnp.asarray(scale)},
                              jnp.asarray(x))), **F32)
    pos = np.tile(np.arange(5)[None] + 7, (2, 1))
    np.testing.assert_allclose(
        tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                      10_000.0).numpy(),
        np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                 10_000.0)), **F32)


@pytest.mark.parametrize("S,chunk", [(24, 1024), (512, 128)],
                         ids=["dense", "chunked"])
@pytest.mark.parametrize("window", [0, 100])
def test_layer_dispatch_attend_matches(S, chunk, window):
    """Dense ``_attend`` at S = 24; ``_attend_chunked`` forced with S = 512
    and chunk 128 (query chunks of 128, key chunks of 256), with and
    without a sliding window."""
    B, Kh, G, dh = 1, 2, 2, 16
    q, k, v = rand((B, S, Kh, G, dh), 3), rand((B, S, Kh, dh), 4), \
        rand((B, S, Kh, dh), 5)
    qpos = np.tile(np.arange(S)[None], (B, 1))
    kpos = np.arange(S)
    want = jl._dispatch_attend(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(qpos),
                               jnp.asarray(kpos), True, window, 0.0, chunk)
    got = tl._dispatch_attend(*(torch.from_numpy(a) for a in
                                (q, k, v, qpos, kpos)), True, window, 0.0,
                              chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _attn_params(arch, seed):
    jcfg = jax_get_config(arch, smoke=True)
    p = jax_param_values(jl.attention_init(jax.random.PRNGKey(seed), jcfg))
    return jcfg, p, lm_params_from_reference(np_tree(p))


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_layer_attention_apply_uncached_matches(arch):
    jcfg, jp, tp = _attn_params(arch, 1)
    cfg = get_config(arch, smoke=True)
    x = rand((2, 12, cfg.d_model), 6)
    pos = np.tile(np.arange(12)[None], (2, 1))
    want, _ = jl.attention_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                 window=8)
    for fresh in (True, False):  # the kernel's route and the ported one
        got, _ = tl.attention_apply(tp, cfg, torch.from_numpy(x),
                                    torch.from_numpy(pos), window=8,
                                    fresh=fresh)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("arch,S,window", [
    ("tinyllama-1.1b", 20, 0), ("gemma3-4b", 12, 16), ("gemma3-4b", 20, 16)],
    ids=["global", "local-short", "local-wraps"])
def test_flash_route_equals_jax_prefill_into_an_empty_cache(arch, S, window):
    """The flash-attention route (queries against the S in-flight keys with
    causal index masking) against the reference's cached prefill, which
    attends over all T ring slots with the empty ones masked by pos = -1
    (and over the in-flight keys when S >= T): same output, same cache."""
    jcfg, jp, tp = _attn_params(arch, 2)
    cfg = get_config(arch, smoke=True)
    spec = BlockSpec(ATTN_LOCAL if window else "attn", "dense")
    B, max_len = 2, 32
    x = rand((B, S, cfg.d_model), 7)
    pos = np.tile(np.arange(S)[None], (B, 1))
    from repro.models.blocks import init_cache_for_block as jax_cache

    from repro_torch.models.blocks import init_cache_for_block

    want, jcache = jl.attention_apply(
        jp, jcfg, jnp.asarray(x), jnp.asarray(pos), window=window,
        cache=jax_cache(jcfg, spec, B, max_len, jnp.float32))
    cache = init_cache_for_block(cfg, spec, B, max_len, torch.float32)
    got, cache = tl.attention_apply(tp, cfg, torch.from_numpy(x),
                                    torch.from_numpy(pos), window=window,
                                    cache=cache, fresh=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    for key in ("k", "v", "pos", "len"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), **F32)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_layer_ffn_matches(act):
    p = jax_param_values(jl.ffn_init(jax.random.PRNGKey(3), 32, 96))
    x = rand((2, 7, 32), 8)
    want = jl.ffn_apply(p, jnp.asarray(x), act)
    got = tl.ffn_apply(lm_params_from_reference(np_tree(p)),
                       torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _moe_params(arch, seed, **overrides):
    jcfg = jax_get_config(arch, smoke=True).with_(**overrides)
    p = jax_param_values(jl.moe_init(jax.random.PRNGKey(seed), jcfg))
    return (jcfg, get_config(arch, smoke=True).with_(**overrides), p,
            lm_params_from_reference(np_tree(p)))


@pytest.mark.parametrize("arch,overrides,act", [
    ("arctic-480b", {}, "silu"), ("deepseek-v2-236b", {}, "silu"),
    ("arctic-480b", {"capacity_factor": 0.5}, "silu"),
    ("arctic-480b", {}, "gelu")],
    ids=["arctic", "deepseek-shared", "arctic-drops", "arctic-gelu"])
def test_layer_moe_apply_matches(arch, overrides, act):
    """Out and aux of the sort-based capacity dispatch: Arctic's smoke MoE,
    deepseek's (a shared expert), a capacity factor of 0.5, where every
    sequence overflows some expert and the stable tie order of the sort
    decides which of its tokens are dropped, and GeLU experts (plain
    torch, where SwiGLU experts take ``ops.swiglu``)."""
    jcfg, cfg, jp, tp = _moe_params(arch, 4, **overrides)
    x = rand((2, 12, cfg.d_model), 11)
    want, want_aux = jl.moe_apply(jp, jcfg, jnp.asarray(x), act)
    got, aux = tl.moe_apply(tp, cfg, torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(want_aux), **F32)
    if overrides:
        roomy, _ = tl.moe_apply(tp, cfg.with_(capacity_factor=4.0),
                                torch.from_numpy(x), act)
        assert not torch.allclose(roomy, got)  # tokens were dropped


def _mamba_params(seed):
    jcfg = jax_get_config("jamba-v0.1-52b", smoke=True)
    p = jax_param_values(jl.mamba_init(jax.random.PRNGKey(seed), jcfg))
    return (jcfg, get_config("jamba-v0.1-52b", smoke=True), p,
            lm_params_from_reference(np_tree(p)))


@pytest.mark.parametrize("S,cached", [(12, False), (1, True), (7, True)],
                         ids=["uncached", "one-step", "chunk-of-7"])
def test_layer_mamba_apply_matches(S, cached):
    """Out and new state of the selective scan: uncached (the reference's
    associative scan), and from a random state for one decode step and for
    a 7-token chunk (its sequential scan).  The port writes the state in
    place, into the tensors it was given."""
    jcfg, cfg, jp, tp = _mamba_params(5)
    di = cfg.mamba_expand * cfg.d_model
    x = rand((2, S, cfg.d_model), 12)
    state = None
    if cached:
        state = {"conv": rand((2, cfg.mamba_d_conv - 1, di), 13),
                 "ssm": rand((2, di, cfg.mamba_d_state), 14)}
    want, want_state = jl.mamba_apply(
        jp, jcfg, jnp.asarray(x),
        None if state is None else jax.tree.map(jnp.asarray, state))
    tstate = None if state is None else {
        k: torch.from_numpy(v.copy()) for k, v in state.items()}
    got, got_state = tl.mamba_apply(tp, cfg, torch.from_numpy(x), tstate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    if cached:
        assert got_state is tstate
    for key in ("conv", "ssm"):
        assert got_state[key].dtype == torch.float32
        np.testing.assert_allclose(got_state[key].numpy(),
                                   np.asarray(want_state[key]), **F32)


@pytest.mark.parametrize("with_state", [False, True])
def test_layer_causal_conv1d_matches(with_state):
    u, w, b = rand((2, 5, 24), 15), rand((4, 24), 16, 0.5), rand((24,), 17)
    state = rand((2, 3, 24), 18) if with_state else None
    want, want_state = jl._causal_conv1d(
        jnp.asarray(u), jnp.asarray(w), jnp.asarray(b),
        None if state is None else jnp.asarray(state))
    got, got_state = tl._causal_conv1d(
        *(torch.from_numpy(a) for a in (u, w, b)),
        None if state is None else torch.from_numpy(state))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(got_state.numpy(), np.asarray(want_state),
                               **F32)


def _mixer_params(init, arch, seed):
    jcfg = jax_get_config(arch, smoke=True)
    p = jax_param_values(init(jax.random.PRNGKey(seed), jcfg))
    return (jcfg, get_config(arch, smoke=True), p,
            lm_params_from_reference(np_tree(p)))


def _states(jcfg, spec, B, max_len, seed=None):
    """The reference's and the port's cache for one block: the empty one,
    or (``seed``) random values in every floating leaf, the same in both."""
    from repro.models.blocks import init_cache_for_block as jax_cache

    from repro_torch.models.blocks import init_cache_for_block

    jc = np_tree(jax_cache(jcfg, spec, B, max_len, jnp.float32))
    if seed is not None:
        jc = {k: (np.abs(rand(v.shape, seed + i)) if k in ("n", "N")
                  else rand(v.shape, seed + i) * (0.1 if k == "C" else 1.0))
              if v.dtype == np.float32 else v
              for i, (k, v) in enumerate(sorted(jc.items()))}
    tc = init_cache_for_block(get_config(jcfg.name, smoke=True), spec, B,
                              max_len, torch.float32)
    for k, v in jc.items():
        tc[k].copy_(torch.from_numpy(np.array(v)))
    return jax.tree.map(jnp.asarray, jc), tc


def _assert_states(got, want):
    assert got.keys() == want.keys()
    for key in want:
        assert str(got[key].dtype) == f"torch.{np.asarray(want[key]).dtype}"
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **F32)


@pytest.mark.parametrize("case", ["uncached", "prefill", "decode",
                                  "chunk-of-5"])
def test_layer_mla_apply_matches(case):
    """MLA (deepseek's smoke widths: q/k heads 16 + 8 rope, v heads 16):
    uncached, a cached prefill into an empty cache (both through the
    attention kernel's padded route, ``fresh``, and the reference's), one
    decode step and a 5-token chunk against a cache already holding 12
    tokens; the cache written in place, every leaf equal."""
    jcfg, cfg, jp, tp = _mixer_params(jl.mla_init, "deepseek-v2-236b", 21)
    spec = BlockSpec("attn_mla", "dense")
    B, S = 2, {"uncached": 12, "prefill": 12, "decode": 1,
               "chunk-of-5": 5}[case]
    start = 12 if case in ("decode", "chunk-of-5") else 0
    x = rand((B, S, cfg.d_model), 22)
    pos = np.tile(np.arange(start, start + S)[None], (B, 1))
    if case == "uncached":
        want, _ = jl.mla_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
        for fresh in (True, False):
            got, cache = tl.mla_apply(tp, cfg, torch.from_numpy(x),
                                      torch.from_numpy(pos), fresh=fresh)
            assert cache is None
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        return
    jc, _ = _states(jcfg, spec, B, 24)
    if start:  # a cache holding 12 tokens, from the reference
        x0 = rand((B, start, cfg.d_model), 23)
        _, jc = jl.mla_apply(jp, jcfg, jnp.asarray(x0), jnp.asarray(
            np.tile(np.arange(start)[None], (B, 1))), cache=jc)
    want, want_cache = jl.mla_apply(jp, jcfg, jnp.asarray(x),
                                    jnp.asarray(pos), cache=jc)
    for fresh in ((True, False) if case == "prefill" else (False,)):
        tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
        got, cache = tl.mla_apply(tp, cfg, torch.from_numpy(x),
                                  torch.from_numpy(pos), cache=tc,
                                  fresh=fresh)
        assert cache is tc
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        _assert_states(cache, want_cache)


def test_mla_prefill_goes_through_the_attention_kernel_padded(monkeypatch):
    """A fresh MLA prefill calls ``ops.attention`` once, with q, k and v
    zero-padded to one width the kernel is built for (smoke: 24 and 16 ->
    32) and scale 1/sqrt(24); a decode step does not call it."""
    from repro_torch.kernels import ops

    calls = []
    inner = ops.attention

    def recording(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), tuple(v.shape), kw))
        return inner(q, k, v, **kw)

    monkeypatch.setattr(ops, "attention", recording)
    _, cfg, _, tp = _mixer_params(jl.mla_init, "deepseek-v2-236b", 24)
    x = torch.from_numpy(rand((2, 9, cfg.d_model), 25))
    pos = torch.arange(9)[None].expand(2, 9)
    tl.mla_apply(tp, cfg, x, pos, fresh=True)
    assert calls == [((2, 4, 9, 32),) * 3 + (
        {"causal": True, "scale": 1.0 / np.sqrt(24)},)]
    tl.mla_apply(tp, cfg, x[:, :1], pos[:, :1], fresh=True)
    assert len(calls) == 1


def _deepseek_narrow(n_heads: int):
    """deepseek-v2-236b's MLA widths (kv LoRA 512, rope 64, q/k 128 + 64,
    v 128) on a narrow model (d 64, q LoRA 48, ``n_heads`` heads): its
    config and parameters."""
    cfg = get_config("deepseek-v2-236b").with_(
        n_heads=n_heads, d_model=64, q_lora_rank=48)
    return cfg, param_values(tl.mla_init(
        torch.Generator().manual_seed(n_heads), cfg))


# (heads, cache slots, the cache's length before the step, each row's
# position): rows at their own positions in a part-filled cache, a cache
# the step fills, one written past its end (the write clamped to its last
# slot, rows at and past it)
LATENT_CASES = {"ragged": (2, 40, 17, (5, 17, 30)),
                "full": (3, 40, 39, (39, 39)),
                "clamped": (4, 40, 52, (52, 39, 60))}


def _mla_decode_step(cfg, params, case, dtype, latent, monkeypatch):
    """One MLA decode step of :data:`LATENT_CASES` ``case`` in ``dtype``,
    in latent space or through the expansion (``_latent_decode`` forced):
    its output and the cache it wrote."""
    _, T, length, pos = LATENT_CASES[case]
    B = len(pos)
    g = torch.Generator().manual_seed(T + cfg.n_heads)
    cache = {"ckv": torch.randn((B, T, 512), generator=g).to(dtype),
             "k_rope": torch.randn((B, T, 1, 64), generator=g).to(dtype),
             "len": torch.tensor(length, dtype=torch.int32)}
    x = torch.randn((B, 1, cfg.d_model), generator=g).to(dtype)
    monkeypatch.setattr(tl, "_latent_decode", lambda *a: latent)
    out, _ = tl.mla_apply(tl.tree_cast(params, dtype), cfg, x,
                          torch.tensor(pos)[:, None], cache=cache)
    return out, cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(LATENT_CASES))
def test_mla_latent_decode_matches_the_expansion(case, dtype, monkeypatch):
    """One decode step at deepseek's widths in latent space (``wukv``
    folded into the query and the output, ``ops.mla_decode``'s plain
    version between) against the expansion of the cache, from the same
    cache, which both write alike.  fp32: the same products reassociated,
    within 1e-5.  bf16: the two round at other places (the expansion each
    head's keys and values and the attention weights, the latent route the
    absorbed query, the latent output and its product), a few bf16 units
    of an output of magnitude ~1: within the bf16 tolerance of
    ``tests/test_kernels.py``, 2e-2."""
    cfg, params = _deepseek_narrow(LATENT_CASES[case][0])
    dt = getattr(torch, dtype)
    want, want_cache = _mla_decode_step(cfg, params, case, dt, False,
                                        monkeypatch)
    got, got_cache = _mla_decode_step(cfg, params, case, dt, True,
                                      monkeypatch)
    for key, value in want_cache.items():
        assert torch.equal(got_cache[key], value), key
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("what", ["bf16", "fp32-cache", "smoke-widths",
                                  "prefill-into-cache", "sharded-cache"])
def test_mla_takes_the_latent_route_only_where_it_holds(what, monkeypatch):
    """``_latent_decode``: a decode step (S 1) against a plain bf16 cache at
    deepseek's widths attends in latent space; the fp32 cache (the
    engine's default), the smoke widths (kv LoRA 16, rope 8), a prefill of
    S > 1 into a filled cache and a cache sharded on a mesh (a
    ``DTensor``) expand it through ``wukv``.  Through ``mla_apply`` on the
    CPU: ``ops.mla_decode`` is called, or ``_mm_rows(ckv, wukv)``."""
    from repro_torch.kernels import ops

    cfg = (get_config("deepseek-v2-236b", smoke=True) if what ==
           "smoke-widths" else _deepseek_narrow(2)[0])
    params = param_values(tl.mla_init(torch.Generator().manual_seed(1), cfg))
    dt = torch.float32 if what == "fp32-cache" else torch.bfloat16
    B, T, S = 2, 24, 3 if what == "prefill-into-cache" else 1
    cache = {"ckv": torch.zeros((B, T, cfg.kv_lora_rank), dtype=dt),
             "k_rope": torch.zeros((B, T, 1, cfg.rope_head_dim), dtype=dt),
             "len": torch.tensor(7, dtype=torch.int32)}
    if what == "sharded-cache":  # as the dry run's caches are
        monkeypatch.setattr(tl, "is_dtensor", lambda *t: True)
    latent = what == "bf16"
    assert tl._latent_decode(cfg, cache, S) is latent
    if what == "sharded-cache":
        return
    calls = []

    def recording(mod, name):
        inner = getattr(mod, name)

        def call(*args):
            calls.append(name)
            return inner(*args)

        monkeypatch.setattr(mod, name, call)

    recording(ops, "mla_decode")
    recording(tl, "_mm_rows")
    pos = torch.arange(7, 7 + S)[None].expand(B, S)
    x = torch.randn((B, S, cfg.d_model)).to(torch.bfloat16)
    tl.mla_apply(tl.tree_cast(params, torch.bfloat16), cfg, x, pos,
                 cache=cache)
    assert calls == (["mla_decode"] if latent else ["_mm_rows"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(LATENT_CASES))
def test_mla_latent_decode_matches_the_reference(case, dtype, monkeypatch):
    """One MLA decode step at deepseek's widths (:func:`_deepseek_narrow`'s
    narrow model) in latent space against the JAX package's ``mla_apply``,
    which expands the cache, on the same fp32 parameters, x, positions and
    cache (:data:`LATENT_CASES`: ragged rows, a full cache, a clamped
    write).  bf16 cache: the route ``_latent_decode`` takes by itself; the
    reference expands the bf16 cache in fp32, where the port rounds the
    query, ``wukv``, the absorbed query, the latent output and its
    product to bf16: errors up to 4.8e-3 on outputs of std 0.2-0.4, held
    to 1e-2, twice that.  fp32 cache
    (``_latent_decode`` forced): the same products reassociated, within
    1e-5.  The cache each writes is the reference's: fp32 within this
    file's 2e-5, bf16 within one bf16 unit (2**-7 of the value: the two
    round the same fp32 slot, which may differ in its last bits)."""
    from repro_torch.kernels import ops

    h, T, length, pos = LATENT_CASES[case]
    B, jdt, dt = len(pos), getattr(jnp, dtype), getattr(torch, dtype)
    over = dict(n_heads=h, d_model=64, q_lora_rank=48)
    jcfg = jax_get_config("deepseek-v2-236b").with_(**over)
    cfg = get_config("deepseek-v2-236b").with_(**over)
    jp = jax_param_values(jl.mla_init(jax.random.PRNGKey(h), jcfg))
    tp = lm_params_from_reference(np_tree(jp))
    ckv, k_rope = rand((B, T, 512), 31), rand((B, T, 1, 64), 32)
    x, positions = rand((B, 1, 64), 33), np.array(pos)[:, None]
    want, want_cache = jl.mla_apply(
        jp, jcfg, jnp.asarray(x), jnp.asarray(positions), cache={
            "ckv": jnp.asarray(ckv, jdt), "k_rope": jnp.asarray(k_rope, jdt),
            "len": jnp.asarray(length, jnp.int32)})
    cache = {"ckv": torch.from_numpy(ckv).to(dt),
             "k_rope": torch.from_numpy(k_rope).to(dt),
             "len": torch.tensor(length, dtype=torch.int32)}
    if dtype == "float32":
        monkeypatch.setattr(tl, "_latent_decode", lambda *a: True)
    else:
        assert tl._latent_decode(cfg, cache, 1)
    calls = []
    latent = ops.mla_decode
    monkeypatch.setattr(ops, "mla_decode",
                        lambda *a: calls.append(1) or latent(*a))
    got, got_cache = tl.mla_apply(tp, cfg, torch.from_numpy(x),
                                  torch.from_numpy(positions), cache=cache)
    assert calls == [1] and got_cache is cache
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert got.dtype == torch.float32 and got.shape == (B, 1, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)
    assert int(got_cache["len"]) == int(want_cache["len"])
    for key in ("ckv", "k_rope"):
        assert got_cache[key].dtype == dt
        np.testing.assert_allclose(
            got_cache[key].float().numpy(),
            np.asarray(want_cache[key].astype(jnp.float32)), err_msg=key,
            **(F32 if dtype == "float32" else dict(rtol=2 ** -7, atol=0)))


@pytest.mark.parametrize("S", [1, 3, 5, 11, 512])
@pytest.mark.parametrize("with_state", [False, True],
                         ids=["fresh", "from-state"])
def test_layer_mlstm_apply_matches(S, with_state):
    """mLSTM at the smoke widths (d 64, 2 heads of 64): the unrolled
    recurrence (S <= 4) and the chunked-parallel form (one chunk of 5 or
    11, two chunks of 256 at S = 512), from the zero state and from a
    random one; the state written in place."""
    jcfg, cfg, jp, tp = _mixer_params(jl.mlstm_init, "xlstm-350m", 26)
    x = rand((2, S, cfg.d_model), 27)
    jstate, tstate = _states(jcfg, BlockSpec("mlstm", "none"), 2, 8,
                             seed=28 if with_state else None)
    if not with_state:
        jstate, tstate = None, None
    want, want_state = jl.mlstm_apply(jp, jcfg, jnp.asarray(x), jstate)
    got, got_state = tl.mlstm_apply(tp, cfg, torch.from_numpy(x), tstate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    if with_state:
        assert got_state is tstate
    _assert_states(got_state, want_state)


def test_mlstm_refuses_a_length_no_chunk_count_divides():
    """S = 513: nc = 2 chunks of 256 do not cover it; the reference's
    reshape fails, and so does the port."""
    jcfg, cfg, jp, tp = _mixer_params(jl.mlstm_init, "xlstm-350m", 29)
    x = rand((1, 513, cfg.d_model), 30)
    with pytest.raises(TypeError):
        jl.mlstm_apply(jp, jcfg, jnp.asarray(x))
    with pytest.raises(ValueError, match="513"):
        tl.mlstm_apply(tp, cfg, torch.from_numpy(x))


@pytest.mark.parametrize("S", [1, 7])
@pytest.mark.parametrize("with_state", [False, True],
                         ids=["fresh", "from-state"])
def test_layer_slstm_apply_matches(S, with_state):
    """sLSTM's time loop against the reference's scan, from its initial
    state (n = 1e-6, m = -10) and from a random one; the state written in
    place."""
    jcfg, cfg, jp, tp = _mixer_params(jl.slstm_init, "xlstm-350m", 31)
    x = rand((2, S, cfg.d_model), 32)
    jstate, tstate = _states(jcfg, BlockSpec("slstm", "none"), 2, 8,
                             seed=33 if with_state else None)
    if not with_state:
        jstate, tstate = None, None
    want, want_state = jl.slstm_apply(jp, jcfg, jnp.asarray(x), jstate)
    got, got_state = tl.slstm_apply(tp, cfg, torch.from_numpy(x), tstate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    if with_state:
        assert got_state is tstate
    _assert_states(got_state, want_state)


def test_slstm_state_tensors_share_no_storage():
    """The reference's initial sLSTM state is one array for ``c`` and
    ``h``; the port writes states in place, so its four tensors, in the
    scanned stack and in an unscanned block, must share no storage, and
    hold the reference's initial values."""
    from repro_torch.models.blocks import init_cache_for_block

    cfg = get_config("xlstm-350m", smoke=True)
    stacked = init_caches(cfg, 2, 16, torch.float32)["scan"]["p3"]
    single = init_cache_for_block(cfg, BlockSpec("slstm", "none"), 2, 16,
                                  torch.float32)
    for state in (stacked, single):
        assert sorted(state) == ["c", "h", "m", "n"]
        ptrs = {state[k].untyped_storage().data_ptr() for k in state}
        assert len(ptrs) == 4
        assert float(state["n"].min()) == float(state["n"].max()) == \
            np.float32(1e-6)
        assert float(state["m"].min()) == float(state["m"].max()) == -10.0
        assert not state["c"].any() and not state["h"].any()
    single["c"].fill_(1.0)
    assert not single["h"].any()


def test_router_and_a_log_are_fp32_in_a_bf16_model():
    """As in the reference, ``moe/router`` and ``mixer/A_log`` are fp32
    parameters whatever the parameter dtype; every other floating leaf
    has it.  The reference's ``lm_apply`` casts them all to the compute
    dtype, as the port's ``tree_cast`` does."""
    jcfg = jax_get_config("jamba-v0.1-52b", smoke=True).with_(
        param_dtype="bfloat16")
    cfg = get_config("jamba-v0.1-52b", smoke=True).with_(
        param_dtype="bfloat16")
    jtree = jax.eval_shape(lambda: jax_param_values(
        jax_lm_init(jax.random.PRNGKey(0), jcfg)))
    want = {jax.tree_util.keystr(path): str(leaf.dtype) for path, leaf in
            jax.tree_util.tree_flatten_with_path(jtree)[0]}
    port = param_values(lm_init(cfg, torch.Generator().manual_seed(0)))
    got = {}

    def walk(node, key):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{key}['{k}']")
        else:
            got[key] = str(node.dtype).removeprefix("torch.")

    walk(port, "")
    assert got == want
    assert got["['scan']['p0']['moe']['router']"] == "float32"
    assert got["['scan']['p0']['mixer']['A_log']"] == "float32"
    cast = tl.tree_cast(port, torch.bfloat16)
    assert cast["scan"]["p0"]["moe"]["router"].dtype == torch.bfloat16


def _extra(cfg, batch, seed):
    """Precomputed frontend embeddings ``[B, n_frontend_tokens, d]`` for a
    config with a frontend stub (llava's image tokens), else None."""
    if cfg.frontend == "none":
        return None
    return rand((batch, cfg.n_frontend_tokens, cfg.d_model), seed)


def _both(a):
    """(jnp array, torch tensor) of a NumPy array, or (None, None)."""
    return (None, None) if a is None else (jnp.asarray(a),
                                           torch.from_numpy(a))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_apply_logits_match(lms, arch):
    """The uncached forward's logits and aux loss (llava with its image
    embeddings prepended)."""
    cfg, jcfg, jvals, tvals = lms[arch]
    tokens = np.random.default_rng(9).integers(0, cfg.vocab, (2, 32))
    jx, tx = _both(_extra(cfg, 2, 19))
    S = 32 + (0 if tx is None else tx.shape[1])
    want, _, want_aux = jax_lm_apply(jvals, jcfg, jnp.asarray(tokens),
                                     extra_embeds=jx)
    got, caches, aux = lm_apply(tvals, cfg, torch.from_numpy(tokens),
                                extra_embeds=tx)
    assert caches is None and aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(want_aux), **F32)
    if not cfg.n_experts:
        assert float(aux) == 0.0
    assert got.shape == (2, S, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LM_TOL)
    last, _, _ = lm_apply(tvals, cfg, torch.from_numpy(tokens),
                          extra_embeds=tx, last_only=True)
    np.testing.assert_allclose(last[:, 0].numpy(), got[:, -1].numpy(),
                               **F32)


def _leaves(tree, prefix=""):
    """``{keystr: tensor or array}`` of a nested dict."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    return {k: v for key, sub in tree.items()
            for k, v in _leaves(sub, f"{prefix}['{key}']").items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(lms, arch):
    """Token-by-token decode through the caches against the full forward
    (``tests/test_models_smoke.py:102``; MoE with a capacity factor of
    ``n_experts``, so that no token drops in either), and the cached
    prefill against the reference's, every cache leaf included (MLA's
    latent cache, the Mamba, mLSTM and sLSTM states; llava's with its
    image embeddings prepended)."""
    cfg, jcfg, jvals, tvals = lms[arch]
    if cfg.n_experts:
        cfg = cfg.with_(capacity_factor=float(cfg.n_experts))
        jcfg = jcfg.with_(capacity_factor=float(cfg.n_experts))
    B, S = 2, 32
    tokens = torch.from_numpy(
        np.random.default_rng(10).integers(0, cfg.vocab, (B, S)))
    full, _, _ = lm_apply(tvals, cfg, tokens)
    caches = init_caches(cfg, B, max_len=S + 4, dtype=torch.float32)
    outs = []
    for t in range(S):
        pos = torch.full((B, 1), t, dtype=torch.int64)
        lg, caches, _ = lm_apply(tvals, cfg, tokens[:, t:t + 1],
                                 positions=pos, caches=caches)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-2, atol=2e-3)

    P = 20
    jx, tx = _both(_extra(cfg, B, 20))
    T = P + (0 if tx is None else tx.shape[1])
    jc = jax_init_caches(jcfg, B, T + 4, jnp.float32)
    want, jc, _ = jax_lm_apply(jvals, jcfg, jnp.asarray(tokens[:, :P]),
                               positions=jnp.tile(jnp.arange(T)[None], (B, 1)),
                               extra_embeds=jx, caches=jc)
    tc = init_caches(cfg, B, T + 4, torch.float32)
    got, tc, _ = lm_apply(tvals, cfg, tokens[:, :P], extra_embeds=tx,
                          caches=tc, prefill=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LM_TOL)
    want_caches = _leaves(np_tree(jc))
    got_caches = _leaves(tc)
    assert got_caches.keys() == want_caches.keys()
    for key, arr in want_caches.items():
        np.testing.assert_allclose(got_caches[key].numpy(), arr,
                                   err_msg=key, **LM_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_caches_and_their_axes_are_the_references(arch):
    """``init_caches``' shapes and dtypes (bf16 cache) and ``cache_axes``
    equal the reference's, leaf for leaf, at the full config's layout
    (shapes at the smoke widths)."""
    from repro.models.lm import cache_axes as jax_cache_axes

    from repro_torch.models.lm import cache_axes

    cfg, jcfg = get_config(arch, smoke=True), jax_get_config(arch, True)
    want = _leaves(jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype)),
        jax.eval_shape(lambda: jax_init_caches(jcfg, 2, 24, jnp.bfloat16))))
    got = _leaves(tree_map(lambda t: (tuple(t.shape), str(t.dtype)
                                      .removeprefix("torch.")),
                           init_caches(cfg, 2, 24, torch.bfloat16)))
    assert got == want
    axes = _leaves(cache_axes(cfg))
    assert axes == {k: tuple(v)
                    for k, v in _leaves(jax_cache_axes(jcfg)).items()}
    assert axes.keys() == want.keys()


def test_prefill_takes_no_positions(lms):
    cfg, _, _, tvals = lms["tinyllama-1.1b"]
    with pytest.raises(ValueError, match="positions=None"):
        lm_apply(tvals, cfg, torch.zeros((1, 4), dtype=torch.int64),
                 positions=torch.zeros((1, 4), dtype=torch.int64),
                 caches=init_caches(cfg, 1, 8, torch.float32), prefill=True)


@pytest.mark.parametrize("arch,item", [
    ("xlstm-350m", "A3"), ("deepseek-v2-236b", "A3"),
    ("whisper-base", "A4")])
def test_unported_kinds_raise_naming_their_roadmap_item(arch, item):
    """Every kind once refused is ported: A3's mixers (MLA; mLSTM and
    sLSTM) and A4's encoder-decoder (whisper) build with the reference's
    parameter shapes and run a forward; whisper's logits equal the
    reference's on its bridged parameters."""
    cfg = get_config(arch, smoke=True)
    values = param_values(lm_init(cfg, torch.Generator().manual_seed(0)))
    jcfg = jax_get_config(arch, True)
    jtree = jax.eval_shape(lambda: jax_param_values(
        jax_lm_init(jax.random.PRNGKey(0), jcfg)))
    assert shapes(values) == jax.tree.map(lambda a: tuple(a.shape), jtree)
    tokens = torch.zeros((1, 6), dtype=torch.int64)
    if item != "A4":
        logits, _, _ = lm_apply(values, cfg, tokens)
    else:
        from repro.models import encdec_apply as jax_encdec_apply

        from repro_torch.models import encdec_apply

        frames = rand((1, cfg.n_frontend_tokens, cfg.d_model), 4)
        logits = encdec_apply(values, cfg, torch.from_numpy(frames),
                              tokens)[0]
        jvals = jax_param_values(jax_lm_init(jax.random.PRNGKey(0), jcfg))
        bridged = lm_params_from_reference(np_tree(jvals))
        got = encdec_apply(bridged, cfg, torch.from_numpy(frames), tokens)[0]
        want = jax_encdec_apply(jvals, jcfg, jnp.asarray(frames),
                                jnp.zeros((1, 6), jnp.int32))[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LM_TOL)
    assert logits.shape == (1, 6, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
