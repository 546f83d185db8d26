"""The pieces of the port's training path against the JAX package's, on
the CPU: the kernels' autograd Functions (B2-B4: the plain forward on a
CPU tensor, the explicit backward formulas), sLSTM's custom VJP, AdamW and
the data stream.  ``tests/test_torch_trainstep.py`` holds the loss, the
whole step and the launcher.

Inputs are seeded NumPy arrays.  Tolerances: fp32 ``TOL`` of
``tests/test_kernels.py`` (2e-5) for a kernel's gradients, against
``jax.grad`` of ``repro.kernels.ref`` and against torch autograd through
the plain version; ``tests/test_slstm_vjp.py``'s for sLSTM; 1e-7 for AdamW
on identical gradients (elementwise fp32; the two frameworks may fuse a
multiply-add differently, one rounding apart).
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.layers import _slstm_scan, _slstm_scan_plain  # noqa: E402
from repro.train import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.train import adamw_init as jax_adamw_init  # noqa: E402
from repro.train import adamw_update as jax_adamw_update  # noqa: E402
from repro.train import schedule_lr as jax_schedule_lr  # noqa: E402
from repro_torch.bridge import adamw_state_from_reference  # noqa: E402
from repro_torch.data import (DataConfig, PrefetchingLoader,  # noqa: E402
                              SyntheticLM)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models.layers import slstm_scan  # noqa: E402
from repro_torch.train import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_update, schedule_lr)

F32 = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs files on parallel workers: this file's small torch
    work takes two intra-op threads, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the kernels' autograd Functions
# ---------------------------------------------------------------------------

# (B, H, Hkv, S, d, causal, window)
ATTN_GRAD_CASES = [(2, 2, 2, 16, 16, True, 0), (1, 2, 2, 24, 16, True, 8),
                   (2, 2, 2, 20, 32, False, 0), (1, 4, 2, 16, 16, True, 0),
                   (1, 4, 1, 37, 16, True, 0), (2, 4, 2, 29, 16, False, 0)]


def _grads(fn, args, dout):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, torch.from_numpy(dout))


@pytest.mark.parametrize("case", ATTN_GRAD_CASES,
                         ids=["causal", "window", "noncausal", "gqa",
                              "gqa_ragged", "noncausal_gqa_ragged"])
def test_attention_function_gradients(case):
    B, H, Hkv, S, d, causal, window = case
    q, k, v = (rand(s, 10 + i) for i, s in enumerate(
        [(B, H, S, d), (B, Hkv, S, d), (B, Hkv, S, d)]))
    dout = rand((B, H, S, d), 20)
    out, got = _grads(lambda *t: ops.attention(*t, causal=causal,
                                               window=window), (q, k, v),
                      dout)
    assert out.grad_fn is not None and "Attention" in type(
        out.grad_fn).__name__
    g = H // Hkv

    def jax_fn(q, k, v):
        k, v = jnp.repeat(k, g, axis=1), jnp.repeat(v, g, axis=1)
        return jnp.sum(jref.attention_ref(q, k, v, causal=causal,
                                          window=window) * dout)

    want = jax.grad(jax_fn, argnums=(0, 1, 2))(q, k, v)
    _, plain = _grads(lambda *t: tref.attention_ref(
        t[0], t[1].repeat_interleave(g, 1), t[2].repeat_interleave(g, 1),
        causal=causal, window=window), (q, k, v), dout)
    for a, w, p in zip(got, want, plain):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **F32)
        np.testing.assert_allclose(a.numpy(), p.numpy(), **F32)


@pytest.mark.parametrize("m,d,f", [(8, 16, 40), (33, 32, 24)])
def test_swiglu_function_gradients(m, d, f):
    x, wg, wi, wo = (rand((m, d), 1), rand((d, f), 2, d ** -0.5),
                     rand((d, f), 3, d ** -0.5), rand((f, d), 4, f ** -0.5))
    dout = rand((m, d), 5)
    out, got = _grads(ops.swiglu, (x, wg, wi, wo), dout)
    assert "SwiGLU" in type(out.grad_fn).__name__
    want = jax.grad(lambda *a: jnp.sum(jref.swiglu_ref(*a) * dout),
                    argnums=(0, 1, 2, 3))(x, wg, wi, wo)
    _, plain = _grads(tref.swiglu_ref, (x, wg, wi, wo), dout)
    for a, w, p in zip(got, want, plain):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **F32)
        np.testing.assert_allclose(a.numpy(), p.numpy(), **F32)


@pytest.mark.parametrize("m,d", [(8, 16), (37, 64)])
def test_rmsnorm_function_gradients(m, d):
    x, scale = rand((m, d), 6), rand((d,), 7)
    dout = rand((m, d), 8)
    out, got = _grads(ops.rmsnorm, (x, scale), dout)
    assert "RMSNorm" in type(out.grad_fn).__name__
    want = jax.grad(lambda *a: jnp.sum(jref.rmsnorm_ref(*a) * dout),
                    argnums=(0, 1))(x, scale)
    _, plain = _grads(tref.rmsnorm_ref, (x, scale), dout)
    for a, w, p in zip(got, want, plain):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **F32)
        np.testing.assert_allclose(a.numpy(), p.numpy(), **F32)


def test_kernels_skip_the_function_without_grad():
    x, scale = (torch.from_numpy(rand((4, 16), 1)).requires_grad_(),
                torch.from_numpy(rand((16,), 2)))
    with torch.no_grad():
        assert ops.rmsnorm(x, scale).grad_fn is None
    assert ops.rmsnorm(x.detach(), scale).grad_fn is None
    assert ops.rmsnorm(x, scale).grad_fn is not None


# ---------------------------------------------------------------------------
# sLSTM's custom VJP (tests/test_slstm_vjp.py's three cases)
# ---------------------------------------------------------------------------

def _slstm_setup(seed=0, B=2, S=16, H=2, dh=8):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    wx = jax.random.normal(ks[0], (B, S, H, 4 * dh))
    rrec = jax.random.normal(ks[1], (H, dh, 4 * dh)) / np.sqrt(dh)
    z = jnp.zeros((B, H, dh))
    return [wx, rrec, z, z + 1e-6, z, z - 10.0]


def _t(args, grad=()):
    return [torch.from_numpy(np.array(a)).requires_grad_(i in grad)
            for i, a in enumerate(args)]


def test_slstm_function_forward_matches_plain():
    args = _slstm_setup()
    with torch.enable_grad():
        hs, fin = slstm_scan(*_t(args, grad=(0,)))
    jhs, jfin = _slstm_scan_plain(*args)
    np.testing.assert_allclose(hs.detach().numpy(), np.asarray(jhs),
                               rtol=1e-6, atol=1e-7)
    for a, b in zip(fin, jfin):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-6, atol=1e-7)


def test_slstm_function_gradients_match_plain_ad():
    args = _slstm_setup(seed=1)

    def loss_jax(fn):
        def loss(wx, rrec):
            hs, (cl, nl, hl, ml) = fn(wx, rrec, *args[2:])
            return jnp.sum(jnp.sin(hs)) + jnp.sum(cl * nl) + jnp.sum(hl)
        return loss

    ts = _t(args, grad=(0, 1))
    hs, (cl, nl, hl, ml) = slstm_scan(*ts)
    loss = torch.sum(torch.sin(hs)) + torch.sum(cl * nl) + torch.sum(hl)
    got = torch.autograd.grad(loss, ts[:2])
    for fn in (_slstm_scan, _slstm_scan_plain):
        want = jax.grad(loss_jax(fn), argnums=(0, 1))(args[0], args[1])
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=2e-5, atol=2e-6)


def test_slstm_function_initial_state_gradients_match():
    args = _slstm_setup(seed=2)

    def mk(fn):
        def loss(c0, h0):
            hs, _ = fn(args[0], args[1], c0, args[3], h0, args[5])
            return jnp.sum(hs ** 2)
        return loss

    ts = _t(args, grad=(2, 4))
    hs, _ = slstm_scan(*ts)
    got = torch.autograd.grad(torch.sum(hs ** 2), (ts[2], ts[4]))
    for fn in (_slstm_scan, _slstm_scan_plain):
        want = jax.grad(mk(fn), argnums=(0, 1))(args[2], args[4])
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=2e-5, atol=2e-6)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

ADAMW_CASES = {
    # clipped (the gradients' norm, ~8, is above clip_norm), cosine
    "clip_cosine": dict(lr=1e-2, clip_norm=1.0, warmup_steps=2,
                        total_steps=10),
    # unclipped, warmup only
    "noclip_constant": dict(lr=3e-3, clip_norm=0.0, schedule="constant",
                            warmup_steps=3),
    "linear_warmup_cosine": dict(lr=5e-3, schedule="linear_warmup_cosine",
                                 warmup_steps=1, total_steps=4,
                                 min_lr_frac=0.2, clip_norm=4.0),
}


@pytest.mark.parametrize("case", sorted(ADAMW_CASES))
def test_adamw_update_matches(case):
    kw = ADAMW_CASES[case]
    params = {"w": rand((6, 5), 1), "scale": rand((3, 5), 2),
              "b": rand((5,), 3)}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jcfg, tcfg = JaxAdamWConfig(**kw), AdamWConfig(**kw)
    jstate = jax_adamw_init(jparams, jcfg)
    tstate = adamw_state_from_reference(
        np.asarray(jstate.step), np_tree(jstate.mu), np_tree(jstate.nu))
    for i in range(4):
        g = {k: rand(v.shape, 10 + i) for k, v in params.items()}
        jparams, jstate, jm = jax_adamw_update(
            {k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams,
            jcfg)
        tparams, tstate, tm = adamw_update(
            {k: torch.from_numpy(v) for k, v in g.items()}, tstate, tparams,
            tcfg)
        assert int(tstate.step) == int(jstate.step) == i + 1
        assert (float(tm["clip_scale"]) < 1.0) == bool(tcfg.clip_norm)
        for k in params:
            for t, j in ((tparams[k], jparams[k]), (tstate.mu[k],
                                                    jstate.mu[k]),
                         (tstate.nu[k], jstate.nu[k])):
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           rtol=1e-7, atol=1e-7)
        for k in ("grad_norm", "lr", "clip_scale"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-7, atol=1e-9)
    # the stacked norm scales [layers, d] are decayed, as the reference's
    # ndim > 1 rule decays them; 1-d leaves are not
    assert tparams["scale"].dim() == 2


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_schedule_lr_matches(schedule):
    kw = dict(lr=1.0, warmup_steps=10, total_steps=100, schedule=schedule,
              min_lr_frac=0.1)
    for s in (0, 1, 5, 10, 11, 55, 99, 100, 130):
        np.testing.assert_allclose(
            float(schedule_lr(AdamWConfig(**kw), torch.tensor(s))),
            float(jax_schedule_lr(JaxAdamWConfig(**kw), jnp.asarray(s))),
            rtol=1e-7, atol=1e-8)


def test_adamw_bf16_state():
    cfg = AdamWConfig(state_dtype="bfloat16")
    st = adamw_init({"w": torch.zeros(3, 2)}, cfg)
    assert st.mu["w"].dtype == st.nu["w"].dtype == torch.bfloat16
    assert st.step.dtype == torch.int32 and int(st.step) == 0


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,vocab,S,B", [(0, 256, 32, 8), (7, 97, 64, 4),
                                            (3, 32000, 17, 3)])
def test_synthetic_stream_is_the_references_bit_for_bit(seed, vocab, S, B):
    kw = dict(vocab=vocab, seq_len=S, global_batch=B, seed=seed)
    port, ref = SyntheticLM(DataConfig(**kw)), JaxSyntheticLM(
        JaxDataConfig(**kw))
    for step in (0, 1, 5, 123):
        a, b = port.batch_at(step), ref.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_prefetching_loader_moves_batches_to_the_device():
    src = SyntheticLM(DataConfig(vocab=97, seq_len=16, global_batch=2,
                                 seed=3))
    loader = PrefetchingLoader(src, start_step=2, device="cpu")
    try:
        first, second = next(loader), next(loader)
    finally:
        loader.close()
    assert isinstance(first["tokens"], torch.Tensor)
    np.testing.assert_array_equal(first["tokens"].numpy(),
                                  src.batch_at(2)["tokens"])
    np.testing.assert_array_equal(second["tokens"].numpy(),
                                  src.batch_at(3)["tokens"])
    plain = PrefetchingLoader(src)
    try:
        np.testing.assert_array_equal(next(plain)["tokens"],
                                      src.batch_at(0)["tokens"])
    finally:
        plain.close()


