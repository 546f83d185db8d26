"""The port's LM kernels (B2-B4) against the JAX package's, on the CPU.

On a CPU tensor each wrapper of ``repro_torch.kernels.ops`` takes its
kernel's plain torch version; both those wrappers and the port's ``*_ref``
oracles are held here against ``repro.kernels.ref`` and against the Pallas
kernels in interpret mode (as ``tests/test_kernels.py`` runs them off-TPU),
on the same seeded NumPy inputs, over that file's sweeps.  Tolerances are
its ``TOL``: fp32 2e-5 (the two frameworks sum in other orders), bf16 2e-2
(one bf16 rounding of the output on either side).  The CUDA kernels
themselves are held against the plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_kernels import ATTN_SWEEP, FFN_SWEEP  # noqa: E402

from repro.kernels import flash_attention, fused_rmsnorm, fused_swiglu  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.layers import _attend as jax_attend  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import fused_ffn as tffn  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

DTYPES = ("float32", "bfloat16")
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
RMS_SHAPES = [(64, 64), (256, 128), (128, 512)]


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def both(a, dtype):
    """One NumPy array as a jax and a torch array of ``dtype`` (both round
    fp32 to bf16 to nearest even, so the inputs are identical)."""
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ATTN_SWEEP)
def test_attention_matches_reference_and_pallas(case, dtype):
    B, H, S, d, causal, window, bq, bk = case
    (jq, tq), (jk, tk), (jv, tv) = (both(rand((B, H, S, d), 7 + i), dtype)
                                    for i in range(3))
    want = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    pallas = flash_attention(jq, jk, jv, causal=causal, window=window,
                             block_q=bq, block_k=bk, interpret=True)
    got_ref = tref.attention_ref(tq, tk, tv, causal=causal, window=window)
    got = ops.attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(f32(got_ref), f32(want), **TOL[dtype])
    np.testing.assert_allclose(f32(got), f32(pallas), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", FFN_SWEEP)
def test_swiglu_matches_reference_and_pallas(case, dtype):
    M, d, f, bm, bf = case
    jx, tx = both(rand((M, d), 1), dtype)
    (jg, tg), (ji, ti) = (both(rand((d, f), s, d ** -0.5), dtype)
                          for s in (2, 3))
    jo, to = both(rand((f, d), 4, f ** -0.5), dtype)
    want = jref.swiglu_ref(jx, jg, ji, jo)
    pallas = fused_swiglu(jx, jg, ji, jo, block_m=bm, block_f=bf,
                          interpret=True)
    np.testing.assert_allclose(f32(tref.swiglu_ref(tx, tg, ti, to)),
                               f32(want), **TOL[dtype])
    np.testing.assert_allclose(f32(ops.swiglu(tx, tg, ti, to)), f32(pallas),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", FFN_SWEEP)
def test_swiglu_split_matches_reference_and_pallas(case, dtype):
    """B3's plain version split as its kernels are split: the hidden
    activation in the compute dtype, then its product with Wo."""
    M, d, f, bm, bf = case
    jx, tx = both(rand((M, d), 31), dtype)
    (jg, tg), (ji, ti) = (both(rand((d, f), s, d ** -0.5), dtype)
                          for s in (32, 33))
    jo, to = both(rand((f, d), 34, f ** -0.5), dtype)
    h = tffn.swiglu_hidden_plain(tx, tg, ti)
    assert h.dtype == tx.dtype and h.shape == (M, f)
    got = (h.float() @ to.float()).to(tx.dtype)
    np.testing.assert_array_equal(f32(got), f32(tffn.swiglu_plain(tx, tg, ti,
                                                                   to)))
    np.testing.assert_allclose(f32(got), f32(jref.swiglu_ref(jx, jg, ji, jo)),
                               **TOL[dtype])
    pallas = fused_swiglu(jx, jg, ji, jo, block_m=bm, block_f=bf,
                          interpret=True)
    np.testing.assert_allclose(f32(got), f32(pallas), **TOL[dtype])


def test_fused_swiglu_refuses_cpu_tensors():
    x, w = torch.zeros((4, 8)), torch.zeros((8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tffn.fused_swiglu(x, w, w, w)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", RMS_SHAPES)
def test_rmsnorm_matches_reference_and_pallas(shape, dtype):
    M, d = shape
    jx, tx = both(rand((M, d), 5), dtype)
    js, ts = both(rand((d,), 6), "float32")
    want = jref.rmsnorm_ref(jx, js)
    pallas = fused_rmsnorm(jx, js, block_m=64, interpret=True)
    np.testing.assert_allclose(f32(tref.rmsnorm_ref(tx, ts)), f32(want),
                               **TOL[dtype])
    got = ops.rmsnorm(tx, ts)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(f32(got), f32(pallas), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_ragged_lengths_match_reference(dtype):
    """Lengths no block divides: the Pallas kernels refuse them, the port's
    kernels take them, and their plain versions agree with the reference's
    oracles there."""
    jq, tq = both(rand((2, 3, 100, 32), 11), dtype)
    jk, tk = both(rand((2, 3, 100, 32), 12), dtype)
    np.testing.assert_allclose(
        f32(ops.attention(tq, tk, tk, window=37)),
        f32(jref.attention_ref(jq, jk, jk, window=37)), **TOL[dtype])
    jx, tx = both(rand((77, 48), 13), dtype)
    (jg, tg), (ji, ti) = (both(rand((48, 90), s, 48 ** -0.5), dtype)
                          for s in (14, 15))
    jo, to = both(rand((90, 48), 16, 90 ** -0.5), dtype)
    np.testing.assert_allclose(f32(ops.swiglu(tx, tg, ti, to)),
                               f32(jref.swiglu_ref(jx, jg, ji, jo)),
                               **TOL[dtype])
    js, ts = both(rand((48,), 17), dtype)
    np.testing.assert_allclose(f32(ops.rmsnorm(tx, ts)),
                               f32(jref.rmsnorm_ref(jx, js)), **TOL[dtype])


@pytest.mark.parametrize("window", [0, 24])
def test_gqa_head_order_matches_jax_attend(window):
    """Query head h reads kv head h // G, the head order of the reference's
    ``q.reshape(B, S, Kh, G, dh)`` (``layers.py:259``)."""
    B, S, Kh, G, dh = 2, 48, 2, 3, 16
    q, k, v = rand((B, S, Kh * G, dh), 21), rand((B, S, Kh, dh), 22), \
        rand((B, S, Kh, dh), 23)
    qi = np.arange(S)[:, None]
    ki = np.arange(S)[None, :]
    mask = (ki <= qi) & ((ki > qi - window) if window else True)
    want = jax_attend(jnp.asarray(q).reshape(B, S, Kh, G, dh),
                      jnp.asarray(k), jnp.asarray(v),
                      jnp.asarray(mask)[None])
    got = ops.attention(torch.from_numpy(q).transpose(1, 2),
                        torch.from_numpy(k).transpose(1, 2),
                        torch.from_numpy(v).transpose(1, 2), window=window)
    np.testing.assert_allclose(f32(got.transpose(1, 2)),
                               f32(want).reshape(B, S, Kh * G, dh),
                               **TOL["float32"])


# v (and the output) narrower than q and k, (B, H, Hkv, S, dqk, dv): the
# deepseek smoke config's widths (16 + 8 rope, 16) and the full config's
# (128 + 64 rope, 128), the first under GQA
NARROW_V = [(2, 4, 2, 40, 24, 16), (1, 2, 2, 70, 192, 128)]


@pytest.mark.parametrize("path", ["attention_plain", "ops.attention"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", NARROW_V, ids=["24-16", "192-128"])
def test_attention_with_narrower_v_matches_reference(shape, dtype, path):
    """The plain version (directly, and through ``ops`` on CPU tensors)
    with v narrower than q and k, against the reference's oracle over k
    and v repeated for each query head; the output has v's width."""
    B, H, Hkv, S, dqk, dv = shape
    (jq, tq), (jk, tk) = (both(rand((B, n, S, dqk), 41 + i), dtype)
                          for i, n in enumerate((H, Hkv)))
    jv, tv = both(rand((B, Hkv, S, dv), 43), dtype)
    g = H // Hkv
    want = jref.attention_ref(jq, jnp.repeat(jk, g, axis=1),
                              jnp.repeat(jv, g, axis=1), window=17)
    fn = tfa.attention_plain if path == "attention_plain" else ops.attention
    got = fn(tq, tk, tv, causal=True, window=17)
    assert got.dtype == tq.dtype and got.shape == (B, H, S, dv)
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


@pytest.mark.parametrize("hkv,window", [(4, 0), (2, 7)])
def test_attention_backward_at_narrower_v_matches_autograd(hkv, window):
    """``autograd.Attention``'s backward formulas at q/k 24 and v 16 wide
    (deepseek's smoke widths), against autograd through the plain version,
    on fp64 leaves (both compute in fp32)."""
    from repro_torch.kernels import autograd as tag

    B, H, S, dqk, dv = 2, 4, 20, 24, 16

    def leaf(shape, seed):
        return torch.from_numpy(rand(shape, seed).astype(np.float64)) \
            .requires_grad_()

    q, k, v = (leaf((B, H, S, dqk), 51), leaf((B, hkv, S, dqk), 52),
               leaf((B, hkv, S, dv), 53))
    do = torch.from_numpy(rand((B, H, S, dv), 54).astype(np.float64))
    out = tag.Attention.apply(q, k, v, True, window, None)
    assert out.shape == (B, H, S, dv)
    got = torch.autograd.grad(out, (q, k, v), do)
    want = torch.autograd.grad(
        tfa.attention_plain(q, k, v, causal=True, window=window), (q, k, v),
        do)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL["float32"])


def test_wrappers_refuse_other_devices():
    x = torch.zeros((2, 4), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.rmsnorm(x, torch.zeros(4, device="meta"))



# ---------------------------------------------------------------------------
# the kernels as torch ops (repro_torch::...)
# ---------------------------------------------------------------------------

def _op_args(name, device):
    """A small call of each kernel op, its tensors on ``device``."""
    def t(*shape):
        return torch.zeros(shape, dtype=torch.bfloat16, device=device)

    return {
        "flash_attention": (t(1, 4, 16, 64), t(1, 2, 16, 64),
                            t(1, 2, 16, 64), True, 0, None),
        # MLA's widths: v and the output narrower than q and k
        "flash_attention_mla": (t(1, 4, 16, 192), t(1, 4, 16, 192),
                                t(1, 4, 16, 128), True, 0, 192 ** -0.5),
        "fused_swiglu": (t(8, 64), t(64, 96), t(64, 96), t(96, 64)),
        "fused_swiglu_with_hidden": (t(8, 64), t(64, 96), t(64, 96),
                                     t(96, 64)),
        "fused_rmsnorm": (t(8, 64), t(64), 1e-5),
    }[name]


OPS = ["flash_attention", "flash_attention_mla", "fused_swiglu",
       "fused_swiglu_with_hidden", "fused_rmsnorm"]


@pytest.mark.parametrize("name", OPS)
def test_kernel_ops_pass_opcheck_on_meta_tensors(name):
    """The op's schema and fake implementation (the meta inputs go to the
    fake implementation; the op has no CPU implementation)."""
    op = getattr(torch.ops.repro_torch, name.removesuffix("_mla")).default
    torch.library.opcheck(op, _op_args(name, "meta"),
                          test_utils=("test_schema", "test_faketensor"))


@pytest.mark.parametrize("wrapper", ["attention", "swiglu", "rmsnorm"])
def test_fake_cuda_tensors_take_the_kernel_op_not_the_plain_version(
        wrapper, monkeypatch):
    """A fake ``cuda`` tensor (as the dry run traces) goes through
    ``ops`` to the kernel's op, whose fake implementation gives the
    output, and whose FLOP formula counts it; no plain version runs."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import rmsnorm as trn

    def plain(*args, **kwargs):
        raise AssertionError("a plain version ran on a cuda tensor")

    for mod, name in ((ops, "attention_plain"), (ops, "swiglu_plain"),
                      (ops, "rmsnorm_plain"), (tfa, "attention_plain"),
                      (tffn, "swiglu_plain"),
                      (tffn, "swiglu_plain_with_hidden"),
                      (trn, "rmsnorm_plain")):
        monkeypatch.setattr(mod, name, plain)
    with FakeTensorMode():
        if wrapper == "attention":
            q, k, v = _op_args("flash_attention", "cuda")[:3]
            with FlopCounterMode(display=False) as fc:
                out = ops.attention(q, k, v, causal=True)
            shape, flops = q.shape, 4 * 1 * 4 * (16 * 17 // 2) * 64
        elif wrapper == "swiglu":
            x, wg, wi, wo = _op_args("fused_swiglu", "cuda")
            with FlopCounterMode(display=False) as fc:
                out = ops.swiglu(x, wg, wi, wo)
            shape, flops = x.shape, 6 * 8 * 64 * 96
        else:
            x, s, eps = _op_args("fused_rmsnorm", "cuda")
            with FlopCounterMode(display=False) as fc:
                out = ops.rmsnorm(x, s, eps)
            shape, flops = x.shape, 4 * 8 * 64
    assert isinstance(out, FakeTensor) and out.device.type == "cuda"
    assert out.shape == shape and out.dtype == torch.bfloat16
    assert fc.get_total_flops() == flops


@pytest.mark.parametrize("dqk,dv", [(64, 64), (192, 128)])
def test_attention_flop_formula_counts_both_widths(dqk, dv):
    """The op's FLOP formula: ``Q Kᵀ`` over dqk and ``P V`` over dv, two
    FLOP a multiply-add, over the live pairs; the fake output is dv
    wide."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    B, H, S = 2, 4, 24
    with FakeTensorMode():
        q, k = (torch.empty((B, H, S, dqk), device="cuda") for _ in range(2))
        v = torch.empty((B, H, S, dv), device="cuda")
        with FlopCounterMode(display=False) as fc:
            out = tfa.flash_attention_op(q, k, v, True, 5, None)
    assert out.shape == (B, H, S, dv)
    pairs = tfa.live_pairs(S, True, 5)
    assert fc.get_total_flops() == 2 * B * H * pairs * (dqk + dv)


def test_attention_op_refuses_widths_it_is_not_built_for():
    """A (q/k, v) width pair outside ``WIDTH_PAIRS`` raises in the op's
    fake implementation and in the launcher, before any launch: nothing
    pads or falls back for it."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    assert (192, 128) in tfa.WIDTH_PAIRS and (24, 16) not in tfa.WIDTH_PAIRS
    with FakeTensorMode():
        q = torch.empty((1, 2, 8, 24), device="cuda")
        v = torch.empty((1, 2, 8, 16), device="cuda")
        with pytest.raises(ValueError, match="widths"):
            tfa.flash_attention_op(q, q, v, True, 0, None)
    before = tfa.launches
    with pytest.raises(ValueError, match="widths"):
        tfa.flash_attention(torch.zeros((1, 2, 8, 24)),
                            torch.zeros((1, 2, 8, 24)),
                            torch.zeros((1, 2, 8, 16)))
    assert tfa.launches == before


def test_mla_on_device_tensors_takes_the_kernel_op_unpadded(monkeypatch):
    """``mla_apply``'s fresh prefill at deepseek-v2's head widths (q/k 128 +
    64 rope, v 128; the model narrowed to 2 heads and d 64) on device
    tensors that hold no data: the attention op gets q and k 192 wide and
    v 128 wide, unpadded, and no plain version runs.  The tensors are
    ``meta`` tensors that ``ops`` takes as ``cuda`` ones (each op's meta
    inputs reach its fake implementation, as fake ``cuda`` ones do): this
    CPU-only torch cannot index a fake ``cuda`` tensor with ``...`` or
    ``None`` (it asks for a CUDA device)."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as tl
    from repro_torch.models import param_values

    cfg = get_config("deepseek-v2-236b").with_(
        n_heads=2, d_model=64, q_lora_rank=48, kv_lora_rank=32)
    assert (cfg.head_dim + cfg.rope_head_dim, cfg.v_dim) == (192, 128)
    params = tl.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
        param_values(tl.mla_init(torch.Generator().manual_seed(0), cfg)),
        is_leaf=torch.is_tensor)

    def plain(*args, **kwargs):
        raise AssertionError("a plain version ran on a device tensor")

    for mod, name in ((ops, "attention_plain"), (tfa, "attention_plain"),
                      (ops, "rmsnorm_plain")):
        monkeypatch.setattr(mod, name, plain)
    monkeypatch.setattr(ops, "_on_cuda", lambda name, t: True)
    calls, inner = [], ops.flash_attention_op

    def recording(q, k, v, causal, window, scale):
        calls.append((tuple(q.shape), tuple(k.shape), tuple(v.shape),
                      scale))
        return inner(q, k, v, causal, window, scale)

    monkeypatch.setattr(ops, "flash_attention_op", recording)
    B, S = 2, 12
    x = torch.empty((B, S, cfg.d_model), device="meta")
    pos = torch.zeros((B, S), dtype=torch.long, device="meta")
    out, _ = tl.mla_apply(params, cfg, x, pos, fresh=True)
    assert out.shape == (B, S, cfg.d_model) and out.device.type == "meta"
    assert calls == [((B, 2, S, 192), (B, 2, S, 192), (B, 2, S, 128),
                      1.0 / np.sqrt(192))]


def test_mla_decode_on_device_tensors_takes_the_latent_kernel_op(
        monkeypatch):
    """``mla_apply``'s decode step against a bf16 cache at deepseek-v2's
    latent widths (kv LoRA 512, rope 64; the model narrowed to 2 heads and
    d 64) on device tensors that hold no data (``meta`` tensors taken as
    ``cuda`` ones, as above): the latent kernel's op gets the absorbed
    query ``[B, H, 512]``, the rope query ``[B, H, 64]``, the cache in
    place and one position a row; the cache is never expanded
    (``_mm_rows`` is not called), no plain version runs, and the
    ``mla.latent_decode`` counter counts the call."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.kernels import mla_decode as md
    from repro_torch.models import layers as tl
    from repro_torch.models import param_values

    cfg = get_config("deepseek-v2-236b").with_(
        n_heads=2, d_model=64, q_lora_rank=48)
    params = tl.tree_map(
        lambda t: torch.empty(t.shape, dtype=torch.bfloat16, device="meta"),
        param_values(tl.mla_init(torch.Generator().manual_seed(0), cfg)),
        is_leaf=torch.is_tensor)

    def refuse(*args, **kwargs):
        raise AssertionError("ran on a device tensor")

    for mod, name in ((ops, "mla_decode_plain"), (md, "mla_decode_plain"),
                      (ops, "rmsnorm_plain"), (tl, "_mm_rows")):
        monkeypatch.setattr(mod, name, refuse)
    monkeypatch.setattr(ops, "_on_cuda", lambda name, t: True)
    calls, inner = [], ops.mla_decode_op

    def recording(q_lat, q_rope, ckv, k_rope, positions, scale):
        calls.append((tuple(q_lat.shape), tuple(q_rope.shape),
                      ckv is cache["ckv"],
                      tuple(k_rope.shape), tuple(positions.shape), scale))
        return inner(q_lat, q_rope, ckv, k_rope, positions, scale)

    monkeypatch.setattr(ops, "mla_decode_op", recording)
    B, T = 2, 40
    cache = {"ckv": torch.empty((B, T, 512), dtype=torch.bfloat16,
                                device="meta"),
             "k_rope": torch.empty((B, T, 1, 64), dtype=torch.bfloat16,
                                   device="meta"),
             "len": torch.zeros((), dtype=torch.int32, device="meta")}
    x = torch.empty((B, 1, cfg.d_model), dtype=torch.bfloat16, device="meta")
    pos = torch.zeros((B, 1), dtype=torch.long, device="meta")
    with obs.recording(obs.Recorder()) as rec:
        out, _ = tl.mla_apply(params, cfg, x, pos, cache=cache)
    assert out.shape == (B, 1, cfg.d_model) and out.device.type == "meta"
    assert calls == [((B, 2, 512), (B, 2, 64), True, (B, T, 64), (B,),
                      1.0 / np.sqrt(192))]
    assert rec.counters == {"mla.latent_decode": 1}


def _latent_operands(B=2, H=3, T=70, kvr=512, r=64, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(B * T)
    return (torch.randn((B, H, kvr), generator=g).to(dtype),
            torch.randn((B, H, r), generator=g).to(dtype),
            torch.randn((B, T, kvr), generator=g).to(dtype),
            torch.randn((B, T, r), generator=g).to(dtype),
            torch.tensor([T - 1] * B))


@pytest.mark.parametrize("what,match", [
    ("widths", "widths"), ("dtype", "bfloat16"), ("positions", "int64"),
    ("last-dim", "contiguous"), ("unaligned", "aligned"),
    ("cpu", "CUDA device")])
def test_mla_decode_refuses_what_it_does_not_take(what, match):
    """The latent kernel's launcher raises before any launch, and counts
    none, on widths other than ``LATENT_WIDTHS`` (the op's fake
    implementation too), fp32 operands, int32 positions, a cache whose
    last dim is not contiguous, one that starts off a 16-byte boundary,
    and CPU tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import mla_decode as md

    args = list(_latent_operands(kvr=256 if what == "widths" else 512))
    if what == "dtype":
        args[:4] = [a.float() for a in args[:4]]
    elif what == "positions":
        args[4] = args[4].int()
    elif what == "last-dim":
        args[2] = torch.zeros((2, 70, 1024), dtype=torch.bfloat16)[..., ::2]
    elif what == "unaligned":
        args[2] = torch.zeros(2 * 70 * 512 + 1,
                              dtype=torch.bfloat16)[1:].view(2, 70, 512)
    before = md.launches
    with pytest.raises(ValueError, match=match):
        md.mla_decode(*args, 0.1)
    assert md.launches == before
    if what == "widths":
        with FakeTensorMode():
            q_lat = torch.empty((2, 3, 256), device="cuda")
            with pytest.raises(ValueError, match="widths"):
                md.mla_decode_op(q_lat, torch.empty((2, 3, 64)),
                                 torch.empty((2, 70, 256)),
                                 torch.empty((2, 70, 64)),
                                 torch.zeros((2,), dtype=torch.long), 0.1)


def test_mla_decode_plain_attends_to_each_rows_live_slots():
    """The plain version attends row ``b`` to slots ``0 ..
    min(positions[b], T - 1)`` (the slots the expansion path's mask leaves
    live) and gives zeros to a row with no live slot; its splits of a row
    over the card, :func:`splits_for`, fill the 132 SMs in one wave at the
    deepseek cells' shapes (4 splits at B 16, 8 at B 8), one where the
    blocks already do, at most one a 64-slot tile."""
    from repro_torch.kernels import mla_decode as md

    q_lat, q_rope, ckv, k_rope, _ = _latent_operands(dtype=torch.float32)
    pos = torch.tensor([-1, 30])
    got = md.mla_decode_plain(q_lat, q_rope, ckv, k_rope, pos, 0.05)
    assert not got[0].any()
    s = (q_lat[1] @ ckv[1, :31].T + q_rope[1] @ k_rope[1, :31].T) * 0.05
    np.testing.assert_allclose(got[1].numpy(), (torch.softmax(s, -1)
                               @ ckv[1, :31]).numpy(), rtol=1e-5, atol=1e-5)
    assert [md.splits_for(b, 128, t, 132) for b, t in (
        (16, 2184), (8, 1032), (8, 2056), (66, 300), (1, 100))] == [
        4, 8, 8, 1, 2]


@pytest.mark.parametrize("s_len,causal,window", [
    (16, True, 0), (16, True, 5), (16, False, 0), (16, False, 5),
    (3, True, 8), (3, False, 8), (1, True, 0)])
def test_attention_flop_formula_counts_the_live_pairs(s_len, causal, window):
    from repro_torch.kernels.flash_attention import live_pairs

    qi = torch.arange(s_len)[:, None]
    ki = torch.arange(s_len)[None, :]
    mask = torch.ones((s_len, s_len), dtype=torch.bool)
    if causal:
        mask &= ki <= qi
    if window:
        mask &= ki > qi - window
    assert live_pairs(s_len, causal, window) == int(mask.sum())
