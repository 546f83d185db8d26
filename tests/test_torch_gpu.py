"""The port's LM kernels on the card (marked ``gpu``; each test skips
where there is no CUDA GPU, deciding inside the test).

This file imports neither jax nor the JAX package, so it also runs on a GPU
machine without them:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

* every CUDA kernel against its plain version at the serving path's shapes
  and at ragged ones, in bf16 and fp32 (``chip_smoke.py``'s phase, with its
  tolerances);
* B3 and B2 across their tile edges, and both on inputs whose rows do not
  allow TMA or 16-byte copies;
* the smoke tinyllama served through the CUDA kernels and through their
  plain versions on the CPU gives the same greedy tokens, with each kernel
  launched as often as the model's structure implies;
* the jamba (Mamba + MoE), arctic (MoE), deepseek (MLA + MoE) and xlstm
  (mLSTM + sLSTM) smoke forwards on the card against the CPU, B3 at
  jamba's width at decode and at a deepseek expert's, and B2 under MLA's
  padded contract at deepseek's prefill shape;
* B4 over qk-norm's to d_ff's widths in every x/scale dtype pair, and on a
  view off a 16-byte boundary (its scalar route);
* B1's planner batches (zero copy), bitwise, and owning their results;
* a fresh plan server whose first two searches arrive at once builds B1
  once and answers both as the ``vector`` backend does, and
  ``scripts/smoke_serve_plans_torch.py --device cuda`` passes;
* the kernels under autograd: the wrappers refuse inputs that require
  grad, each Function's backward against autograd through its plain
  version (in ``chip_smoke.py``'s phase), a smoke train step on the card
  against the CPU (tinyllama, jamba, xlstm), whisper's smoke forward and
  tokens against the CPU, and the smoke trainer's restart replaying its
  losses bit for bit;
* each kernel's ``torch.library`` op on card tensors: ``opcheck``'s
  schema and fake-implementation checks, and its output equal to its
  launcher's.
"""

import subprocess
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


BF16_TOL = 2e-2


def _close(got, want):
    return bool(torch.isfinite(got).all()) and torch.allclose(
        got.float(), want.float(), rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 15, 16, 17, 63, 64, 65, 128, 129, 300])
def test_ffn_at_its_tile_edges(m):
    """Both tile kinds: 16-row tiles up to M = 16, 128 x 128 TMA tiles
    above, across their edges."""
    needs_gpu()
    from repro_torch.kernels import fused_ffn as ff

    g = torch.Generator(device="cuda").manual_seed(m)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).to(torch.bfloat16)

    d, f = 256, 704  # several 128-column tiles of each product
    x, wg, wi = rnd(m, d), rnd(d, f, scale=d ** -0.5), rnd(
        d, f, scale=d ** -0.5)
    wo = rnd(f, d, scale=f ** -0.5)
    assert _close(ff.fused_swiglu(x, wg, wi, wo),
                  ff.swiglu_plain(x, wg, wi, wo))


@pytest.mark.gpu
def test_ffn_without_16_byte_rows():
    """d and f not multiples of 8, and x one element off 16-byte alignment:
    no TMA or 16-byte copies, element loads into the small tiles at any
    M."""
    needs_gpu()
    from repro_torch.kernels import fused_ffn as ff

    g = torch.Generator(device="cuda").manual_seed(0)
    for m, d, f, off in ((77, 200, 300, 0), (9, 64, 96, 1), (200, 64, 96, 1)):
        x = torch.empty(m * d + off, dtype=torch.bfloat16,
                        device="cuda")[off:].view(m, d)
        x.copy_(torch.randn((m, d), generator=g, device="cuda"))
        wg, wi = (torch.randn((d, f), generator=g, device="cuda")
                  .mul(d ** -0.5).to(torch.bfloat16) for _ in range(2))
        wo = torch.randn((f, d), generator=g, device="cuda").mul(
            f ** -0.5).to(torch.bfloat16)
        assert _close(ff.fused_swiglu(x, wg, wi, wo),
                      ff.swiglu_plain(x, wg, wi, wo))


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 257])
def test_flash_attention_tile_edges(s, window):
    needs_gpu()
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(s + window)
    for d, h, hkv in ((64, 16, 2), (128, 4, 1), (256, 2, 2), (16, 8, 8)):
        q, k, v = (torch.randn((2, s, n, d), generator=g, device="cuda")
                   .to(torch.bfloat16).transpose(1, 2)
                   for n in (h, hkv, hkv))
        assert _close(fa.flash_attention(q, k, v, window=window),
                      fa.attention_plain(q, k, v, window=window))


@pytest.mark.gpu
@pytest.mark.parametrize("d,width", [(16, 20), (64, 68)])
def test_flash_attention_without_16_byte_rows(d, width):
    """Rows ``width`` elements apart (heads sliced out of a wider tensor):
    no TMA or 16-byte copies, element loads into the mma.sync route's
    tiles."""
    needs_gpu()
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(d)
    q, k, v = (torch.randn((1, 2, 150, width), generator=g, device="cuda")
               .to(torch.bfloat16)[..., :d] for _ in range(3))
    assert q.stride(2) == width
    assert _close(fa.flash_attention(q, k, v),
                  fa.attention_plain(q, k, v))


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


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "arctic-480b",
                                  "deepseek-v2-236b", "xlstm-350m"])
def test_moe_and_hybrid_forwards_on_the_card_equal_the_cpu(arch):
    """``chip_smoke.py``'s case: the fp32 smoke forward's logits within
    1e-3 of the CPU's, the same experts chosen for every token at every
    MoE call, one forward's launches, and equal greedy tokens."""
    needs_gpu()
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    out = chip_smoke._hybrid_vs_cpu_case(arch)
    assert out["close"] and not out["rerouted"]


@pytest.mark.gpu
def test_moe_repeats_its_output_bit_for_bit_on_the_card():
    """deepseek's smoke MoE (top-2 of 4 experts and a shared one) with
    top-6 of 8 experts, in bf16 on the card: three calls on the same input
    give the same bits (each token's six weighted outputs are summed in a
    fixed order, not by atomics in whatever order they land)."""
    needs_gpu()
    from repro_torch.configs import get_config
    from repro_torch.models import layers

    cfg = get_config("deepseek-v2-236b", smoke=True).with_(
        n_experts=8, top_k=6, capacity_factor=8.0)
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = layers.tree_cast(layers.param_values(
        layers.moe_init(gen, cfg, device="cuda")), torch.bfloat16)
    x = torch.randn((4, 256, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    outs = [layers.moe_apply(params, cfg, x)[0] for _ in range(3)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.gpu
def test_ffn_at_jamba_width_at_decode():
    """B3 at d 4096 x d_ff 14,336 (jamba's experts and dense FFNs) for a
    batch-8 decode step, bf16, against its plain version."""
    needs_gpu()
    from repro_torch.kernels import fused_ffn as ff

    g = torch.Generator(device="cuda").manual_seed(8)
    m, d, f = 8, 4096, 14336

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).to(torch.bfloat16)

    x, wg, wi = rnd(m, d), rnd(d, f, scale=d ** -0.5), rnd(
        d, f, scale=d ** -0.5)
    wo = rnd(f, d, scale=f ** -0.5)
    assert _close(ff.fused_swiglu(x, wg, wi, wo),
                  ff.swiglu_plain(x, wg, wi, wo))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 192])
def test_ffn_at_a_deepseek_expert_shape(m):
    """B3 at d 5120 x d_ff 1536 (one of deepseek's 160 experts) for a
    batch-8 decode step and one expert's 8 x 24 rows at an 8 x 512
    prefill, bf16, against its plain version."""
    needs_gpu()
    from repro_torch.kernels import fused_ffn as ff

    g = torch.Generator(device="cuda").manual_seed(m)
    d, f = 5120, 1536

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).to(torch.bfloat16)

    x, wg, wi = rnd(m, d), rnd(d, f, scale=d ** -0.5), rnd(
        d, f, scale=d ** -0.5)
    wo = rnd(f, d, scale=f ** -0.5)
    assert _close(ff.fused_swiglu(x, wg, wi, wo),
                  ff.swiglu_plain(x, wg, wi, wo))


@pytest.mark.gpu
@pytest.mark.parametrize("case", [0, 1], ids=["deepseek-bf16",
                                              "smoke-fp32"])
def test_flash_attention_under_mla_padding(case):
    """B2 under MLA's contract (``chip_smoke.MLA_ATTN_CASES``): q and k
    zero-padded from 192 to 256 columns and v from 128 at deepseek's
    8 x 512 prefill, 128 heads, scale 1/sqrt(192), bf16; 24 / 16 to 32 at
    the smoke widths in fp32.  Against its plain version on the padded
    inputs, and its first v-width columns against attention over the
    unpadded q, k, v."""
    needs_gpu()
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_ref

    b, h, s, dqk, dv, tname = chip_smoke.MLA_ATTN_CASES[case]
    dtype = getattr(torch, tname)
    args, scale = chip_smoke._mla_attn_inputs(b, h, s, dqk, dv, dtype, 7)
    got = fa.flash_attention(*args[:3], scale=scale)
    tol = chip_smoke.LM_TOL[tname]
    assert bool(torch.isfinite(got).all())
    assert torch.allclose(got.float(), fa.attention_plain(
        *args[:3], scale=scale).float(), rtol=tol, atol=tol)
    assert torch.allclose(got[..., :dv].float(), attention_ref(
        *args[3:], scale=scale).float(), rtol=tol, atol=tol)


RMS_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 8, 300, 4097])
@pytest.mark.parametrize("d", [64, 128, 256, 512, 1024, 1536, 2047, 2048,
                               5120, 5632])
def test_rmsnorm_against_plain_in_every_dtype_pair(d, m):
    """B4 at qk-norm's widths, the serving width, a width that is no whole
    number of 16-byte units (the scalar route) and d_ff's, for x and scale
    each fp32 or bf16 (``tests/test_kernels.py``'s tolerance of x's
    dtype)."""
    needs_gpu()
    from repro_torch.kernels import rmsnorm as rn

    g = torch.Generator(device="cuda").manual_seed(d * 7 + m)
    for xt in (torch.bfloat16, torch.float32):
        for st in (torch.bfloat16, torch.float32):
            x = torch.randn((m, d), generator=g, device="cuda").to(xt)
            s = torch.randn((d,), generator=g, device="cuda").to(st)
            got = rn.fused_rmsnorm(x, s)
            tol = RMS_TOL[xt]
            assert got.dtype == xt
            assert torch.allclose(got.float(), rn.rmsnorm_plain(x, s).float(),
                                  rtol=tol, atol=tol), (xt, st)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rmsnorm_on_a_view_off_16_bytes_takes_the_scalar_route(dtype):
    """x one element into its storage (a contiguous view, as
    ``x.reshape(-1, d).contiguous()`` may hand over): the wrapper chooses
    the scalar route, and the result equals the plain version's."""
    needs_gpu()
    from repro_torch.kernels import rmsnorm as rn

    g = torch.Generator(device="cuda").manual_seed(1)
    m, d = 300, 2048
    x = torch.empty(m * d + 1, dtype=dtype, device="cuda")[1:].view(m, d)
    x.copy_(torch.randn((m, d), generator=g, device="cuda"))
    s = torch.randn((d,), generator=g, device="cuda").to(dtype)
    assert x.is_contiguous()
    assert not rn.vector_route(x.data_ptr(), s.data_ptr(), 0, d,
                               x.element_size())
    tol = RMS_TOL[dtype]
    assert torch.allclose(rn.fused_rmsnorm(x, s).float(),
                          rn.rmsnorm_plain(x, s).float(), rtol=tol, atol=tol)


def _batch(n):
    sys.path.insert(0, str(ROOT))
    from chip_smoke import _as_args, guard_lanes, make_lanes

    return _as_args(guard_lanes() if n == "guard" else make_lanes(n, seed=7))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 185, 1024, 1025, 1 << 20, "guard"])
def test_finish_cost_batch_bitwise(n):
    """A batch from NumPy to NumPy through pinned host memory (zero copy),
    bitwise against the plain version on the CPU: either side of the
    staging buffers' first size (1,024 lanes; the next batch grows them),
    at a million lanes and on the guard-boundary lanes."""
    needs_gpu()
    from repro_torch.kernels import finish_batch as fb

    args = _batch(n)
    got = fb.finish_cost_batch(*args, device="cuda")
    want = fb.finish_cost_batch(*args, device="cpu")
    assert len(got) == 9
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.gpu
def test_successive_batches_on_the_card_do_not_share_memory():
    """A batch reuses the pinned buffers: a batch's results must
    be the caller's, unchanged by the next batch."""
    needs_gpu()
    from repro_torch.kernels import finish_batch as fb

    first = fb.finish_cost_batch(*_batch(185), device="cuda")
    kept = [a.copy() for a in first]
    second = fb.finish_cost_batch(*_batch(186), device="cuda")
    assert not any(np.shares_memory(a, b) for a in first for b in second)
    assert all(np.array_equal(a, k) for a, k in zip(first, kept))


@pytest.mark.gpu
def test_plan_server_first_requests_build_the_kernel_once(tmp_path,
                                                         monkeypatch):
    """Two distinct GA requests reach a fresh plan server at once, with no
    library built yet: the search threads build B1 once, under one name,
    and both results equal the ``vector`` backend's."""
    needs_gpu()
    import threading

    from repro_torch.api import ExploreSpec, GAOptions, ResultStore, run
    from repro_torch.kernels import _build
    from repro_torch.kernels import finish_batch as fb
    from repro_torch.serve import PlanService

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    specs = [ExploreSpec(workload=w, strategy="ga", sample_budget=400,
                         options=GAOptions(population=20))
             for w in ("netlib:resnet50", "synthetic:layered:24?seed=7")]
    svc = PlanService(ResultStore(tmp_path / "store"), workers=2,
                      device="cuda")
    barrier = threading.Barrier(len(specs))
    out = [None] * len(specs)

    def ask(i):
        barrier.wait()
        out[i] = svc.plan(specs[i])

    launches = fb.launches
    try:
        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(len(specs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        svc.close()
    assert fb.launches > launches
    assert [r.served_from for r in out] == ["search", "search"]
    for spec, resp in zip(specs, out):
        assert resp.result.to_json() == \
            run(spec, eval_backend="vector").to_json()
    built = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert len(built) == 2 and built[0].endswith(".log") \
        and built[1].endswith(".so") and ".tmp." not in built[1]


@pytest.mark.gpu
def test_a_new_threads_first_batch_on_cached_pinned_memory():
    """A thread whose first CUDA work is a batch, with its staging buffers
    served from torch's pinned-memory cache (no CUDA call on that thread
    before the kernel's), as a plan server's search thread may be."""
    needs_gpu()
    import threading

    from repro_torch.kernels import finish_batch as fb

    fb.finish_cost_batch(*_batch(185), device="cuda")   # library loaded
    for rows in (fb.N_IN, fb.N_OUT):   # the first staging buffers' sizes
        torch.empty(rows * 1024, dtype=torch.int64, pin_memory=True)
    args = _batch(185)
    out = {}

    def first_batch():
        try:
            out["got"] = fb.finish_cost_batch(*args, device="cuda")
        except RuntimeError as err:
            out["err"] = err

    t = threading.Thread(target=first_batch)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert "err" not in out, out.get("err")
    want = fb.finish_cost_batch(*args, device="cpu")
    for g, w in zip(out["got"], want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


@pytest.mark.gpu
def test_kernel_wrappers_refuse_inputs_that_require_grad():
    """A kernel's output carries no ``grad_fn``: called directly on an
    input that requires grad, with grad enabled, a wrapper raises rather
    than cut the graph; ``ops`` takes the autograd Function instead."""
    needs_gpu()
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rn

    x = torch.randn(8, 64, device="cuda", requires_grad=True)
    scale = torch.ones(64, device="cuda")
    with pytest.raises(RuntimeError, match="grad_fn"):
        rn.fused_rmsnorm(x, scale)
    w = torch.randn(64, 32, device="cuda")
    with pytest.raises(RuntimeError, match="grad_fn"):
        ff.fused_swiglu(x, w, w, w.t().contiguous())
    with torch.no_grad():
        assert rn.fused_rmsnorm(x, scale).grad_fn is None
    out = ops.rmsnorm(x, scale)
    assert "RMSNorm" in type(out.grad_fn).__name__
    (g,) = torch.autograd.grad(out.sum(), x)
    assert bool(torch.isfinite(g).all())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "jamba-v0.1-52b",
                                  "xlstm-350m"])
def test_train_step_on_the_card_equals_the_cpu(arch):
    """One fp32 smoke train step: loss within 1e-5, every gradient within
    1e-4 of the CPU's relative to its norm, the same experts, launches of
    one microbatch under remat (``chip_smoke.py``'s ``train_vs_cpu``)."""
    needs_gpu()
    _chip_smoke()._train_vs_cpu_case(arch)


@pytest.mark.gpu
def test_whisper_on_the_card_equals_the_cpu():
    needs_gpu()
    _chip_smoke().phase_whisper_vs_cpu()


@pytest.mark.gpu
def test_launch_train_restart_replays_on_the_card(tmp_path):
    """The smoke trainer on the card: a failure injected at step 3
    restores the step-2 checkpoint and replays the uninterrupted run's
    losses bit for bit."""
    needs_gpu()
    from repro_torch.launch import train

    base = ["--device", "cuda", "--smoke", "--steps", "5", "--seq", "32",
            "--batch", "4", "--microbatches", "2"]
    plain = train.run(train.parser().parse_args(base))
    failed = train.run(train.parser().parse_args(
        base + ["--ckpt-dir", str(tmp_path), "--save-every", "2",
                "--fail-at", "3"]))
    assert [s for s, _ in failed["losses"]] == [0, 1, 2, 2, 3, 4]
    assert dict(failed["losses"]) == dict(plain["losses"])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "jamba-v0.1-52b"])
def test_plan_h100_on_the_card_equals_vector(arch):
    """Cocco as the H100's planner with its GA batches on the card (B1
    once a batch) gives the vector backend's plan on the CPU."""
    needs_gpu()
    from repro_torch.configs import get_config
    from repro_torch.core.h100_adapter import plan_architecture
    from repro_torch.kernels import finish_batch as fb

    cfg = get_config(arch)
    fb.launches = 0
    card = plan_architecture(cfg, sample_budget=300, device="cuda")
    assert fb.launches > 0
    want = plan_architecture(cfg, sample_budget=300, device="cpu",
                             eval_backend="vector")
    for field in _chip_smoke().PLAN_FIELDS:
        assert getattr(card, field) == getattr(want, field), field


@pytest.mark.gpu
def test_plan_server_smoke_script_passes_on_the_card():
    """``scripts/smoke_serve_plans_torch.py --device cuda``: the plan
    server's five checks with its searches on the card."""
    needs_gpu()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "smoke_serve_plans_torch.py"),
         "--device", "cuda"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "smoke OK:" in proc.stdout


@pytest.mark.gpu
def test_mesh_of_one_train_step_is_the_unsharded_step_on_the_card():
    """The smoke trainer on a (1, 1) mesh of DTensors under a world-1
    NCCL group: B2-B4 through local_map, the losses and every parameter
    bit for bit those of the run without a mesh, launches equal and as
    the structure implies."""
    needs_gpu()
    import torch.distributed as dist

    from repro_torch.checkpoint import keypath_items
    from repro_torch.configs import get_config
    from repro_torch.launch import train

    cs = _chip_smoke()
    counters = cs._lm_counters()
    base = ["--device", "cuda", "--smoke", "--steps", "2", "--seq", "32",
            "--batch", "4", "--microbatches", "2"]

    def counted(argv):
        for mod in counters.values():
            mod.launches = 0
        out = train.run(train.parser().parse_args(argv))
        return out, {lib: mod.launches for lib, mod in counters.items()}

    plain, plain_launches = counted(base)
    assert train._process_group("cuda")
    try:
        meshed, launches = counted(base + ["--model-parallel", "1"])
        assert meshed["losses"] == plain["losses"]
        want = dict(keypath_items(plain["state"]["params"]))
        for k, v in keypath_items(meshed["state"]["params"]):
            assert hasattr(v, "placements"), k
            assert torch.equal(v.full_tensor(), want[k]), k
    finally:
        dist.destroy_process_group()
    per_mb = cs._per_forward(get_config("tinyllama-1.1b", smoke=True),
                             scanned_times=2)
    assert launches == plain_launches == {
        lib: n * 2 * 2 for lib, n in per_mb.items()}


@pytest.mark.gpu
def test_int8_error_feedback_on_the_card_equals_the_cpu():
    """q, the scales, the residual and the dequantized gradient of int8
    error-feedback compression bit for bit the CPU's, over tensors of up
    to 2**24 elements (where a quotient one bit off flips some rounding)."""
    needs_gpu()
    from repro_torch.parallel import collectives as coll

    g = torch.Generator().manual_seed(0)
    host = {f"w{n}": torch.randn((n,), generator=g) * 3.0
            for n in (1, 1000, 1 << 20, 1 << 24)}
    card = {k: v.cuda() for k, v in host.items()}
    for _ in range(2):
        q, s, ef = coll.compress_int8_ef(card, coll.ef_init(card))
        hq, hs, hef = coll.compress_int8_ef(host, coll.ef_init(host))
        for k in host:
            assert torch.equal(q[k].cpu(), hq[k]), k
            assert torch.equal(s[k].cpu(), hs[k]), k
            assert torch.equal(ef.residual[k].cpu(), hef.residual[k]), k
        card = {k: v * 1.7 for k, v in card.items()}
        host = {k: v * 1.7 for k, v in host.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["flash_attention", "fused_swiglu",
                                  "fused_swiglu_with_hidden",
                                  "fused_rmsnorm"])
def test_kernel_ops_pass_opcheck_on_card_tensors(name):
    """Each kernel's torch op on real card tensors: its schema, its fake
    implementation against the kernel's output (shape, dtype, strides),
    and its output equal to the launcher's, launch for launch."""
    needs_gpu()
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import rmsnorm as rn

    g = torch.Generator(device="cuda").manual_seed(7)

    def t(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    args = {
        "flash_attention": (t(2, 8, 96, 64), t(2, 2, 96, 64),
                            t(2, 2, 96, 64), True, 0, None),
        "fused_swiglu": (t(40, 256), t(256, 704), t(256, 704),
                         t(704, 256)),
        "fused_swiglu_with_hidden": (t(40, 256), t(256, 704), t(256, 704),
                                     t(704, 256)),
        "fused_rmsnorm": (t(40, 256), t(256), 1e-5),
    }[name]
    op = getattr(torch.ops.repro_torch, name).default
    torch.library.opcheck(op, args,
                          test_utils=("test_schema", "test_faketensor"))
    launcher = {"flash_attention": fa.flash_attention,
                "fused_swiglu": ff.fused_swiglu,
                "fused_swiglu_with_hidden": ff.fused_swiglu_with_hidden,
                "fused_rmsnorm": rn.fused_rmsnorm}[name]
    mod = {"flash_attention": fa, "fused_rmsnorm": rn}.get(name, ff)
    before = mod.launches
    got, want = op(*args), launcher(*args)
    assert mod.launches == before + 2
    for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (got, want))):
        assert torch.equal(a, b)
