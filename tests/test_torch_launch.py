"""B4 (RMSNorm) and B1 (finish_batch) around their launches, on the CPU.

* The port's ``rmsnorm_plain`` (what a CPU tensor gets, and what the CUDA
  kernel is held to on the card) against the JAX package's Pallas kernel in
  interpret mode at qk-norm's head widths, tolerance ``TOL`` of
  ``tests/test_kernels.py`` (fp32 2e-5, bf16 2e-2).
* B4's choice, before a launch, of its 16-byte route by alignment and
  row width.
* ``finish_cost_batch`` on the CPU, bitwise against the reference's
  ``vector`` backend, and owning its results.
* The shared launch path's checks (device, contiguity, dtype), which raise
  ``ValueError`` before anything is launched; and B2's and B3's wrappers
  handing their launches to it, as B1's and B4's do.

The kernels themselves run only on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import fused_rmsnorm  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import finish_batch as fb  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _lanes(n, seed):
    from chip_smoke import _as_args, make_lanes

    return _as_args(make_lanes(n, seed=seed))


@pytest.fixture(autouse=True)
def _repo_root_on_path(monkeypatch):
    from pathlib import Path

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [256, 512])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_rmsnorm_plain_matches_pallas_at_qk_norm_widths(d, m, dtype):
    rng = np.random.default_rng(d + m)
    x = rng.standard_normal((m, d)).astype(np.float32)
    s = rng.standard_normal((d,)).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = fused_rmsnorm(jx, jnp.asarray(s), block_m=256, interpret=True)
    got = rn.rmsnorm_plain(tx, torch.from_numpy(s))
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("ptrs,d,itemsize,vec", [
    ((0, 0, 0), 2048, 2, True),        # the serving rows
    ((4096, 512, 1024), 64, 2, True),  # qk-norm rows, 8 bf16 a unit
    ((0, 0, 0), 4, 4, True),           # one fp32 unit a row
    ((0, 0, 0), 2047, 2, False),       # rows not whole 16-byte units
    ((0, 0, 0), 6, 4, False),
    ((2, 0, 0), 2048, 2, False),       # x one bf16 off a 16-byte boundary
    ((0, 8, 0), 2048, 4, False),       # scale 8 bytes off
    ((0, 0, 4), 2048, 4, False),       # out 4 bytes off
])
def test_rmsnorm_vector_route_is_chosen_by_alignment_and_width(ptrs, d,
                                                               itemsize, vec):
    assert rn.vector_route(*ptrs, d, itemsize) is vec


def test_rmsnorm_vector_route_sees_a_storage_offset():
    """A contiguous view one element into its storage, as
    ``x.reshape(-1, d).contiguous()`` can hand over, starts off a 16-byte
    boundary: the shape alone would allow 16-byte units, the pointer does
    not."""
    base = torch.zeros(8 * 2048 + 1, dtype=torch.bfloat16)
    x = base[1:].view(8, 2048)
    assert x.is_contiguous() and x.storage_offset() == 1
    s = torch.ones(2048, dtype=torch.bfloat16)
    aligned = torch.zeros(8, 2048, dtype=torch.bfloat16)
    assert rn.vector_route(aligned.data_ptr(), s.data_ptr(), 0, 2048, 2)
    assert not rn.vector_route(x.data_ptr(), s.data_ptr(), 0, 2048, 2)


@pytest.mark.parametrize("n", [1, 185, 1024, 1025])
def test_finish_cost_batch_on_cpu_matches_reference(n):
    """Against the JAX package's ``vector`` backend (NumPy), bitwise."""
    from repro.core.engine import VectorExecutor

    args = _lanes(n, n)
    got = fb.finish_cost_batch(*args, device="cpu")
    want = VectorExecutor()._finish_arrays(*args)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_successive_cpu_batches_do_not_share_memory():
    first = fb.finish_cost_batch(*_lanes(185, 5), device="cpu")
    kept = [a.copy() for a in first]
    second = fb.finish_cost_batch(*_lanes(185, 6), device="cpu")
    assert not any(np.shares_memory(a, b) for a in first for b in second)
    assert all(np.array_equal(a, k) for a, k in zip(first, kept))


def test_dtype_codes_are_keyed_by_torch_dtype():
    assert _build.dtype_code("k", torch.zeros(1)) == 0
    assert _build.dtype_code("k", torch.zeros(1, dtype=torch.bfloat16)) == 1
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        _build.dtype_code("k", torch.zeros(1, dtype=torch.float16))


@pytest.mark.parametrize("case", ["cpu", "meta", "strided", "mixed"])
def test_fused_rmsnorm_refuses_what_the_kernel_does_not_take(case):
    x = {"cpu": torch.zeros(4, 8), "meta": torch.zeros(4, 8, device="meta"),
         "strided": torch.zeros(4, 16)[:, ::2],
         "mixed": torch.zeros(4, 8, device="meta")}[case]
    before = rn.launches
    with pytest.raises(ValueError):
        rn.fused_rmsnorm(x, torch.zeros(8, device="cpu" if case == "mixed"
                                        else x.device))
    with pytest.raises(ValueError, match="scale"):
        rn.fused_rmsnorm(x, torch.zeros(7, device=x.device))
    assert rn.launches == before


def test_b2_and_b3_launch_through_the_launch_helper(monkeypatch):
    """B3's and B2's wrappers hand their C entry point, the device index
    the checks return and the entry's arguments but the stream to
    ``_build.launch`` (which adds the raw stream handle and switches
    devices only when needed), and count one launch each.  Run on CPU
    tensors with the checks, the library and the launch stubbed."""
    from types import SimpleNamespace

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_ffn as ff

    calls = []
    lib = SimpleNamespace(fused_ffn_launch="ffn_entry",
                          fused_ffn_workspace=lambda m, d, f, code: 0,
                          flash_attention_launch="attn_entry")
    monkeypatch.setattr(_build, "check_cuda_tensors",
                        lambda name, *t, contiguous=True: 3)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "query",
                        lambda entry, index, *args: entry(*args))
    monkeypatch.setattr(_build, "launch",
                        lambda entry, index, *args: calls.append(
                            (entry, index, args)))
    before = ff.launches, fa.launches
    ff.fused_swiglu(torch.zeros(5, 8), torch.zeros(8, 12),
                    torch.zeros(8, 12), torch.zeros(12, 8))
    q, k = torch.zeros(1, 4, 6, 16), torch.zeros(1, 2, 6, 16)
    fa.flash_attention(q, k, k)
    assert [c[:2] for c in calls] == [("ffn_entry", 3), ("attn_entry", 3)]
    assert calls[0][2][-4:] == (5, 8, 12, 0)  # m, d, f, fp32
    for (_, _, args), (lib_name, entry) in zip(calls, [
            ("fused_ffn", "fused_ffn_launch"),
            ("flash_attention", "flash_attention_launch")]):
        argtypes = _build._SIGNATURES[lib_name][entry][0]
        assert len(args) == len(argtypes) - 1  # all but the stream
    assert (ff.launches, fa.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("B,T,splits", [(16, 300, 4), (66, 300, 1)])
def test_mla_decode_launches_through_the_launch_helper(monkeypatch, B, T,
                                                       splits):
    """The latent decode's wrapper hands ``_build.launch`` its C entry
    point and every argument of the entry's signature but the stream: the
    operands in place (the absorbed query a ``[B, H, 512]`` view of an
    ``[H, B, 512]`` product, the cache's rope keys a view of ``[B, T, 1,
    64]``), the splits :func:`splits_for` picks for 132 SMs, a workspace
    of ``B * H * splits * 514`` floats where there is more than one split
    (none at 66 rows: 132 blocks fill the card), their strides and the
    scale; one launch counted.  Run on CPU tensors with the checks, the
    library and the launch stubbed."""
    from types import SimpleNamespace

    from repro_torch.kernels import mla_decode as md

    calls = []
    monkeypatch.setattr(_build, "check_cuda_tensors",
                        lambda name, *t, contiguous=True: 3)
    monkeypatch.setattr(_build, "load", lambda name: SimpleNamespace(
        mla_decode_launch="mla_entry"))
    monkeypatch.setattr(_build, "launch",
                        lambda entry, index, *args: calls.append(
                            (entry, index, args)))
    monkeypatch.setitem(md._SMS, 3, 132)
    H, bf16 = 128, torch.bfloat16
    q_lat = torch.zeros((H, B, 512), dtype=bf16).transpose(0, 1)
    q_rope = torch.zeros((B, H, 192), dtype=bf16)[..., 128:]
    ckv = torch.zeros((B, T, 512), dtype=bf16)
    k_rope = torch.zeros((B, T, 1, 64), dtype=bf16)[:, :, 0]
    pos = torch.full((B, 1), T - 1)[:, 0]
    before = md.launches
    out = md.mla_decode(q_lat, q_rope, ckv, k_rope, pos, 0.25)
    assert out.shape == (B, H, 512) and out.is_contiguous()
    [(entry, index, args)] = calls
    assert (entry, index) == ("mla_entry", 3)
    assert len(args) == len(
        _build._SIGNATURES["mla_decode"]["mla_decode_launch"][0]) - 1
    assert args[7:13] == (B, H, T, 512, 64, splits)
    assert (args[6] is None) == (splits == 1)
    assert args[13:] == (512, B * 512, H * 192, 192, T * 512, 512, T * 64,
                         64, 1, H * 512, 512, 0.25)
    assert md.launches == before + 1
