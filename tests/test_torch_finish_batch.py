"""The port's batched ``finish_cost`` arithmetic against the JAX package's.

``_finish_torch`` (the plain version of the CUDA kernel, which the wrapper
takes for CPU tensors) must equal ``repro.kernels.finish_batch.
finish_cost_batch`` bit for bit, both with the Pallas kernel (in interpret
mode, as the JAX package runs it off-TPU) and with its jnp variant, on the
same seeded lanes and guard-boundary values that ``chip_smoke.py`` holds
the CUDA kernel to on the card.  Tolerance: bitwise.

The reference module imports ``jax.experimental.enable_x64``, which newer
jax releases dropped in favour of ``jax.enable_x64``.  The loader below
supplies that one name for the duration of the import only, and then takes
the module out of ``sys.modules`` again, so the JAX package's own tests see
exactly the jax backend availability they would see without this file.
"""

import importlib
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.experimental  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import finish_batch as fb  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import guard_lanes, make_lanes  # noqa: E402

OUT_DTYPES = (np.int64,) * 5 + (np.bool_,) * 4


def _load_reference_finish_batch():
    name = "repro.kernels.finish_batch"
    shim = not hasattr(jax.experimental, "enable_x64")
    if shim:
        jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    try:
        module = importlib.import_module(name)
    finally:
        if shim:
            del jax.experimental.enable_x64
            sys.modules.pop(name, None)
            vars(sys.modules["repro.kernels"]).pop("finish_batch", None)
    return module


ref_fb = _load_reference_finish_batch()


def _as_args(lanes: np.ndarray):
    """``[7, n]`` int64 lanes -> the seven arrays both packages take."""
    fp, w_total, single, glb, wbuf, shared, share = lanes
    return (fp, w_total, single.astype(bool), glb, wbuf, shared.astype(bool),
            share)


def _assert_bitwise(got, want):
    assert len(got) == len(want) == 9
    for i, (g, w, dt) in enumerate(zip(got, want, OUT_DTYPES)):
        assert g.dtype == dt and w.dtype == dt, (i, g.dtype, w.dtype)
        assert np.array_equal(g, w), f"output {i} differs"


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "jnp"])
@pytest.mark.parametrize("n", [1, 255, 257, 1000])
def test_finish_torch_matches_reference_on_seeded_lanes(n, use_pallas):
    args = _as_args(make_lanes(n, seed=n))
    _assert_bitwise(fb.finish_cost_batch(*args, device="cpu"),
                    ref_fb.finish_cost_batch(*args, use_pallas=use_pallas))


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "jnp"])
def test_finish_torch_matches_reference_on_guard_boundaries(use_pallas):
    args = _as_args(guard_lanes())
    _assert_bitwise(fb.finish_cost_batch(*args, device="cpu"),
                    ref_fb.finish_cost_batch(*args, use_pallas=use_pallas))


def test_empty_batch_gives_nine_empty_arrays():
    empty = (np.zeros(0, dtype=np.int64),) * 7
    got = fb.finish_cost_batch(*empty, device="cpu")
    _assert_bitwise(got, ref_fb.finish_cost_batch(*empty))
    assert all(len(a) == 0 for a in got)


def test_cuda_call_raises_instead_of_falling_back(monkeypatch, tmp_path):
    """With no kernel library to be had, a CUDA batch raises: it never
    reaches the plain version and counts no launch.  The library is loaded
    in one place, at the launch; without a card the batch stops earlier,
    at staging its pinned host buffer, and raises there."""

    def plain_must_not_run(*args):
        raise AssertionError("a CUDA batch reached the plain version")

    monkeypatch.setattr(fb, "_finish_torch", plain_must_not_run)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "_LOADED", {})
    before = fb.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("finish_batch")
    expect = ("nvcc not found" if torch.cuda.is_available()
              else "pin_memory|accelerator|CUDA")
    with pytest.raises(RuntimeError, match=expect):
        fb.finish_cost_batch(*_as_args(make_lanes(8)), device="cuda")
    assert fb.launches == before


@pytest.mark.parametrize("case", ["dtype", "shape", "strided", "device"])
def test_finish_lanes_rejects_what_the_kernel_does_not_take(case):
    lanes = torch.from_numpy(make_lanes(6))
    bad = {
        "dtype": lanes.to(torch.int32),
        "shape": lanes[:6],
        "strided": lanes[:, ::2],
        "device": lanes.to("meta"),
    }[case]
    with pytest.raises(ValueError):
        fb.finish_lanes(bad)


def test_finish_lanes_on_cpu_is_the_plain_version():
    lanes = torch.from_numpy(make_lanes(300, seed=3))
    out = fb.finish_lanes(lanes)
    assert out.shape == (9, 300) and out.dtype == torch.int64
    want = fb.finish_cost_batch(*_as_args(lanes.numpy()), device="cpu")
    for row, w in zip(out.numpy(), want):
        assert np.array_equal(row, w.astype(np.int64))
