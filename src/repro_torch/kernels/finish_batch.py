"""Batched ``finish_cost`` arithmetic on a torch device.

The device-resident half of the ``torch`` executor backend
(:class:`repro_torch.core.engine.TorchExecutor`): a whole GA generation's
distinct ``(structure, AcceleratorConfig)`` queries arrive as
struct-of-arrays int64 buffers, and the capacity / streaming /
weight-sharing arithmetic of :func:`repro_torch.core.cost.finish_cost`
runs as one device call.

Two implementations of one function, chosen by where the tensor lies:

* on a CUDA tensor, the hand-written kernel in ``csrc/finish_batch.cu``
  (built by :mod:`repro_torch.kernels._build`, bound with ``ctypes``), one
  launch per batch.  A failed build or launch raises; nothing falls back.
* on a CPU tensor, :func:`_finish_torch`, the kernel's plain torch version.

Bitwise parity with the scalar kernel is the contract (the engine's guards
keep every lane below ``2**53`` and int64-product-safe, see
:func:`repro_torch.core.engine.needs_scalar_fallback`).  The streaming
block count is ``ceil`` of a float64 true division, exactly as
``_stream_single_layer``'s ``math.ceil(fp / glb)``.

Lane layout: the seven inputs are the rows of one ``[7, n]`` int64 tensor
(``fp, w_total, single, glb, wbuf, shared, share``; the two masks as 0/1),
the nine outputs the rows of one ``[9, n]`` int64 tensor (``wr, n_blocks,
ema_w, fp_out, noc, infeasible_buf, w_overflow, stream, feasible``).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import numpy as np
import torch

from repro_torch.obs import recorder as obs

from . import _build

N_IN = 7
N_OUT = 9

#: launches of the CUDA kernel in this process (the wrapper adds one per
#: launch and nowhere else; callers may reset it to 0)
launches = 0
# the count is shared by every thread that launches (the plan server's
# search workers)
_LAUNCHES_LOCK = threading.Lock()


def _finish_torch(fp, w_total, single, glb, wbuf, shared, share):
    """Whole-batch ``finish_cost`` arithmetic in plain torch.

    Line for line the reference's jnp expression: int64 lanes, bool masks,
    the block count through a float64 true division.
    """
    wr = torch.div(w_total, share, rounding_mode="floor")
    # mirrors _stream_single_layer: math.ceil of a float64 true division
    n_blocks = torch.clamp_min(torch.ceil(
        fp.to(torch.float64) / glb.clamp_min(1).to(torch.float64)
    ).to(torch.int64), 1)
    wbuf_cap = torch.where(shared, glb, wbuf)
    overflow = torch.where(shared, fp + wr > glb, fp > glb)
    infeasible_buf = overflow & ~single
    stream = overflow & single
    ema_w = torch.where(stream, wr * n_blocks, w_total)
    fp_out = torch.where(stream, torch.minimum(fp, glb), fp)
    w_overflow = ~shared & ~single & ~infeasible_buf & (wr > wbuf_cap)
    feasible = ~(infeasible_buf | w_overflow)
    # §5.4.2 NoC charge: every DRAM-loaded weight byte crosses the fabric
    # to the share - 1 peer cores
    noc = (share - 1) * ema_w
    return (wr, n_blocks, ema_w, fp_out, noc, infeasible_buf, w_overflow,
            stream, feasible)


def _launch(index: int, in_ptr: int, out_ptr: int, n: int) -> None:
    """One launch of the CUDA kernel on the current stream of device
    ``index`` (no sync), over device-addressable ``[7, n]`` lanes and
    ``[9, n]`` results.  Building or loading the library happens here and
    nowhere else: a missing ``nvcc`` or a failed build raises."""
    global launches
    _build.launch(_build.load("finish_batch").finish_batch_launch, index,
                  in_ptr, out_ptr, n)
    with _LAUNCHES_LOCK:
        launches += 1


def finish_lanes(lanes: torch.Tensor) -> torch.Tensor:
    """``[7, n]`` int64 lanes -> ``[9, n]`` int64 results, on their device.

    A CUDA tensor goes through the CUDA kernel, a CPU tensor through
    :func:`_finish_torch`.  Anything else (another device, dtype or shape,
    a non-contiguous tensor) raises ``ValueError``.
    """
    if lanes.dtype != torch.int64 or lanes.dim() != 2 \
            or lanes.shape[0] != N_IN:
        raise ValueError(
            f"finish_lanes expects a [{N_IN}, n] int64 tensor, got "
            f"{list(lanes.shape)} {lanes.dtype}")
    if not lanes.is_contiguous():
        raise ValueError("finish_lanes expects a contiguous tensor")
    if lanes.is_cuda:
        n = lanes.shape[1]
        out = lanes.new_empty((N_OUT, n))
        if n:
            _launch(lanes.get_device(), lanes.data_ptr(), out.data_ptr(), n)
        return out
    if lanes.device.type != "cpu":
        raise ValueError(
            f"finish_lanes runs on cuda or cpu tensors, not {lanes.device}")
    return finish_lanes_plain(lanes)


def finish_lanes_plain(lanes: torch.Tensor) -> torch.Tensor:
    """:func:`_finish_torch` over ``[7, n]`` lanes, on any device: the
    plain version the CUDA kernel is held against."""
    fp, w_total, single, glb, wbuf, shared, share = lanes.unbind(0)
    outs = _finish_torch(fp, w_total, single != 0, glb, wbuf, shared != 0,
                         share)
    return torch.stack([o.to(torch.int64) for o in outs])


class _Staging:
    """Pinned host buffers for one device's batches, grown as batches grow
    and reused by every batch after: ``[7, n]`` lanes in, ``[9, n]``
    results out, each with the device pointer through which the card
    reaches it (checked once, when the buffer is made)."""

    def __init__(self) -> None:
        self.cap = 0
        self.index = None

    def reserve(self, n: int, device: torch.device) -> None:
        """Buffers for ``n`` lanes, and ``index``, the CUDA device the batch
        runs on.  New buffers are allocated before the device is resolved,
        so that a machine without a card refuses at the allocation."""
        cap = max(n, 2 * self.cap, 1024) if n > self.cap else 0
        hosts = [torch.empty(rows * cap, dtype=torch.int64, pin_memory=True)
                 for rows in (N_IN, N_OUT)] if cap else ()
        self.index = (device.index if device.index is not None
                      else torch.cuda.current_device())
        if not hosts:
            return
        lib = _build.load("finish_batch")
        bufs = []
        for host in hosts:
            dev = ctypes.c_void_p()
            with torch.cuda.device(self.index):
                err = lib.finish_batch_device_ptr(host.data_ptr(),
                                                  ctypes.byref(dev))
            if err != 0:
                raise RuntimeError(
                    f"pinned host memory is not mapped for CUDA device "
                    f"{self.index} (cudaError_t {err}): the zero-copy "
                    f"batch cannot run")
            bufs.append((host, host.numpy(), dev.value))
        (self.lanes, self.lanes_np, self.lanes_dev), \
            (self.out, self.out_np, self.out_dev) = bufs
        self.cap = cap


_STAGING = threading.local()


def _staging(device: torch.device, n: int) -> _Staging:
    """This thread's staging buffers for ``device``, holding ``n`` lanes."""
    per_device = getattr(_STAGING, "per_device", None)
    if per_device is None:
        per_device = _STAGING.per_device = {}
    st = per_device.get(device.index)
    if st is None:
        st = per_device[device.index] = _Staging()
    st.reserve(n, device)
    return st


def _zero_copy(st: _Staging, n: int) -> None:
    """The kernel straight from the pinned lanes into the pinned results,
    then one sync.  While a recorder is on, CUDA events time the launch into
    ``kernel.finish_batch.zero_copy_ms``: the kernel with its reads and
    writes across the host link, which are the whole crossing."""
    rec = obs.current()
    if not rec.enabled:
        _launch(st.index, st.lanes_dev, st.out_dev, n)
        _sync(st.index)
        return
    with torch.cuda.device(st.index):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        _launch(st.index, st.lanes_dev, st.out_dev, n)
        ev[1].record()
        _sync(st.index)
    rec.add("kernel.finish_batch.zero_copy_ms", ev[0].elapsed_time(ev[1]))


def _sync(index: int) -> None:
    err = _build.load("finish_batch").finish_batch_sync(
        _build.current_stream(index))
    if err != 0:
        raise RuntimeError(f"finish_batch kernel failed: cudaError_t {err}")


def finish_cost_batch(fp, w_total, single, glb, wbuf, shared, share,
                      device="cuda") -> Tuple[np.ndarray, ...]:
    """Evaluate a batch of ``finish_cost`` queries on ``device``.

    Inputs are index-aligned equal-length NumPy arrays (int64 values, bool
    masks); every lane must already satisfy the engine's scalar-fallback
    guards.  Returns ``(wr, n_blocks, ema_w, fp_out, noc, infeasible_buf,
    w_overflow, stream, feasible)`` as NumPy arrays (int64, then bool),
    bit-identical to the scalar kernel and to the ``vector`` backend, and
    owned by the caller (no later batch writes into them).

    On a CUDA device the lanes are written into pinned host memory, and
    one launch reads them there and writes the results into pinned host
    memory (zero copy: no copy, no device allocation), then one sync.
    With a telemetry recorder installed, CUDA events time the launch into
    the recorder's ``kernel.finish_batch.zero_copy_ms`` (milliseconds).
    """
    device = torch.device(device)
    n = len(fp)
    if n == 0:
        empty_i = np.zeros(0, dtype=np.int64)
        empty_b = np.zeros(0, dtype=bool)
        return (empty_i,) * 5 + (empty_b,) * 4
    columns = (fp, w_total, single, glb, wbuf, shared, share)
    if device.type != "cuda":
        lanes = torch.empty((N_IN, n), dtype=torch.int64)
        view = lanes.numpy()
        for row, arr in enumerate(columns):
            view[row] = arr
        res = finish_lanes(lanes).numpy()
        return tuple(res[:5]) + tuple(res[5:] != 0)
    st = _staging(device, n)
    view = st.lanes_np[:N_IN * n].reshape(N_IN, n)
    for row, arr in enumerate(columns):
        view[row] = arr
    _zero_copy(st, n)
    res = st.out_np[:N_OUT * n].reshape(N_OUT, n)
    return tuple(res[:5].copy()) + tuple(res[5:] != 0)
