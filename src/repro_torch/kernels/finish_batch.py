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

from typing import Tuple

import numpy as np
import torch

from repro_torch.obs import recorder as obs

N_IN = 7
N_OUT = 9

#: launches of the CUDA kernel in this process (the wrapper adds one per
#: launch and nowhere else; callers may reset it to 0)
launches = 0


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


def _launch_cuda(lanes: torch.Tensor, out: torch.Tensor) -> None:
    """One launch of the CUDA kernel on the current stream of the lanes'
    device (no sync).  Building or loading the library happens here and
    nowhere else: a missing ``nvcc`` or a failed build raises."""
    global launches
    from . import _build

    lib = _build.load("finish_batch")
    with torch.cuda.device(lanes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.finish_batch_launch(lanes.data_ptr(), out.data_ptr(),
                                      lanes.shape[1], stream)
    if err != 0:
        raise RuntimeError(
            f"finish_batch kernel launch failed: cudaError_t {err}")
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
    if lanes.device.type == "cuda":
        out = torch.empty((N_OUT, lanes.shape[1]), dtype=torch.int64,
                          device=lanes.device)
        if lanes.shape[1]:
            _launch_cuda(lanes, out)
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


def _finish_on_card(lanes: torch.Tensor,
                    device: torch.device) -> torch.Tensor:
    """Pinned lanes -> device -> kernel -> pinned results, on the current
    stream; timed with CUDA events while a telemetry recorder is on."""
    n = lanes.shape[1]
    stream = torch.cuda.current_stream()
    rec = obs.current()
    ev = ([torch.cuda.Event(enable_timing=True) for _ in range(4)]
          if rec.enabled else None)
    if ev:
        ev[0].record(stream)
    lanes_dev = lanes.to(device, non_blocking=True)
    if ev:
        ev[1].record(stream)
    out_dev = finish_lanes(lanes_dev)
    if ev:
        ev[2].record(stream)
    out = torch.empty((N_OUT, n), dtype=torch.int64, pin_memory=True)
    out.copy_(out_dev, non_blocking=True)
    if ev:
        ev[3].record(stream)
    stream.synchronize()
    if ev:
        rec.add("kernel.finish_batch.h2d_ms", ev[0].elapsed_time(ev[1]))
        rec.add("kernel.finish_batch.kernel_ms", ev[1].elapsed_time(ev[2]))
        rec.add("kernel.finish_batch.d2h_ms", ev[2].elapsed_time(ev[3]))
    return out


def finish_cost_batch(fp, w_total, single, glb, wbuf, shared, share,
                      device="cuda") -> Tuple[np.ndarray, ...]:
    """Evaluate a batch of ``finish_cost`` queries on ``device``.

    Inputs are index-aligned equal-length NumPy arrays (int64 values, bool
    masks); every lane must already satisfy the engine's scalar-fallback
    guards.  Returns ``(wr, n_blocks, ema_w, fp_out, noc, infeasible_buf,
    w_overflow, stream, feasible)`` as NumPy arrays (int64, then bool),
    bit-identical to the scalar kernel and to the ``vector`` backend.

    On a CUDA device the lanes cross in one pinned ``[7, n]`` host-to-device
    copy, the kernel runs once on the current stream, and the results come
    back in one ``[9, n]`` device-to-host copy.  With a telemetry recorder
    installed, CUDA events time the three steps into the recorder's
    ``kernel.finish_batch.*`` counters (milliseconds).
    """
    device = torch.device(device)
    n = len(fp)
    if n == 0:
        empty_i = np.zeros(0, dtype=np.int64)
        empty_b = np.zeros(0, dtype=bool)
        return (empty_i,) * 5 + (empty_b,) * 4
    cuda = device.type == "cuda"
    lanes = torch.empty((N_IN, n), dtype=torch.int64, pin_memory=cuda)
    view = lanes.numpy()
    for row, arr in enumerate((fp, w_total, single, glb, wbuf, shared,
                               share)):
        view[row] = arr
    if not cuda:
        out = finish_lanes(lanes)
    else:
        with torch.cuda.device(device):
            out = _finish_on_card(lanes, device)
    res = out.numpy()
    return tuple(res[:5]) + tuple(res[5:] != 0)
