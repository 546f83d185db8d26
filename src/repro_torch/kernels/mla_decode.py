"""MLA decode in latent space (no TPU kernel: the JAX package decodes MLA
in plain jnp, re-expanding the whole latent cache every step).

:func:`mla_decode` launches the hand-written CUDA kernel in
``csrc/mla_decode.cu``: one query a row attends over DeepSeek-V2's
compressed cache in place, every head against the one shared 576-wide key
(``ckv`` and ``k_rope``) and 512-wide value (``ckv``), with the query and
the output kept in latent space (``q_lat = q_nope W_UK[h]ᵀ`` before it,
``o_lat W_UV[h]`` after it, both outside the kernel).  It takes CUDA
tensors only.  :func:`mla_decode_plain` is its plain torch version, on any
device and in any dtype.  :func:`repro_torch.kernels.ops.mla_decode` picks
between them by the tensor's device.

The kernel is also the torch op ``repro_torch::mla_decode``
(:data:`mla_decode_op`): its CUDA implementation is :func:`mla_decode`,
its fake implementation gives the output's shape, dtype and device and
computes nothing; it has no CPU implementation.
"""

from __future__ import annotations

import torch

from . import _build

#: launches of the CUDA kernel in this process (added to once per call
#: that launches it, its combine included, and nowhere else; callers may
#: reset it to 0)
launches = 0

#: the (kv_lora_rank, rope_head_dim) pairs the CUDA kernel is built for:
#: deepseek-v2's
LATENT_WIDTHS = ((512, 64),)

#: the heads a block of the kernel takes, and the keys a tile
HEAD_TILE, KEY_TILE = 64, 64


def _check_shapes(name, q_lat, q_rope, ckv, k_rope, positions) -> tuple:
    """(B, H, T) of the operands; raises ``ValueError`` if they do not fit
    together."""
    operands = (q_lat, q_rope, ckv, k_rope, positions)
    if [t.dim() for t in operands] != [3, 3, 3, 3, 1]:
        raise ValueError(
            f"{name} expects q_lat [B, H, kvr], q_rope [B, H, r], ckv [B, T, "
            f"kvr], k_rope [B, T, r] and positions [B], got "
            f"{[list(t.shape) for t in operands]}")
    B, H, kvr = q_lat.shape
    T, r = ckv.shape[1], k_rope.shape[-1]
    if (q_rope.shape != (B, H, r) or ckv.shape != (B, T, kvr)
            or k_rope.shape != (B, T, r) or positions.shape != (B,)):
        raise ValueError(
            f"{name}: q_rope {list(q_rope.shape)}, ckv {list(ckv.shape)}, "
            f"k_rope {list(k_rope.shape)}, positions "
            f"{list(positions.shape)} do not fit q_lat {list(q_lat.shape)}")
    return B, H, T


def mla_decode_plain(q_lat: torch.Tensor, q_rope: torch.Tensor,
                     ckv: torch.Tensor, k_rope: torch.Tensor,
                     positions: torch.Tensor, scale: float) -> torch.Tensor:
    """``softmax(scale (q_lat ckvᵀ + q_rope k_ropeᵀ)) ckv`` over the slots
    ``0 .. min(positions[b], T - 1)`` of each row ``b`` (none where the
    position is negative: zeros), in fp32, cast to ``q_lat``'s dtype:
    q_lat ``[B, H, kvr]``, q_rope ``[B, H, r]``, ckv ``[B, T, kvr]``,
    k_rope ``[B, T, r]``, positions ``[B]`` -> ``[B, H, kvr]``; on any
    device."""
    _check_shapes("mla_decode_plain", q_lat, q_rope, ckv, k_rope, positions)
    ckv_f = ckv.float()
    s = (torch.einsum("bhc,btc->bht", q_lat.float(), ckv_f)
         + torch.einsum("bhr,btr->bht", q_rope.float(), k_rope.float()))
    live = (torch.arange(ckv.shape[1], device=ckv.device)[None, :]
            <= positions[:, None])
    s = (s * scale).masked_fill(~live[:, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)  # rows with no live slot
    return torch.einsum("bht,btc->bhc", p, ckv_f).to(q_lat.dtype)


def _check_widths(name, q_lat, q_rope):
    pair = (q_lat.shape[-1], q_rope.shape[-1])
    if pair not in LATENT_WIDTHS:
        raise ValueError(f"{name} is built for the (kv_lora_rank, "
                         f"rope_head_dim) widths {LATENT_WIDTHS}, not {pair}")


def splits_for(B: int, H: int, T: int, sms: int) -> int:
    """The splits of each row's key tiles: as many as leave the ``B x
    ceil(H / 64)`` blocks a split in one wave over ``sms`` SMs (the kernel
    holds one block an SM), at least one, at most a split a tile of the
    ``T`` slots."""
    blocks = B * -(-H // HEAD_TILE)
    return max(1, min(sms // blocks, -(-T // KEY_TILE)))


# SM count by device index, read once a process
_SMS: dict = {}


def mla_decode(q_lat: torch.Tensor, q_rope: torch.Tensor, ckv: torch.Tensor,
               k_rope: torch.Tensor, positions: torch.Tensor,
               scale: float) -> torch.Tensor:
    """The CUDA kernel over q_lat ``[B, H, 512]``, q_rope ``[B, H, 64]``,
    ckv ``[B, T, 512]`` and k_rope ``[B, T, 64]`` (bf16, any strides with
    the last dim contiguous and every other a whole number of 16 bytes,
    16-byte aligned; the cache read where it lies) and positions ``[B]``
    (int64, any stride), on one CUDA device: :func:`mla_decode_plain`'s
    function, returned as a contiguous bf16 ``[B, H, 512]``.  Allocates the
    splits' workspace (:func:`splits_for`) where there is more than one.
    Raises ``ValueError`` on other tensors and widths and ``RuntimeError``
    if the kernel cannot be built or launched."""
    global launches
    B, H, T = _check_shapes("mla_decode", q_lat, q_rope, ckv, k_rope,
                            positions)
    _check_widths("mla_decode", q_lat, q_rope)
    tensors = (q_lat, q_rope, ckv, k_rope)
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError(f"mla_decode takes bfloat16 q_lat, q_rope, ckv and "
                         f"k_rope, not {[t.dtype for t in tensors]}")
    if positions.dtype != torch.int64:
        raise ValueError(f"mla_decode takes int64 positions, not "
                         f"{positions.dtype}")
    if any(t.stride(-1) != 1 or t.stride(0) % 8 or t.stride(1) % 8
           or t.data_ptr() % 16 for t in tensors):
        raise ValueError("mla_decode expects the last dim of q_lat, q_rope, "
                         "ckv and k_rope contiguous, their other strides "
                         "whole 16-byte units and their data 16-byte "
                         "aligned")
    if T == 0:
        raise ValueError("mla_decode needs a cache of at least one slot")
    index = _build.check_cuda_tensors("mla_decode", *tensors, positions,
                                      contiguous=False)
    out = q_lat.new_empty((B, H, q_lat.shape[-1]))
    if B == 0 or H == 0:
        return out
    lib = _build.load("mla_decode")
    sms = _SMS.get(index)
    if sms is None:
        sms = _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    splits = splits_for(B, H, T, sms)
    ws = (torch.empty(B * H * splits * (q_lat.shape[-1] + 2),
                      dtype=torch.float32, device=q_lat.device)
          if splits > 1 else None)
    _build.launch(lib.mla_decode_launch, index, q_lat.data_ptr(),
                  q_rope.data_ptr(), ckv.data_ptr(), k_rope.data_ptr(),
                  positions.data_ptr(), out.data_ptr(),
                  ws.data_ptr() if ws is not None else None, B, H, T,
                  q_lat.shape[-1], q_rope.shape[-1], splits,
                  *q_lat.stride()[:2], *q_rope.stride()[:2],
                  *ckv.stride()[:2], *k_rope.stride()[:2],
                  positions.stride(0), *out.stride()[:2], scale)
    launches += 1
    return out


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("mla_decode(Tensor q_lat, Tensor q_rope, Tensor ckv, "
            "Tensor k_rope, Tensor positions, float scale) -> Tensor")
_LIB.impl("mla_decode", mla_decode, "CUDA")


@torch.library.register_fake("repro_torch::mla_decode", lib=_LIB)
def _mla_decode_fake(q_lat, q_rope, ckv, k_rope, positions, scale):
    _check_shapes("mla_decode", q_lat, q_rope, ckv, k_rope, positions)
    _check_widths("mla_decode", q_lat, q_rope)
    return q_lat.new_empty(q_lat.shape)


#: the kernel as a torch op: ``mla_decode_op(q_lat, q_rope, ckv, k_rope,
#: positions, scale)``, every argument positional
mla_decode_op = torch.ops.repro_torch.mla_decode.default
