"""Roofline terms of a step traced on a fake world (no real hardware), the
JAX package's ``repro.launch.roofline`` for the H100.

Hardware constants: NVIDIA H100 SXM5, one GPU of a DGX H100 node.

* :data:`PEAK_FLOPS`: dense BF16, 989.4 TFLOP/s, from
  :data:`repro_torch.core.h100_adapter.H100_ACC` (2 x 132 SMs x 2048
  FMA/clock x 1.83 GHz; the datasheet's 989 TFLOP/s).
* :data:`HBM_BW`: HBM3, 3.35 TB/s
  (:data:`repro_torch.core.h100_adapter.HBM_BYTES_PER_SEC`, datasheet).
* :data:`LINK_BW`: 50 GB/s a GPU, the node's 400 Gb/s NDR InfiniBand port
  per GPU (DGX H100 datasheet: eight single-port ConnectX-7 400 Gb/s
  adapters for eight GPUs), not NVLink 4 (900 GB/s a GPU within a node).
  The production meshes hold 256 or 512 GPUs, 32 or 64 nodes of eight:
  the 16-wide model axis spans two NVLink domains and the data and pod
  axes span nodes, so every collective on them has hops on the network,
  and a ring collective runs at the rate of its slowest hop.

The analytic part (:func:`layer_flops`, :func:`layer_bytes`,
:func:`scan_correction`, :func:`model_flops_for`) is the reference's,
held equal to it on every config and shape.

No HLO exists here.  :class:`StepCounter` is a ``TorchDispatchMode`` that
counts what one traced step does, per device: the FLOPs of every op that
``torch.utils.flop_counter`` has a formula for (the kernels' ops
included), the bytes every op reads and writes, each kernel op's calls,
and the ``c10d_functional`` collectives the step issues (the collective
bytes).  It counts at one level, per device: an op on ``DTensor``s is
handed on (``NotImplemented``, as ``CommDebugMode`` does), so that the
mode sees what ``DTensor`` runs for it on this rank: the local ops on the
local shards, after any redistribution of the inputs, and the
collectives of that redistribution.  Every op is thus counted at the
shapes this rank computes, a kernel under ``local_map`` included.

An eager step runs every layer, so nothing is counted once for many trips
and the counts need no scan correction; :func:`scan_correction` is
reported beside them and not added in.  Under uneven sharding rank 0's
shard is the largest, and every count is rank 0's.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.h100_adapter import H100_ACC, HBM_BYTES_PER_SEC

PEAK_FLOPS = 2.0 * H100_ACC.macs_per_cycle * H100_ACC.freq_hz  # bf16 / GPU
HBM_BW = HBM_BYTES_PER_SEC           # bytes/s / GPU
LINK_BW = 400e9 / 8                  # bytes/s / GPU: a 400 Gb/s NDR port

# the wire cost of each primitive on a ring, as the reference weights it:
# an all-reduce moves ~2x its payload, the others ~1x
_WIRE_FACTOR = {
    "all-gather": 1.0,
    "all-reduce": 2.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# c10d_functional op name -> the reference's collective kind
_COLLECTIVE_KIND = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}

# ops that move no tensor data (views are skipped by ``is_view``, device
# queries by their ``prim`` namespace)
_NO_TRAFFIC = frozenset({
    "detach", "alias", "lift_fresh", "empty", "empty_like", "empty_strided",
    "new_empty", "new_empty_strided", "wait_tensor", "_local_scalar_dense",
})

# frames that name no call site of the model: the emitter of a collective
# is the innermost repro_torch frame outside these
_PLUMBING = ("/parallel/sharding.py", "/launch/roofline.py",
             "/kernels/ops.py")


def _emitter() -> str:
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename.replace("\\", "/")
        if "/repro_torch/" in name and not name.endswith(_PLUMBING):
            short = name.split("/repro_torch/", 1)[1]
            return f"{short}:{f.f_code.co_name}:{f.f_lineno}"
        f = f.f_back
    return ""


def _tensors_in(x) -> list:
    """The tensors of an op's arguments or outputs: at the top level or
    in a list or tuple there (``cat``'s inputs, ``split``'s outputs)."""
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    out = []
    for a in x if isinstance(x, (list, tuple)) else ():
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def _local(t):
    return t._local_tensor if hasattr(t, "_local_tensor") else t


def _nbytes(t) -> int:
    """Bytes of ``t`` on this rank (a ``DTensor``'s local shard)."""
    t = _local(t)
    return t.numel() * t.element_size()


class StepCounter:
    """Counts one step's work per device while active (``with
    StepCounter() as c: step(...)``): ``flops``, ``bytes``,
    ``kernel_calls`` (each ``repro_torch::`` op), and the collectives
    (``coll_counts`` and wire-weighted ``coll_per_kind`` bytes by kind,
    ``coll_sites`` by kind and emitting call site)."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.kernel_calls: Dict[str, int] = {}
        self.coll_counts: Dict[str, int] = {}
        self.coll_per_kind: Dict[str, int] = {}
        self.coll_sites: Dict[Tuple[str, str], List[int]] = {}
        self._mode = None
        self._shadow = 0      # > 0 inside DTensor's shape propagation
        self._propagate = None
        self._kinds: Dict = {}

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        counter = self
        propagate = ShardingPropagator._propagate_tensor_meta_non_cached

        def shadowed(prop, op_schema):
            counter._shadow += 1
            try:
                return propagate(prop, op_schema)
            finally:
                counter._shadow -= 1

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(t is DTensor for t in types):
                    return NotImplemented  # count DTensor's local ops
                out = func(*args, **(kwargs or {}))
                if not counter._shadow:
                    counter._count(func, args, kwargs or {}, out,
                                   flop_registry)
                return out

        self._propagate = propagate
        ShardingPropagator._propagate_tensor_meta_non_cached = shadowed
        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        self._mode.__exit__(*exc)
        ShardingPropagator._propagate_tensor_meta_non_cached = \
            self._propagate
        self._mode = None

    def _kind(self, func, registry):
        """(what the op is, its name, its FLOP formula or None), worked
        out once an op: "collective", "free" (no data moved: a view, an
        allocation, a device query), "kernel" (a ``repro_torch`` op) or
        "op"."""
        kind = self._kinds.get(func)
        if kind is None:
            ns = func.namespace
            name = func.__name__.split(".")[0]
            if ns in ("_c10d_functional", "_c10d_functional_autograd"):
                what = "collective" if name in _COLLECTIVE_KIND else "free"
            elif ns == "prim" or func.is_view or name in _NO_TRAFFIC:
                what = "free"
            else:
                what = "kernel" if ns == "repro_torch" else "op"
            kind = self._kinds[func] = (
                what, name, registry.get(func._overloadpacket))
        return kind

    def _count(self, func, args, kwargs, out, registry) -> None:
        what, name, flops = self._kind(func, registry)
        if what == "free":
            return
        outs = _tensors_in(out)
        if what == "collective":
            kind = _COLLECTIVE_KIND[name]
            w = int(sum(_nbytes(t) for t in outs) * _WIRE_FACTOR[kind])
            self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
            self.coll_per_kind[kind] = self.coll_per_kind.get(kind, 0) + w
            site = self.coll_sites.setdefault((kind, _emitter()), [0, 0])
            site[0] += 1
            site[1] += w
            return
        if what == "kernel":
            self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1
        if flops is not None:
            self.flops += int(flops(*args, **kwargs, out_val=out))
        self.bytes += sum(_nbytes(t) for t in _tensors_in(args) + outs)

    def coll_bytes(self) -> int:
        return sum(self.coll_per_kind.values())

    def collective_breakdown(self, top: int = 8) -> List[Dict]:
        """The call sites that emit the most collective bytes (wire
        weighted), as the reference's rows: kind, bytes a call, calls
        (``trips``), ``wire_total`` and the emitting ``op``."""
        rows = [{"kind": kind, "bytes": int(w / c / _WIRE_FACTOR[kind]),
                 "trips": c, "wire_total": w, "comp": "eager",
                 "op": site}
                for (kind, site), (c, w) in self.coll_sites.items()]
        rows.sort(key=lambda r: -r["wire_total"])
        return rows[:top]


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    hlo_flops: float               # per device (counted, not from HLO)
    hlo_bytes: float               # per device
    coll_bytes: float              # per device (wire-weighted)
    coll_breakdown: Dict[str, int] = field(default_factory=dict)
    model_flops: float = 0.0       # 6*N*D global
    bytes_per_device: Optional[float] = None   # arguments + traced peak

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction of the bound step time: how close the
        step is to the pure-compute roofline."""
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        if t_bound <= 0:
            return 0.0
        useful = self.model_flops / self.n_devices / PEAK_FLOPS
        return useful / t_bound

    @property
    def flops_utilization(self) -> float:
        """MODEL_FLOPS / counted FLOPs: the fraction of the counted compute
        that is 'useful' (catches remat/redundancy waste)."""
        if self.hlo_flops <= 0:
            return 0.0
        return self.model_flops / (self.hlo_flops * self.n_devices)

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "devices": self.n_devices,
            "hlo_gflops": self.hlo_flops / 1e9,
            "hlo_gbytes": self.hlo_bytes / 1e9,
            "coll_gbytes": self.coll_bytes / 1e9,
            "t_compute_ms": self.t_compute * 1e3,
            "t_memory_ms": self.t_memory * 1e3,
            "t_collective_ms": self.t_collective * 1e3,
            "bottleneck": self.bottleneck,
            "model_gflops_global": self.model_flops / 1e9,
            "flops_util": self.flops_utilization,
            "roofline_frac": self.roofline_fraction,
            "coll_breakdown": self.coll_breakdown,
            "bytes_per_device": self.bytes_per_device,
        }


def analyze(arch: str, shape: str, mesh_name: str, n_devices: int,
            counter: StepCounter, model_flops: float,
            bytes_per_device: Optional[float] = None) -> RooflineReport:
    """The report of a step counted by ``counter``."""
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_devices,
        hlo_flops=float(counter.flops), hlo_bytes=float(counter.bytes),
        coll_bytes=float(counter.coll_bytes()),
        coll_breakdown=dict(counter.coll_per_kind), model_flops=model_flops,
        bytes_per_device=bytes_per_device,
    )


# ---------------------------------------------------------------------------
# scan trip-count correction (the reference's analytic per-layer model)
# ---------------------------------------------------------------------------
# XLA's module-level cost_analysis counts a while-loop (lax.scan) body
# once, so the reference adds (reps - 1) bodies from this model.  The
# port's eager step runs every layer; the correction is reported beside
# its counts for comparison and never added in.

def _attn_token_flops(cfg, kv_len: int, kind: str) -> float:
    h, dh, dv = cfg.n_heads, cfg.head_dim, cfg.v_dim
    d = cfg.d_model
    if kind == "mla":
        r = cfg.rope_head_dim
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        proj = 2 * (d * qr + qr * h * (dh + r) + d * (kvr + r)
                    + kvr * h * (dh + dv) + h * dv * d)
        attn = 2 * h * ((dh + r) + dv) * kv_len
        return proj + attn
    kh = cfg.n_kv_heads
    proj = 2 * (d * h * dh + 2 * d * kh * dh + h * dv * d)
    attn = 2 * h * (dh + dv) * kv_len
    return proj + attn


def _mixer_token_flops(cfg, mixer: str, kv_len: int) -> float:
    d = cfg.d_model
    if mixer in ("attn",):
        return _attn_token_flops(cfg, kv_len, "gqa")
    if mixer == "attn_local":
        return _attn_token_flops(cfg, min(kv_len, cfg.sliding_window), "gqa")
    if mixer == "attn_mla":
        return _attn_token_flops(cfg, kv_len, "mla")
    if mixer == "mamba":
        di = cfg.mamba_expand * d
        n = cfg.mamba_d_state
        dtr = max(1, (d + 15) // 16)
        return 2 * (d * 2 * di + cfg.mamba_d_conv * di
                    + di * (dtr + 2 * n) + dtr * di + 5 * di * n + di * d)
    if mixer == "mlstm":
        di = 2 * d
        dh = di // cfg.n_heads
        chunk = 256
        return 2 * (d * 2 * di + 4 * di + 3 * di * di
                    + 2 * di * chunk + 2 * di * dh + di * d)
    if mixer == "slstm":
        dh = d // cfg.n_heads
        dff = int(d * 8 / 3)
        return 2 * (4 * d * d + 4 * cfg.n_heads * dh * dh + d * dff)
    raise ValueError(mixer)


def _ffn_token_flops(cfg, ffn: str) -> float:
    d = cfg.d_model
    dense = 2 * 3 * d * cfg.d_ff
    if ffn == "none":
        return 0.0
    if ffn == "dense":
        return dense
    routed = (cfg.capacity_factor * cfg.top_k + cfg.n_shared_experts) \
        * 2 * 3 * d * cfg.d_ff_expert + 2 * d * cfg.n_experts
    if ffn == "moe_residual":
        routed += dense
    return routed


def layer_flops(cfg, idx: int, tokens: int, kv_len: int, kind: str) -> float:
    spec = cfg.block_specs()[idx]
    per_tok = _mixer_token_flops(cfg, spec.mixer, kv_len) \
        + _ffn_token_flops(cfg, spec.ffn)
    mult = 3.0 if kind == "train" else 1.0            # fwd+bwd
    if kind == "train" and cfg.remat in ("full", "dots"):
        mult += 1.0                                    # recompute fwd
    return per_tok * tokens * mult


def _layer_param_bytes(cfg, idx: int) -> float:
    dt = 2 if cfg.param_dtype == "bfloat16" else 4
    return cfg._layer_params(idx) * dt


def layer_bytes(cfg, idx: int, tokens_local: int, kind: str) -> float:
    """Rough per-layer HBM bytes (global / n_devices applied by caller for
    params via sharding; here we return GLOBAL bytes assuming params are
    read once per device-group): weights read (+ grad write on train) +
    ~12 activation tensors r/w per token."""
    w = _layer_param_bytes(cfg, idx)
    acts = 12 * tokens_local * cfg.d_model * 2
    mult = 3.0 if kind == "train" else 1.0
    return w * mult + acts * mult


def scan_correction(cfg, kind: str, seq_len: int, global_batch: int,
                    n_devices: int) -> Tuple[float, float]:
    """(extra_flops, extra_bytes) PER DEVICE that the reference adds to
    XLA's counts: (reps - 1) x scan-body cost (XLA counts the body
    once)."""
    pre, p, reps, rem = cfg.layout()
    if reps <= 1:
        return 0.0, 0.0
    if kind == "decode":
        tokens = global_batch
        kv = seq_len
    else:
        tokens = seq_len * global_batch
        kv = seq_len / 2  # causal average
    tokens_local = tokens / max(n_devices, 1)
    f = sum(layer_flops(cfg, pre + pos, tokens, kv, kind)
            for pos in range(p))
    # params are sharded across the model axis (and fsdp): approximate the
    # per-device weight slice as 1/n_devices of global for flops; bytes use
    # tokens_local + per-device weight slice
    extra_flops = (reps - 1) * f / max(n_devices, 1)
    w_local = sum(_layer_param_bytes(cfg, pre + pos)
                  for pos in range(p)) / max(n_devices, 1)
    extra_bytes = (reps - 1) * (w_local * (3.0 if kind == "train" else 1.0)
                                + 12 * tokens_local * cfg.d_model * 2
                                * (3.0 if kind == "train" else 1.0))
    return extra_flops, extra_bytes


def model_flops_for(cfg, shape_kind: str, seq_len: int, global_batch: int,
                    tokens_override: Optional[int] = None) -> float:
    """MODEL_FLOPS = 6*N*D (train: fwd+bwd over D tokens; prefill: 2*N*D;
    decode: 2*N_active*B tokens per step).  MoE: active params."""
    n_active = cfg.active_param_count()
    if tokens_override is not None:
        tokens = tokens_override
    elif shape_kind == "decode":
        tokens = global_batch           # one new token per sequence
    else:
        tokens = seq_len * global_batch
    mult = 6.0 if shape_kind == "train" else 2.0
    return mult * n_active * tokens
