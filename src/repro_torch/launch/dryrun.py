"""Multi-pod dry run: every (arch x input shape x mesh) cell traced on a
fake world (the JAX package's ``repro.launch.dryrun``).

For each cell: a fake world of 256 ranks, mesh (16, 16), or 512 ranks,
mesh (2, 16, 16) (torch's ``fake`` process-group backend: collectives are
issued and compute nothing), the parameters, optimizer state, batch and
caches made as fake tensors (``FakeTensorMode``: shapes, dtypes and
devices, no storage) and placed as ``DTensor``s by the logical-axis rules,
and one real step traced on them: the train step (forward, backward and
AdamW), a prefill step or a one-token serve step.  The trace counts the
step's work per device (:class:`repro_torch.launch.roofline.StepCounter`:
FLOPs, bytes, each kernel op's calls, the collectives) and its peak
memory (``MemTracker``), and the cell's row carries the reference's keys:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out runs/dryrun

``--device cuda`` (the default) traces fake ``cuda`` tensors on a ``cuda``
mesh, so the kernels' torch ops (B2-B4) stand in the trace where the card
would launch them; it needs a CUDA GPU (a ``cuda`` mesh places tensors
through the CUDA runtime) and exits 2 without one.  ``--device cpu``
traces the CPU route: the kernels' plain versions.  No cell compiles
anything: ``compile_s`` is 0.0 and ``lower_s`` is the trace's seconds.
Every layer is traced.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from contextlib import contextmanager
from typing import Any, Dict, Optional

from repro_torch.configs import ARCHS, SHAPES, get_config, skip_reason
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_production_mesh, rules_for
from repro_torch.models.config import ModelConfig

ENC_FRAMES = 1_500  # whisper encoder is architecturally capped at 1500 frames


def world_size(multi_pod: bool) -> int:
    return 512 if multi_pod else 256


def mesh_name_of(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


@contextmanager
def fake_world(n: int):
    """A process group of ``n`` ranks on torch's ``fake`` backend, this
    process rank 0, for the duration of the block."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _require_world(n: int) -> None:
    import torch.distributed as dist

    have = (f"a group of {dist.get_world_size()}" if dist.is_initialized()
            else "no process group")
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(
            f"lower_cell traces on a fake world of {n} ranks and this "
            f"process has {have}: run it inside fake_world({n}), as the "
            f"CLI does")


# ---------------------------------------------------------------------------
# the cell's inputs, as fake tensors
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, shape: ShapeSpec, device):
    """The train / prefill batch of a cell: the global batch as plain
    tensors, as the port's steps take it (every rank holds it whole);
    token 0 everywhere, every position in the loss."""
    import torch

    B, S = shape.global_batch, shape.seq_len
    batch: Dict[str, Any] = {}
    text = S
    if cfg.is_encdec:
        batch["frames"] = torch.zeros((B, ENC_FRAMES, cfg.d_model),
                                      device=device)
    elif cfg.frontend == "vision_patches":
        nf = cfg.n_frontend_tokens
        batch["extra_embeds"] = torch.zeros((B, nf, cfg.d_model),
                                            device=device)
        text = max(S - nf, 1)
    batch["tokens"] = torch.zeros((B, text), dtype=torch.int32,
                                  device=device)
    if shape.kind == "train":
        batch["loss_mask"] = torch.ones((B, text), device=device)
    return batch


def _placed(tree, axes_tree, mesh):
    """Each tensor of ``tree`` distributed by its logical axes (a dim its
    mesh axis does not divide replicated, as ``shard`` places it); the
    tree as it is without a mesh."""
    if mesh is None:
        return tree
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.parallel.sharding import even_placements, \
        logical_sharding

    if isinstance(tree, dict):
        return {k: _placed(v, axes_tree[k], mesh) for k, v in tree.items()}
    return distribute_tensor(tree, mesh, even_placements(
        logical_sharding(axes_tree, mesh), tree.shape, mesh))


def make_prefill_step(cfg: ModelConfig, max_len: int, mesh, device):
    """The prefill step: caches made empty (bf16) and placed by
    :func:`repro_torch.models.cache_axes`, then one forward over the
    prompt (``prefill=True``: attention through the kernel)."""
    import torch

    from repro_torch.models import cache_axes, encdec_apply, init_caches, \
        lm_apply

    def prefill_step(params, batch):
        B = batch["tokens"].shape[0]
        caches = _placed(init_caches(cfg, B, max_len, torch.bfloat16,
                                     device), cache_axes(cfg), mesh)
        if cfg.is_encdec:
            logits, caches, enc_out, _ = encdec_apply(
                params, cfg, batch["frames"], batch["tokens"], caches=caches)
            return logits[:, -1, :], caches, enc_out
        logits, caches, _ = lm_apply(
            params, cfg, batch["tokens"],
            extra_embeds=batch.get("extra_embeds"), caches=caches,
            prefill=True)
        return logits[:, -1, :], caches

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One token per sequence against the caches (the reference's
    ``make_serve_step``); whisper's takes the encoder's output."""
    from repro_torch.models import encdec_apply, lm_apply

    if cfg.is_encdec:
        def serve_step(params, caches, tokens, positions, enc_out):
            logits, caches, _, _ = encdec_apply(
                params, cfg, None, tokens, positions=positions,
                caches=caches, enc_out=enc_out)
            return logits[:, -1, :], caches
        return serve_step

    def serve_step(params, caches, tokens, positions):
        logits, caches, _ = lm_apply(params, cfg, tokens,
                                     positions=positions, caches=caches)
        return logits[:, -1, :], caches

    return serve_step


def default_microbatches(cfg: ModelConfig, shape: ShapeSpec,
                         multi_pod: bool) -> int:
    """Baseline grad-accumulation: keep per-device microbatch ~8 sequences
    (4 for the 4k shapes of >30B models)."""
    if shape.kind != "train":
        return 1
    data_ways = 32 if multi_pod else 16
    per_dev = max(1, shape.global_batch // data_ways)
    target = 4 if cfg.param_count() > 30e9 else 8
    return max(1, per_dev // target)


def cell_step(cfg: ModelConfig, shape: ShapeSpec, mesh, device,
              microbatches: int = 1, generator=None, cache_dtype=None):
    """(step, its arguments) of a cell on ``mesh`` (or none) under the
    current rules (``mesh_context``): the parameters drawn from ``generator``
    (default: a fresh CPU generator) and placed by their logical axes,
    then for ``train`` AdamW's state and the batch, for ``prefill`` the
    batch, for ``decode`` the caches (``cache_dtype``, default bf16 as the
    reference's) placed by ``cache_axes``, the tokens and positions (and
    whisper's encoder output).  Under ``FakeTensorMode`` every tensor is
    fake."""
    import torch

    from repro_torch.models import cache_axes, init_caches, lm_init
    from repro_torch.models.layers import param_axes, param_values
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step

    params = lm_init(cfg, generator or torch.Generator(), device)
    values = _placed(param_values(params), param_axes(params), mesh)
    del params
    if shape.kind == "train":
        opt_cfg = AdamWConfig(state_dtype=cfg.opt_dtype)
        return (make_train_step(cfg, opt_cfg, microbatches=microbatches),
                (values, adamw_init(values, opt_cfg),
                 batch_specs(cfg, shape, device)))
    if shape.kind == "prefill":
        return (torch.no_grad()(make_prefill_step(cfg, shape.seq_len, mesh,
                                                  device)),
                (values, batch_specs(cfg, shape, device)))
    B, S = shape.global_batch, shape.seq_len
    caches = _placed(init_caches(cfg, B, S, cache_dtype or torch.bfloat16,
                                 device), cache_axes(cfg), mesh)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=device)
    pos = torch.zeros((B, 1), dtype=torch.int32, device=device)
    args = (values, caches, tok, pos)
    if cfg.is_encdec:
        args += (torch.zeros((B, ENC_FRAMES, cfg.d_model),
                             dtype=torch.bfloat16, device=device),)
    return torch.no_grad()(make_serve_step(cfg)), args


def _tensors(tree):
    import torch
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def argument_bytes(args) -> int:
    """Bytes this rank holds of ``args``: each ``DTensor``'s local shard,
    each plain tensor whole."""
    return sum(roofline._nbytes(t) for t in _tensors(args))


def trace_step(step, args):
    """Run ``step(*args)`` once under a :class:`roofline.StepCounter` and
    ``MemTracker``; returns the counter and the peak bytes of this rank
    (the arguments' local shards included)."""
    import torch
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.experimental import implicit_replication

    counter = roofline.StepCounter()
    mem = MemTracker()
    mem.track_external(*(roofline._local(t) for t in _tensors(args)))
    # the backward on this thread, not a CUDA device's: the fake mode,
    # the counting modes and implicit replication are this thread's state
    with mem, counter, implicit_replication(), \
            torch.autograd.set_multithreading_enabled(False):
        step(*args)
    peak = max(v.get("Total", 0) for v in
               mem.get_tracker_snapshot("peak").values())
    return counter, int(peak)


# ---------------------------------------------------------------------------
# tracing per cell
# ---------------------------------------------------------------------------

def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               rules_overrides: Optional[Dict] = None,
               microbatches: Optional[int] = None,
               cfg_overrides: Optional[Dict] = None,
               verbose: bool = True, device: str = "cuda") -> Dict:
    """Trace one cell's step on the current fake world (256 ranks, or 512
    with ``multi_pod``; see :func:`fake_world`) with ``device`` tensors;
    returns its row.  Counts are rank 0's, whose shard is the largest
    under uneven sharding."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.parallel.sharding import mesh_context

    cfg = get_config(arch)
    if cfg_overrides:
        cfg = cfg.with_(**cfg_overrides)
    shape = SHAPES[shape_name]
    if microbatches is None:
        microbatches = default_microbatches(cfg, shape, multi_pod)
    n_dev = world_size(multi_pod)
    _require_world(n_dev)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
    mesh_name = mesh_name_of(multi_pod)
    kind = shape.kind
    rkind = "decode_long" if (kind == "decode"
                              and shape.global_batch == 1) else kind
    rules = rules_for(cfg, rkind, rules_overrides)
    t0 = time.time()
    with FakeTensorMode(), mesh_context(mesh, rules):
        step, args = cell_step(cfg, shape, mesh, device, microbatches)
        arg_bytes = argument_bytes(args)
        counter, peak = trace_step(step, args)
    t_lower = time.time() - t0

    if verbose:
        print(f"[{arch} | {shape_name} | {mesh_name}] trace {t_lower:.1f}s; "
              f"{counter.flops / 1e9:.1f} GFLOP, {counter.bytes / 1e9:.1f} "
              f"GB, collectives {counter.coll_counts}, kernels "
              f"{counter.kernel_calls}, peak {peak / 2**30:.2f} GiB",
              flush=True)

    mf = roofline.model_flops_for(cfg, kind, shape.seq_len,
                                  shape.global_batch)
    xf, xb = roofline.scan_correction(cfg, kind, shape.seq_len,
                                      shape.global_batch, n_dev)
    pre, p, reps, rem = cfg.layout()
    rep = roofline.analyze(arch, shape_name, mesh_name, n_dev, counter, mf,
                           bytes_per_device=float(peak))
    row = rep.row()
    row.update({
        "lower_s": t_lower,
        "compile_s": 0.0,
        "kind": kind,
        "rules": {k: str(v) for k, v in rules.items()},
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "microbatches": microbatches,
        "scan_correction_flops": xf,
        "scan_correction_bytes": xb,
        "coll_multiplier": "eager",
        "layout": [pre, p, reps, rem],
        "counted_at": "per_device",
        "device": device,
        "kernel_calls": dict(counter.kernel_calls),
        "coll_counts": dict(counter.coll_counts),
        "coll_top": counter.collective_breakdown(),
        "argument_size_in_bytes": arg_bytes,
        "temp_size_in_bytes": max(peak - arg_bytes, 0),
        "peak_bytes": peak,
    })
    return row


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def require_device(device: str) -> None:
    """Raise ``RuntimeError`` (``error: ...``, exit 2) when ``device`` is
    ``cuda`` and there is no GPU: the dry run never carries on on the
    CPU unless asked."""
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                "--device cuda needs a CUDA GPU and none is available; "
                "pass --device cpu to trace on the CPU")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape x mesh) cell")
    ap.add_argument("--out", default=None, help="directory for JSON reports")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="grad-accumulation steps (default: per-cell "
                         "heuristic)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="device of the fake tensors (default cuda: needs a "
                         "GPU, pass --device cpu)")
    args = ap.parse_args(argv)
    try:
        require_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    cells = []
    if args.all:
        for arch in ARCHS:
            for shape in SHAPES:
                for mp in (False, True):
                    cells.append((arch, shape, mp))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        meshes = {"single": [False], "multi": [True],
                  "both": [False, True]}[args.mesh]
        cells = [(args.arch, args.shape, mp) for mp in meshes]

    if args.out:
        os.makedirs(args.out, exist_ok=True)

    n_ok = n_skip = n_fail = 0
    for mp in sorted({mp for _, _, mp in cells}):
        with fake_world(world_size(mp)):
            for arch, shape, cell_mp in cells:
                if cell_mp != mp:
                    continue
                tag = f"{arch}__{shape}__{mesh_name_of(mp)}"
                dest = os.path.join(args.out, f"{tag}.json") \
                    if args.out else None
                if dest and args.skip_existing and os.path.exists(dest):
                    n_ok += 1
                    continue
                reason = skip_reason(arch, shape)
                if reason:
                    n_skip += 1
                    row = {"arch": arch, "shape": shape,
                           "mesh": mesh_name_of(mp), "skipped": reason}
                    print(f"[{tag}] SKIP: {reason}")
                else:
                    try:
                        row = lower_cell(arch, shape, mp,
                                         microbatches=args.microbatches,
                                         device=args.device)
                        n_ok += 1
                    except Exception as e:  # report, keep going
                        n_fail += 1
                        row = {"arch": arch, "shape": shape,
                               "mesh": mesh_name_of(mp),
                               "error": f"{type(e).__name__}: {e}",
                               "traceback": traceback.format_exc()[-4000:]}
                        print(f"[{tag}] FAIL: {type(e).__name__}: {e}")
                if dest:
                    with open(dest, "w") as f:
                        json.dump(row, f, indent=1, default=str)
    print(f"dryrun: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
