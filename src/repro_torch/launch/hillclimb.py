"""Perf hillclimbing driver: named sharding/execution variants per cell,
re-traced and re-analyzed on the fake world (the JAX package's
``repro.launch.hillclimb``, over :func:`repro_torch.launch.dryrun.lower_cell`);
results land in runs/hillclimb/.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \
        --arch glm4-9b --shape train_4k --variants baseline,sp,fsdp,sp_fsdp

``--device`` as the dry run's: ``cuda`` (the default) needs a GPU and exits
2 without one; ``--device cpu`` traces the CPU route.
"""

import argparse
import json
import os
import sys
import traceback
from typing import Dict

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch.dryrun import (
    default_microbatches,
    fake_world,
    lower_cell,
    mesh_name_of,
    require_device,
    world_size,
)

# Each variant: logical-rule overrides (+ optional microbatches).
VARIANTS: Dict[str, Dict] = {
    # paper-faithful baseline: Megatron TP + batch DP (+ZeRO on experts)
    "baseline": {},
    # Megatron sequence parallelism: activations sharded on `model` along
    # seq between blocks -> the per-layer activation all-reduce becomes
    # all-gather/reduce-scatter pairs (2x wire -> 1x) and activation memory
    # drops 16x
    "sp": {"rules": {"seq": "model"}},
    # ZeRO-dominant: drop tensor parallelism on heads/ff; shard the weights'
    # embed axis across `data` (all-gather params per layer, reduce-scatter
    # grads). Collective payload scales with params instead of activations.
    "fsdp": {"rules": {"heads": None, "kv_heads": None, "ff": None,
                       "embed": "data", "lstm_inner": None,
                       "mamba_inner": None}},
    # both: SP for activations + ZeRO for params
    "sp_fsdp": {"rules": {"seq": "model", "heads": None, "kv_heads": None,
                          "ff": None, "embed": "data", "lstm_inner": None,
                          "mamba_inner": None}},
    # re-enable head sharding for archs with head counts that don't divide
    # the 16-way model axis (GSPMD pads the uneven shard; beats 16x
    # replicated attention compute)
    "uneven_heads": {"rules": {"heads": "model"}},
    "uneven_heads_sp": {"rules": {"heads": "model", "seq": "model"}},
    # deeper grad accumulation (activation temps / step)
    "mb2x": {"microbatches": "2x"},
    # expert-parallel emphasis for MoE: experts on model, ffn dims free
    "ep_sp": {"rules": {"seq": "model", "ff": None, "expert": "model"}},
    # pure data parallelism (tiny models: TP collectives >> grad all-reduce)
    "dp_only": {"rules": {"heads": None, "kv_heads": None, "ff": None,
                          "vocab": None, "expert": None, "fsdp": None,
                          "lstm_inner": None, "mamba_inner": None}},
    # DP + ZeRO on weights (params sharded over data, no TP)
    "dp_zero": {"rules": {"heads": None, "kv_heads": None, "ff": None,
                          "vocab": None, "expert": None,
                          "lstm_inner": None, "mamba_inner": None,
                          "embed": "data"}},
    # remat policy: save matmul outputs (fewer bwd re-gathers, more memory)
    "remat_dots": {"cfg": {"remat": "dots"}},
    "fsdp_dots": {"rules": {"heads": None, "kv_heads": None, "ff": None,
                            "embed": "data", "lstm_inner": None,
                            "mamba_inner": None},
                  "cfg": {"remat": "dots"}},
    "uneven_heads_fsdp": {"rules": {"heads": "model", "kv_heads": None,
                                    "ff": None, "embed": "data"}},
    # real Megatron-SP: only the block-boundary residual stream is
    # seq-sharded; TP internals untouched -> AR becomes RS + AG
    "sp2": {"rules": {"seq_res": "model"}},
    "sp2_fsdp": {"rules": {"seq_res": "model", "heads": None,
                           "kv_heads": None, "ff": None, "embed": "data",
                           "lstm_inner": None, "mamba_inner": None}},
    # shard the head_dim instead of heads (divisible when heads aren't):
    # scores/psum over the sharded contraction
    "head_dim_tp": {"rules": {"heads": None, "kv_heads": None,
                              "head_dim": "model"}},
    "sp2_headdim": {"rules": {"seq_res": "model", "heads": None,
                              "kv_heads": None, "head_dim": "model"}},
}


def run_variant(arch: str, shape: str, variant: str, multi_pod: bool,
                out_dir: str, device: str = "cuda") -> Dict:
    """One variant's row (an ``error`` row if its trace raised), written
    to ``out_dir``; runs inside the fake world of ``multi_pod``'s size."""
    spec = VARIANTS[variant]
    mb = spec.get("microbatches")
    if mb == "2x":
        from repro_torch.configs import get_config
        cfg = get_config(arch)
        mb = 2 * default_microbatches(cfg, SHAPES[shape], multi_pod)
    try:
        row = lower_cell(arch, shape, multi_pod,
                         rules_overrides=spec.get("rules"),
                         microbatches=mb,
                         cfg_overrides=spec.get("cfg"), device=device)
        row["variant"] = variant
    except Exception as e:
        row = {"arch": arch, "shape": shape, "variant": variant,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-3000:]}
        print(f"[{arch}|{shape}|{variant}] FAIL {row['error']}")
    os.makedirs(out_dir, exist_ok=True)
    mesh = mesh_name_of(multi_pod)
    with open(os.path.join(out_dir,
                           f"{arch}__{shape}__{mesh}__{variant}.json"),
              "w") as f:
        json.dump(row, f, indent=1, default=str)
    return row


def summarize(rows) -> None:
    print(f"\n{'variant':16s} {'tC(ms)':>9s} {'tM(ms)':>9s} {'tX(ms)':>10s} "
          f"{'bound':>10s} {'frac':>6s} {'mem(GiB)':>9s}")
    for r in rows:
        if "error" in r:
            print(f"{r['variant']:16s} FAILED: {r['error'][:60]}")
            continue
        mem = (r.get("temp_size_in_bytes", 0)
               + r.get("argument_size_in_bytes", 0)) / 2**30
        print(f"{r['variant']:16s} {r['t_compute_ms']:9.1f} "
              f"{r['t_memory_ms']:9.1f} {r['t_collective_ms']:10.1f} "
              f"{r['bottleneck']:>10s} {r['roofline_frac']:6.3f} {mem:9.1f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--shape", choices=sorted(SHAPES), required=True)
    ap.add_argument("--variants", default="baseline,sp,fsdp,sp_fsdp")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="runs/hillclimb")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="device of the fake tensors (default cuda: needs a "
                         "GPU, pass --device cpu)")
    args = ap.parse_args(argv)
    try:
        require_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    with fake_world(world_size(args.multi_pod)):
        rows = [run_variant(args.arch, args.shape, v, args.multi_pod,
                            args.out, args.device)
                for v in args.variants.split(",")]
    summarize(rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
