"""Batched serving on the PyTorch port: generate from three archs (dense
GQA, xLSTM, enc-dec) through the same engine API, with the memory-capacity
plan for each arch requested from an in-process plan service first (the
Cocco side of serving: plan the block's buffering before running the
model; repeat runs replay the plan from the store in milliseconds).

    PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]

``examples/serve_lm.py`` on the port: the smoke configs of tinyllama-1.1b
and xlstm-350m through ``ServeEngine`` and whisper-base's through
``EncDecEngine``, each with weights drawn on ``--device`` (default
``cuda``; without a GPU, pass ``--device cpu``) from seed 0, and the
requests drawn from one NumPy generator in the reference's order.  Given
the reference's weights, it prints the reference's plans and tokens.
"""

import argparse
import sys
import tempfile

import numpy as np
import torch

from repro_torch.api import ExploreSpec, ResultStore
from repro_torch.api.cli import missing_device
from repro_torch.configs import get_config
from repro_torch.core import HWSpace, Objective
from repro_torch.models import lm_init, param_values
from repro_torch.serve import (
    EncDecEngine,
    PlanService,
    Request,
    ServeConfig,
    ServeEngine,
)


def plan_block(planner: PlanService, arch: str) -> None:
    """Ask the plan service for the arch's layer-0 execution plan."""
    spec = ExploreSpec(workload=f"tpu:{arch}:0?tokens=512",
                       strategy="greedy",
                       objective=Objective(metric="ema", alpha=None),
                       hw=HWSpace(mode="fixed"),
                       sample_budget=500, seed=0)
    resp = planner.plan(spec)
    print(f"  plan: {resp.result.summary()}")
    print(f"  plan: served_from={resp.served_from} "
          f"in {resp.latency_ms:.1f}ms")


def serve_decoder(arch: str, values, planner: PlanService,
                  rng: np.random.Generator) -> dict:
    """Plan ``arch``'s block, then serve 4 prompts of 8 tokens drawn from
    ``rng`` for 6 new tokens each on its smoke config with ``values``."""
    cfg = get_config(arch, smoke=True)
    print(f"{arch}: planning block buffering")
    plan_block(planner, arch)
    eng = ServeEngine(cfg, values, ServeConfig(max_batch=4, max_len=64))
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, 8).astype(np.int32),
                    max_new_tokens=6) for i in range(4)]
    outs = eng.generate(reqs)
    print(f"{arch}:")
    for rid in sorted(outs):
        print(f"  req {rid} -> {outs[rid]}")
    return outs


def transcribe(values, planner: PlanService,
               rng: np.random.Generator) -> list:
    """Plan whisper-base's block, then transcribe 2 rows of 12 frames drawn
    from ``rng`` for 6 tokens each on its smoke config with ``values``."""
    cfg = get_config("whisper-base", smoke=True)
    print("whisper-base: planning block buffering")
    plan_block(planner, "whisper-base")
    eng = EncDecEngine(cfg, values, ServeConfig(max_batch=2, max_len=32))
    frames = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    outs = eng.transcribe(frames, max_new_tokens=6)
    print("whisper-base:")
    for i, o in enumerate(outs):
        print(f"  audio {i} -> {o}")
    return outs


def weights(arch: str, device: str):
    """The smoke config's parameters drawn on ``device`` from seed 0."""
    gen = torch.Generator(device=device).manual_seed(0)
    return param_values(lm_init(get_config(arch, smoke=True), gen, device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the models and the plan searches run "
                         "(default: cuda)")
    args = ap.parse_args(argv)
    if missing_device(args.device):
        return 2
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory(prefix="serve-lm-plans-") as store:
        planner = PlanService(ResultStore(store), device=args.device)
        try:
            for arch in ("tinyllama-1.1b", "xlstm-350m"):
                serve_decoder(arch, weights(arch, args.device), planner, rng)
            transcribe(weights("whisper-base", args.device), planner, rng)
        finally:
            planner.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
