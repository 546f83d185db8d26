"""End-to-end training driver, single device (the JAX package's
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --smoke --steps 5 --ckpt-dir runs/tiny --fail-at 3

The reference's flags plus ``--device`` (default ``cuda``; without a GPU
it prints ``error: ...`` and exits 2, it never carries on on the CPU).
The loop is the reference's: the state built on the device from a seeded
``torch.Generator``, resumed from the latest checkpoint, the
deterministic data stream (batch ``i`` a function of the seed and ``i``),
heartbeats and the restart policy, ``--fail-at`` fault injection that
restores the latest checkpoint and replays from it, periodic and final
saves.  ``--model-parallel`` > 1 exits 2: meshes wait for ROADMAP A8.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import torch

from repro_torch.checkpoint import (CheckpointConfig, CheckpointManager,
                                    tree_to_torch)
from repro_torch.configs import ARCHS, get_config
from repro_torch.data import DataConfig, SyntheticLM, to_device
from repro_torch.models import lm_init, param_values
from repro_torch.runtime import (Decision, FaultConfig, HeartbeatMonitor,
                                 RestartPolicy)
from repro_torch.train import AdamWConfig, adamw_init, make_train_step


def build_state(cfg, opt_cfg, device, seed=0):
    """The parameters drawn from ``seed`` on ``device`` and a fresh AdamW
    state."""
    gen = torch.Generator(device=device).manual_seed(seed)
    values = param_values(lm_init(cfg, gen, device))
    return values, adamw_init(values, opt_cfg)


def _restore(mgr, values, opt, device):
    restored, meta = mgr.restore({"params": values, "opt": opt})
    state = tree_to_torch(restored, device)
    return state["params"], state["opt"], meta["step"]


def run(args) -> dict:
    """The training loop for parsed ``args``; returns ``first_loss``,
    ``last_loss`` and ``steps`` as the reference does, and each step's
    ``(step, loss)`` (replayed steps included), its host seconds, and the
    final ``state`` (params and optimizer)."""
    if args.model_parallel > 1:
        raise NotImplementedError("--model-parallel > 1 needs a device "
                                  "mesh, not ported to repro_torch yet "
                                  "(ROADMAP A8)")
    device = torch.device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                          total_steps=args.steps,
                          state_dtype=cfg.opt_dtype)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed))
    mgr = CheckpointManager(CheckpointConfig(
        directory=args.ckpt_dir, save_every=args.save_every,
        keep_last=2, async_save=True)) if args.ckpt_dir else None

    fault_cfg = FaultConfig()
    monitor = HeartbeatMonitor(fault_cfg, ["host0"])
    policy = RestartPolicy(fault_cfg)

    values, opt = build_state(cfg, opt_cfg, device, args.seed)
    start = 0
    if mgr and mgr.latest_step() is not None:
        values, opt, start = _restore(mgr, values, opt, device)
        print(f"resumed from step {start}")

    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches)
    fail_at = args.fail_at
    losses: List[tuple] = []
    step_s: List[float] = []
    t0 = time.time()
    step = start
    while step < args.steps:
        batch = to_device(data.batch_at(step), device)
        if fail_at and step == fail_at:
            fail_at = 0
            print(f"[fault-injection] simulated step failure at {step}")
            decision = policy.decide(monitor, step_failed=True)
            print(f"[fault-injection] policy -> {decision.value}")
            if decision == Decision.RESTART_SAME and mgr:
                if mgr.latest_step() is not None:
                    values, opt, step = _restore(mgr, values, opt, device)
                    print(f"[fault-injection] restarted from {step}")
                    continue
        t_step = time.time()
        values, opt, metrics = step_fn(values, opt, batch)
        loss = float(metrics["loss"])
        step_s.append(time.time() - t_step)
        losses.append((step, loss))
        for node in monitor.last_seen:
            monitor.heartbeat(node, time.time() - t_step)
        step += 1
        if mgr and mgr.should_save(step):
            mgr.save(step, {"params": values, "opt": opt})
        if step % args.log_every == 0 or step == args.steps:
            dt = time.time() - t0
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"gnorm {float(metrics['grad_norm']):.2f}  "
                  f"({dt / max(step - start, 1):.2f}s/step)")
    if mgr:
        mgr.save(args.steps, {"params": values, "opt": opt}, blocking=True)
    return {"first_loss": losses[0][1] if losses else None,
            "last_loss": losses[-1][1] if losses else None,
            "steps": step - start, "losses": losses, "step_s": step_s,
            "state": {"params": values, "opt": opt}}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", choices=ARCHS, default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=0,
                    help="inject a step failure at this step (tests recovery)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the model trains (default: cuda; without a "
                         "GPU, pass --device cpu)")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda needs a CUDA GPU and none is available; "
              "pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    try:
        out = run(args)
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(f"done: loss {out['first_loss']:.4f} -> {out['last_loss']:.4f} "
          f"over {out['steps']} steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
