"""End-to-end training driver (the JAX package's ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --smoke --steps 5 --ckpt-dir runs/tiny --fail-at 3
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
        -m repro_torch.launch.train --device cpu --smoke --model-parallel 2

The reference's flags plus ``--device`` (default ``cuda``; without a GPU
it prints ``error: ...`` and exits 2, it never carries on on the CPU).
The loop is the reference's: the state built on the device from a seeded
``torch.Generator``, resumed from the latest checkpoint, the
deterministic data stream (batch ``i`` a function of the seed and ``i``),
heartbeats and the restart policy, ``--fail-at`` fault injection that
restores the latest checkpoint and replays from it, periodic and final
saves.

``--model-parallel N`` trains on a (data, model) device mesh, as the
reference always does: the process group comes from the environment
under ``torch.distributed.run`` (``gloo`` for ``--device cpu``, ``nccl``
for ``cuda``, each rank on ``cuda:LOCAL_RANK``), or is a group of one
without it.  Then ``model = min(N, world)``, ``plan_mesh``,
``build_mesh``, ``rules_for(cfg, "train")``, and the parameters and
AdamW state are ``DTensor``s placed by the parameters' logical axes; a
world of one gives a (1, 1) mesh, the same ``DTensor`` route.  Without
``--model-parallel`` (and a world of one) the model trains on one device
with plain tensors.  Only rank 0 prints and writes checkpoints.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from contextlib import nullcontext
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import (CheckpointConfig, CheckpointManager,
                                    reshard_to)
from repro_torch.configs import ARCHS, get_config
from repro_torch.data import DataConfig, SyntheticLM, to_device
from repro_torch.launch.mesh import rules_for
from repro_torch.models import lm_init, param_values
from repro_torch.models.layers import tree_map
from repro_torch.parallel.sharding import (is_dtensor, logical_sharding,
                                           mesh_context)
from repro_torch.runtime import (Decision, FaultConfig, HeartbeatMonitor,
                                 RestartPolicy, build_mesh, plan_mesh)
from repro_torch.train import AdamWConfig, adamw_init, make_train_step


def build_state(cfg, opt_cfg, device, seed=0, mesh=None):
    """The parameters drawn from ``seed`` on ``device`` and a fresh AdamW
    state; under ``mesh``, ``DTensor``s placed by the parameters' logical
    axes (under the current rules)."""
    from torch.distributed.tensor import distribute_tensor

    gen = torch.Generator(device=device).manual_seed(seed)
    params = lm_init(cfg, gen, device)
    if mesh is None:
        values = param_values(params)
    else:
        values = tree_map(lambda p: distribute_tensor(
            p.value, mesh, logical_sharding(p.axes, mesh)), params)
    return values, adamw_init(values, opt_cfg)


def _placements(values, opt):
    """The ``reshard_to`` shardings of a live state: each ``DTensor``
    leaf's (mesh, placements), None for a plain tensor."""
    def of(t):
        return (t.device_mesh, t.placements) if is_dtensor(t) else None

    return {"params": tree_map(of, values),
            "opt": type(opt)(of(opt.step), tree_map(of, opt.mu),
                             tree_map(of, opt.nu))}


def _restore(mgr, values, opt, device):
    restored, meta = mgr.restore({"params": values, "opt": opt})
    state = reshard_to(restored, _placements(values, opt), device)
    return state["params"], state["opt"], meta["step"]


def _process_group(device: str) -> bool:
    """Join (or make) the process group of a mesh run; True when this
    call made it.  Under ``torch.distributed.run`` it comes from the
    environment, else it is a group of one."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device == "cuda" else "gloo"
    if "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
        if device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return True


def run(args) -> dict:
    """The training loop for parsed ``args``; returns ``first_loss``,
    ``last_loss`` and ``steps`` as the reference does, and each step's
    ``(step, loss)`` (replayed steps included), its host seconds, the
    final ``state`` (params and optimizer) and this process's ``rank``."""
    meshed = (args.model_parallel is not None
              or int(os.environ.get("WORLD_SIZE", "1")) > 1)
    own_group = meshed and _process_group(args.device)
    try:
        return _run(args, meshed)
    finally:
        if own_group:
            dist.destroy_process_group()


def _run(args, meshed: bool) -> dict:
    device = torch.device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    mesh, rank = None, 0
    if meshed:
        world, rank = dist.get_world_size(), dist.get_rank()
        model_par = min(args.model_parallel or 1, world)
        plan = plan_mesh(world - (world % model_par), model_par)
        if args.device == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        mesh = build_mesh(plan, args.device)
    log = print if rank == 0 else (lambda *a, **k: None)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                          total_steps=args.steps,
                          state_dtype=cfg.opt_dtype)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed))
    mgr = CheckpointManager(CheckpointConfig(
        directory=args.ckpt_dir, save_every=args.save_every,
        keep_last=2, async_save=True)) if args.ckpt_dir else None

    scope = (mesh_context(mesh, rules_for(cfg, "train")) if mesh is not None
             else nullcontext())
    with scope:
        out = _loop(args, cfg, opt_cfg, data, mgr, device, mesh, log)
    out["rank"] = rank
    return out


def _loop(args, cfg, opt_cfg, data, mgr, device, mesh, log) -> dict:
    fault_cfg = FaultConfig()
    monitor = HeartbeatMonitor(fault_cfg, ["host0"])
    policy = RestartPolicy(fault_cfg)

    values, opt = build_state(cfg, opt_cfg, device, args.seed, mesh)
    start = 0
    if mgr and mgr.latest_step() is not None:
        values, opt, start = _restore(mgr, values, opt, device)
        log(f"resumed from step {start}")

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
            log(f"[fault-injection] simulated step failure at {step}")
            decision = policy.decide(monitor, step_failed=True)
            log(f"[fault-injection] policy -> {decision.value}")
            if decision == Decision.RESTART_SAME and mgr:
                if mgr.latest_step() is not None:
                    values, opt, step = _restore(mgr, values, opt, device)
                    log(f"[fault-injection] restarted from {step}")
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
            log(f"step {step:5d}  loss {loss:.4f}  "
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
    ap.add_argument("--model-parallel", type=int, default=None,
                    help="train on a (data, model) mesh with this model "
                         "axis (default: one device, no mesh)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=0,
                    help="inject a step failure at this step (tests recovery)")
    ap.add_argument("--losses-out", default=None, metavar="FILE",
                    help="write each step's [step, loss] as JSON to FILE "
                         "(rank 0)")
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
    if args.model_parallel is not None and args.model_parallel < 1:
        print("error: --model-parallel must be >= 1", file=sys.stderr)
        return 2
    out = run(args)
    if out["rank"] != 0:
        return 0
    if args.losses_out:
        with open(args.losses_out, "w") as f:
            json.dump(out["losses"], f)
    print(f"done: loss {out['first_loss']:.4f} -> {out['last_loss']:.4f} "
          f"over {out['steps']} steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
