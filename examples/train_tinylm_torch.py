"""End-to-end training on the PyTorch port: train a ~100M-param
TinyLlama-family model for a few hundred steps on synthetic data, with a
checkpoint every 50 steps and a simulated failure + automatic restart at
step 60.

    PYTHONPATH=src python examples/train_tinylm_torch.py [--steps 300] \\
        [--tiny] [--device cpu]

``examples/train_tinylm.py`` through ``repro_torch.launch.train.run``, on
``--device`` (default ``cuda``; without a GPU, pass ``--device cpu``):
8 layers, d 768, 12 heads over 4 KV heads, d_ff 2,048, vocab 32,000, fp32,
no remat; batch 4 x 256 tokens in 2 microbatches, lr 3e-3 after 30 warmup
steps; checkpoints in ``runs/tinylm_example``.  ``--tiny`` trains the
smoke config at 8 x 64 instead, the quick pass.  It differs from the
reference example in four ways:

* it honours ``--steps`` and ``--tiny``: the reference resets
  ``sys.argv`` when it is imported, before its ``main`` parses the flags,
  so it always trains the ~100M config for 300 steps;
* ``model_parallel`` is None, the port's plain one-device run: the
  reference's one-device mesh computes the same, while the port's ``1``
  builds a (1, 1) ``DTensor`` mesh, which only adds host dispatch;
* it leaves no module state changed: the ~100M config is what
  ``get_config("tinyllama-1.1b", smoke=True)`` returns only while the run
  runs;
* a second run in the same checkpoint directory resumes at its last step
  and has nothing left to train: it says so and exits 0, where the
  reference fails formatting a loss of None.
"""

import argparse
import contextlib
import sys

from repro_torch.api.cli import missing_device
from repro_torch.configs import tinyllama_1_1b
from repro_torch.launch import train

# ~100M-param variant of the tinyllama family
SMALL = tinyllama_1_1b.CONFIG.with_(
    n_layers=8, d_model=768, n_heads=12, n_kv_heads=4, d_head=64,
    d_ff=2048, vocab=32_000, remat="none", compute_dtype="float32")


@contextlib.contextmanager
def smoke_config(cfg):
    """Inside the block, ``get_config("tinyllama-1.1b", smoke=True)`` is
    ``cfg``; after it, what it was."""
    before = tinyllama_1_1b.SMOKE
    tinyllama_1_1b.SMOKE = cfg
    try:
        yield
    finally:
        tinyllama_1_1b.SMOKE = before


def run_args(steps: int, tiny: bool, device: str) -> argparse.Namespace:
    """The reference example's arguments to ``launch.train.run``."""
    return argparse.Namespace(
        arch="tinyllama-1.1b", smoke=True, steps=steps,
        batch=8 if tiny else 4, seq=64 if tiny else 256, lr=3e-3, warmup=30,
        seed=0, microbatches=2, model_parallel=None,
        ckpt_dir="runs/tinylm_example", save_every=50, log_every=10,
        fail_at=60, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true",
                    help="use the reduced config (fast CPU pass)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the model trains (default: cuda)")
    ns = ap.parse_args(argv)
    if missing_device(ns.device):
        return 2
    args = run_args(ns.steps, ns.tiny, ns.device)
    if ns.tiny:
        out = train.run(args)
    else:
        print(f"training ~{SMALL.param_count()/1e6:.0f}M params "
              f"({SMALL.n_layers}L d={SMALL.d_model})")
        with smoke_config(SMALL):
            out = train.run(args)
    if out["first_loss"] is None:
        print(f"nothing left to train: the checkpoint in {args.ckpt_dir} "
              f"is at step {args.steps} or later")
        return 0
    print(f"loss {out['first_loss']:.3f} -> {out['last_loss']:.3f}")
    if not out["last_loss"] < out["first_loss"]:
        raise AssertionError("training did not learn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
