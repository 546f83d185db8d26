"""Serving driver: batched greedy generation over the port's model zoo.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch tinyllama-1.1b --smoke --requests 6 --prompt-len 12 \\
        --new-tokens 8

Same flags as the JAX package's ``repro.launch.serve``, plus ``--device``
(default ``cuda``; without a GPU it prints ``error: ...`` and exits 2, it
never carries on on the CPU).  Weights are random, drawn from ``--seed`` on
the device.  Every arch is served: the decoder-only ones through
``ServeEngine``, whisper-base through ``EncDecEngine`` on ``--requests``
rows of 16 frames drawn from ``--seed`` with NumPy, as the reference
draws them.  jamba-v0.1-52b at full depth (52 B parameters, ~104 GB in
bf16) and deepseek-v2-236b (236 B, ~471 GB) do not fit one 80 GB card;
their smoke configs do.
Besides what ``repro.launch.serve`` prints, it prints one
``group: {json}`` line per batch (per ``transcribe`` for whisper): batch,
prompt length or frames, time to the first tokens on the host and decode
tokens/s.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import lm_init, param_values
from repro_torch.serve import EncDecEngine, Request, ServeConfig, ServeEngine

#: frames a whisper request carries (the reference's ``launch.serve``)
WHISPER_FRAMES = 16


def make_requests(cfg, requests: int, prompt_len: int, new_tokens: int,
                  seed: int) -> List[Request]:
    """``requests`` prompts of ``prompt_len`` tokens of ``cfg``'s vocab,
    drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, prompt_len)
                    .astype(np.int32),
                    max_new_tokens=new_tokens)
            for i in range(requests)]


def make_run(arch: str, smoke: bool, requests: int, prompt_len: int,
             new_tokens: int, max_batch: int, seed: int, device):
    """What :func:`main` serves for these flags: the config, its random
    weights drawn from ``seed`` on ``device``, the seeded requests and the
    serving config (the reference's defaults but for the batch and the
    cache length)."""
    cfg = get_config(arch, smoke=smoke)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    values = param_values(lm_init(cfg, gen, device))
    reqs = make_requests(cfg, requests, prompt_len, new_tokens, seed)
    scfg = ServeConfig(max_batch=max_batch,
                       max_len=prompt_len + new_tokens + 8)
    return cfg, values, reqs, scfg


def make_frames(cfg, requests: int, seed: int,
                frames: int = WHISPER_FRAMES) -> np.ndarray:
    """Whisper's ``[requests, frames, d]`` fp32 frame embeddings: the
    first draw of ``numpy.random.default_rng(seed)``, as the reference's
    ``launch.serve`` draws them."""
    return np.random.default_rng(seed).normal(
        size=(requests, frames, cfg.d_model)).astype(np.float32)


def group_stats(eng) -> List[dict]:
    """The engine's per-group stats with the prefill tokens and the decode
    rate, as the ``group:`` lines print them (each decode step's
    ``step_s`` left out: ``decode_s`` is their sum)."""
    out = []
    for st in eng.stats:
        steps = st["decode_steps"]
        extra = ({"prefill_tokens": st["batch"] * st["prompt_len"]}
                 if "prompt_len" in st else {})
        kept = {k: v for k, v in st.items() if k != "step_s"}
        out.append({**kept, **extra,
                    "decode_tokens_per_s": (st["batch"] * steps
                                            / st["decode_s"]
                                            if steps else None)})
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", choices=ARCHS, default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the model runs (default: cuda; without a "
                         "GPU, pass --device cpu)")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda needs a CUDA GPU and none is available; "
              "pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    cfg, values, reqs, scfg = make_run(
        args.arch, args.smoke, args.requests, args.prompt_len,
        args.new_tokens, args.max_batch, args.seed, args.device)
    if cfg.is_encdec:
        eng = EncDecEngine(cfg, values, scfg)
        del values  # the engine holds its compute-dtype copy
        frames = make_frames(cfg, args.requests, args.seed)
        t0 = time.perf_counter()
        outs = eng.transcribe(frames, max_new_tokens=args.new_tokens)
        dt = time.perf_counter() - t0
        for i, o in enumerate(outs):
            print(f"req {i}: {o}")
    else:
        eng = ServeEngine(cfg, values, scfg)
        del values  # the engine holds its compute-dtype copy
        t0 = time.perf_counter()
        outs = eng.generate(reqs)
        dt = time.perf_counter() - t0
        for rid in sorted(outs):
            print(f"req {rid}: {outs[rid]}")
    for st in group_stats(eng):
        print("group: " + json.dumps(st))
    total = args.requests * args.new_tokens
    print(f"{total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s, "
          f"batch {args.max_batch})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
