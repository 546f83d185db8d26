"""The model step's share of the card's bf16 peak: the model FLOPs of
every forward in the window (the benchmark's own count from the
configuration: 2 a weight a token with routed experts at top-k plus the
shared ones, attention's live causal pairs, Mamba's conv and scan) over
the window's time times 989.4 TFLOP/s, in %."""

from perfbench import counts


def read(run):
    if not run.batches or run.window_s <= 0:
        return None
    flops = 0
    for b in run.batches:
        f = counts.batch_flops(run.config, b["batch"], b["prompt_len"],
                               b["decode_steps"])
        flops += f["prefill"] + f["decode"]
    return flops / (run.window_s * counts.PEAK_BF16_FLOPS) * 100
