"""The serve engine's decode steps: all their time (``decode_s``, host
clock, each step ending with its tokens on the host) over their count, in
the window."""


def read(run):
    steps = sum(b["decode_steps"] for b in run.batches)
    if not steps:
        return None
    return sum(b["decode_s"] for b in run.batches) / steps * 1e3
