"""The serve engine's prefill forwards: all their time (``prefill_s``,
host clock, each ending with its first tokens on the host) over their
count, in the window."""


def read(run):
    if not run.batches:
        return None
    return sum(b["prefill_s"] for b in run.batches) / len(run.batches) * 1e3
