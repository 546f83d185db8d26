"""Every token the window's requests were served, over the whole window."""


def read(run):
    tokens = sum(len(t) for b in run.batches for t in b["tokens"])
    return tokens / run.window_s if run.window_s > 0 else None
