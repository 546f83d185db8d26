"""The most memory the window held allocated on the card (weights
included), ``torch.cuda.max_memory_allocated`` over the window, in GiB."""


def read(run):
    if run.peak_window_bytes is None:
        return None
    return run.peak_window_bytes / 2 ** 30
