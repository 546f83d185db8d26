"""``output_tokens_per_s`` in the cells whose decode steps the host
paces: every token the window's requests were served, over the whole
window, under a bound of its own (the host's speed moves it more than the
other cells' rates)."""

from perfbench import spec


def read(run):
    return spec.reader("output_tokens_per_s")(run)
